"""Thin interactive viewer: a localhost HTTP app over the port's Engine.

Port of ``cellularautomatons3d_tpu.viewer.server``.  The reference is a
browser app (index.html + ui.js + a canvas); this viewer gives the same
interaction surface over the Engine on the card: a live frame stream, the
declarative control panel (every field of the reference UI,
main_pathtraced.js:259-448, with the applyOnRestart split and the pulsing
restart marker), WASD/R/F + arrow/Q/E keys, drag-look and wheel speed --
served by the Python standard library only.  Each frame is one
:meth:`Engine.tick` (render with the moved camera's reprojection, then the
CA step on the reference's cadence) and a PNG of it.

Run:  python -m cellularautomatons3d_tpu_torch.viewer [--port 8000] [--grid 64]
[--device cuda|cpu]
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

from ..engine import Engine
from ..models.neighbourhoods import NEIGHBOURHOOD_MAP
from ..utils import image as image_utils
from ..utils.config import EngineConfig

__all__ = ["FIELDS", "ViewerServer", "serve"]

_HTML_PATH = Path(__file__).parent / "static" / "index.html"
_LOCAL_HOSTS = ("127.0.0.1", "localhost", "[::1]")

# The reference UI field spec (main_pathtraced.js:259-448) mapped onto
# EngineConfig fields: (name, label, kind, extra).
FIELDS = [
    ("grid_size", "grid size", "int", {"min": 32, "max": 1024, "restart": True}),
    ("cell_size", "cell size", "float", {"min": 0.01, "max": 0.9}),
    ("depth_samples", "depth samples", "int", {"min": 1, "max": 500}),
    ("shadow_samples", "shadow samples", "int", {"min": 1, "max": 256}),
    ("roughness", "material roughness", "float", {"min": 0.0, "max": 1.0}),
    ("base_reflectivity", "base reflectivity", "color", {}),
    ("material_color", "material color", "color", {}),
    ("temporal_alpha", "temporal reprojection alpha", "float", {"min": 0.0, "max": 1.0}),
    ("light.magnitude", "light magnitude", "float", {"min": 0.0, "max": 100.0}),
    ("compute_step_duration_ms", "sim step duration (ms)", "int", {"min": 16, "max": 3000}),
    ("light.animate", "animate light", "bool", {}),
    ("show_depth_overlay", "show depth overlay", "bool", {}),
    ("random_initial_state", "random initial state", "bool", {"restart": True}),
    ("neighbourhood", "neighbourhood", "select",
     {"options": list(NEIGHBOURHOOD_MAP), "restart": True}),
    ("born", "born rules", "text", {"restart": True}),
    ("survive", "survive rules", "text", {"restart": True}),
    ("born_edges", "born rules edges", "text", {"restart": True}),
    ("survive_edges", "survive rules edges", "text", {"restart": True}),
    ("born_corners", "born rules corners", "text", {"restart": True}),
    ("survive_corners", "survive rules corners", "text", {"restart": True}),
    ("total_states", "total states", "int", {"min": 2, "max": 16, "restart": True}),
    # Parallelism: 0 = single device, N = 1-D mesh (BASELINE config 5).
    ("mesh_devices", "mesh devices", "int", {"min": 0, "max": 64, "restart": True}),
    ("gamma", "1 / gamma", "float", {"min": 1.0, "max": 5.0}),
    ("pipeline", "pipeline", "select", {"options": ["fast", "reference"]}),
    ("render_variant", "render variant", "select",
     {"options": ["clustered", "simple"]}),
    # Lighting extensions.
    ("light.position", "light position", "vec3", {}),
    ("indirect_lighting", "indirect lighting (GI)", "bool", {}),
    ("indirect_bounces", "indirect bounces", "int", {"min": 1, "max": 3}),
    ("soft_shadow_samples", "soft shadow samples", "int", {"min": 1, "max": 64}),
    ("light_radius", "light radius (soft shadows)", "float", {"min": 0.0, "max": 1.0}),
    ("emissive_color", "emissive color", "color", {}),
    ("emissive_strength", "emissive strength", "float", {"min": 0.0, "max": 50.0}),
]


def _get_field(cfg: EngineConfig, name: str):
    obj = cfg
    for part in name.split("."):
        obj = getattr(obj, part)
    if isinstance(obj, tuple):
        return list(obj)
    return obj


class ViewerServer:
    """The viewer's state: one Engine, a lock around it, and the handlers'
    logic.  ``engine``: an Engine to serve; else one is built from
    ``config_overrides`` (640×480 unless given) on ``device``, the card by
    default."""

    def __init__(self, engine: Engine | None = None, device="cuda", **config_overrides):
        if engine is None:
            config_overrides.setdefault("width", 640)
            config_overrides.setdefault("height", 480)
            engine = Engine(EngineConfig(**config_overrides), device=device)
        self.engine = engine
        self._lock = threading.Lock()

    # ------------------------------------------------------------------ #
    def field_spec(self):
        cfg = self.engine.config
        return [
            {"name": name, "label": label, "kind": kind,
             "value": _get_field(cfg, name), **extra}
            for name, label, kind, extra in FIELDS
        ]

    def frame_png(self) -> bytes:
        """One frame-loop iteration of the Engine as PNG bytes."""
        with self._lock:
            frame = self.engine.tick()
        return image_utils.encode_png(frame, level=1)

    def handle_input(self, msg: dict):
        """Apply one input message (param, restart, keys, mouse, wheel).  A
        setting the Engine refuses (a ``mesh_devices`` on restart that its
        devices cannot hold, or that does not divide the grid or the window)
        answers ``{"ok": false, "error": ...}`` and leaves the Engine as it
        was."""
        eng = self.engine
        with self._lock:
            kind = msg.get("type")
            try:
                if kind == "param":
                    eng.set(msg["name"], msg["value"])
                elif kind == "restart":
                    eng.restart()
            except ValueError as e:
                return {"ok": False, "error": str(e),
                        "restart_required": eng.restart_required,
                        "simulation_step": eng.simulation_step}
            if kind == "keys":
                dt = float(msg.get("dt", 0.016))
                t = msg.get("translate") or [0, 0, 0]
                r = msg.get("rotate") or [0, 0, 0]
                if any(t):
                    eng.camera.translate(t, dt)
                if any(r):
                    eng.camera.rotate(r, dt)
            elif kind == "mouse":
                eng.camera.mouse_look(float(msg.get("dx", 0)), float(msg.get("dy", 0)))
            elif kind == "wheel":
                eng.camera.wheel(float(msg.get("deltaY", 0)))
            return {
                "ok": True,
                "restart_required": eng.restart_required,
                "simulation_step": eng.simulation_step,
            }

    # ------------------------------------------------------------------ #
    def make_server(self, port: int = 8000, host: str = "127.0.0.1") -> ThreadingHTTPServer:
        """The HTTP server over this viewer, bound but not yet serving
        (``port=0`` takes a free port: ``server.server_address``)."""
        viewer = self
        html = _HTML_PATH.read_bytes()

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code, body, ctype):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/" or self.path.startswith("/index"):
                    self._send(200, html, "text/html")
                elif self.path.startswith("/frame"):
                    self._send(200, viewer.frame_png(), "image/png")
                elif self.path.startswith("/fields"):
                    self._send(200, json.dumps(viewer.field_spec()).encode(),
                               "application/json")
                elif self.path.rstrip("/") == "/ws":
                    if not self._local_request():
                        self._send(403, b"forbidden", "text/plain")
                        return
                    self._serve_websocket()
                else:
                    self._send(404, b"not found", "text/plain")

            def _serve_websocket(self):
                """Push PNG frames (binary) + status (text) over one socket;
                client inputs arrive as JSON text messages routed through
                handle_input."""
                from . import ws

                if not ws.handshake(self):
                    self._send(400, b"bad websocket request", "text/plain")
                    return
                self.close_connection = True
                stop = threading.Event()
                # The reader thread writes PONG frames to the same wfile the
                # push loop writes PNG/status frames to; a shared lock keeps
                # the WebSocket framing from interleaving.
                wlock = threading.Lock()

                def reader():
                    try:
                        while not stop.is_set():
                            op, payload = ws.recv_message(self.rfile)
                            if op is None or op == ws.OP_CLOSE:
                                break
                            if op == ws.OP_PING:
                                with wlock:
                                    ws.send_frame(self.wfile, payload, ws.OP_PONG)
                            elif op == ws.OP_TEXT:
                                try:
                                    viewer.handle_input(json.loads(payload))
                                except ValueError:
                                    pass
                    except OSError:
                        pass
                    finally:
                        stop.set()

                t = threading.Thread(target=reader, daemon=True)
                t.start()
                try:
                    while not stop.is_set():
                        png = viewer.frame_png()
                        status = {
                            "restart_required": viewer.engine.restart_required,
                            "simulation_step": viewer.engine.simulation_step,
                        }
                        with wlock:
                            ws.send_frame(self.wfile, png)
                            ws.send_text(self.wfile, status)
                except OSError:
                    pass
                finally:
                    stop.set()

            def _local_request(self) -> bool:
                """Reject cross-origin / DNS-rebinding requests: Host must be
                local, and Origin (when a browser sends one) must match."""
                host = (self.headers.get("Host") or "").split(":")[0]
                if host not in (*_LOCAL_HOSTS, ""):
                    return False
                origin = self.headers.get("Origin")
                if origin:
                    ohost = origin.split("//")[-1].split(":")[0].split("/")[0]
                    if ohost not in _LOCAL_HOSTS:
                        return False
                return True

            def do_POST(self):
                if self.path.rstrip("/") != "/input":
                    self._send(404, b"not found", "text/plain")
                    return
                if not self._local_request():
                    self._send(403, b"forbidden", "text/plain")
                    return
                n = int(self.headers.get("Content-Length", 0))
                try:
                    msg = json.loads(self.rfile.read(n) or b"{}")
                except ValueError:
                    self._send(400, b"bad json", "text/plain")
                    return
                out = viewer.handle_input(msg)
                self._send(200, json.dumps(out).encode(), "application/json")

        return ThreadingHTTPServer((host, port), Handler)

    def serve(self, port: int = 8000, host: str = "127.0.0.1"):
        """Serve until interrupted."""
        with self.make_server(port, host) as httpd:
            eng = self.engine
            where = eng.device if eng.mesh is None else eng.mesh
            print(f"viewer: http://{host}:{httpd.server_address[1]}/  "
                  f"(grid {eng.config.grid_size}³ on {where})")
            httpd.serve_forever()


def serve(port: int = 8000, device="cuda", **config_overrides):
    ViewerServer(device=device, **config_overrides).serve(port=port)
