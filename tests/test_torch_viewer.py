"""The port's viewer and frame output: ``viewer.ws`` (the reference's
``tests/test_viewer_ws.py`` cases), the PNG encoders (``native/framesink.c``
built at first use, and the pure-Python writer), ``utils.video`` and
``viewer.server.ViewerServer`` over a CPU Engine at 32³, with one real
HTTP request of each kind.  No JAX."""

import http.client
import io
import json
import threading

import numpy as np
import pytest
import torch

import cellularautomatons3d_tpu_torch as ct
from cellularautomatons3d_tpu_torch import native
from cellularautomatons3d_tpu_torch.utils import image, video
from cellularautomatons3d_tpu_torch.viewer import server, ws

from _torch_png import decode_png

CFG = dict(grid_size=32, width=64, height=32)


# --------------------------------------------------------------- ws ---
def _masked(payload: bytes, opcode=ws.OP_TEXT, mask=b"\x01\x02\x03\x04", fin=True):
    body = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
    n = len(payload)
    assert n < 126
    return bytes([(0x80 if fin else 0) | opcode, 0x80 | n]) + mask + body


def _ws_accept_key_rfc_example():
    # RFC 6455 §1.3 worked example.
    assert ws.accept_key("dGhlIHNhbXBsZSBub25jZQ==") == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="


def _ws_send_frame_small():
    buf = io.BytesIO()
    ws.send_frame(buf, b"hello", ws.OP_TEXT)
    data = buf.getvalue()
    assert data[0] == 0x81          # FIN + text
    assert data[1] == 5             # unmasked, 7-bit length
    assert data[2:] == b"hello"


def _ws_send_frame_medium_and_large_lengths():
    buf = io.BytesIO()
    ws.send_frame(buf, b"x" * 300)
    data = buf.getvalue()
    assert data[0] == 0x82 and data[1] == 126
    assert int.from_bytes(data[2:4], "big") == 300
    buf = io.BytesIO()
    ws.send_frame(buf, b"y" * 70000)
    data = buf.getvalue()
    assert data[1] == 127
    assert int.from_bytes(data[2:10], "big") == 70000


def _ws_recv_masked_client_frame():
    op, payload = ws.recv_message(io.BytesIO(_masked(b"hello")))
    assert op == ws.OP_TEXT and payload == b"hello"


def _ws_recv_fragmented_message():
    stream = _masked(b"hel", fin=False) + _masked(b"lo", opcode=ws.OP_CONT)
    op, payload = ws.recv_message(io.BytesIO(stream))
    assert op == ws.OP_TEXT and payload == b"hello"


def _ws_recv_eof():
    op, payload = ws.recv_message(io.BytesIO(b""))
    assert op is None and payload == b""


@pytest.mark.parametrize("case", [
    _ws_accept_key_rfc_example, _ws_send_frame_small,
    _ws_send_frame_medium_and_large_lengths, _ws_recv_masked_client_frame,
    _ws_recv_fragmented_message, _ws_recv_eof,
], ids=lambda f: f.__name__[4:])
def test_ws(case):
    case()


# -------------------------------------------------------------- PNG ---
def test_png_round_trip_through_both_encoders():
    rng = np.random.default_rng(4)
    frame = torch.from_numpy(rng.random((17, 23, 3), dtype=np.float32) * 1.2 - 0.1)
    frame[0, 0, 0] = float("nan")    # the GI 0/0 pixel shows black
    want = image.to_uint8(frame)
    assert want[0, 0, 0] == 0 and want.dtype == np.uint8
    assert native.HAVE_NATIVE, native.BUILD_ERROR  # cc and zlib are on the test host
    fast = image.encode_png(frame)
    slow = image._encode_png_py(want, 1)
    np.testing.assert_array_equal(decode_png(fast), want)
    np.testing.assert_array_equal(decode_png(slow), want)
    rgba = np.concatenate([want, np.full((17, 23, 1), 255, np.uint8)], axis=-1)
    np.testing.assert_array_equal(decode_png(image.encode_png(rgba)), rgba)
    np.testing.assert_array_equal(decode_png(image.encode_png(want[..., 0])),
                                  np.repeat(want[..., :1], 3, axis=-1))


def test_write_png_and_npy(tmp_path):
    frame = torch.rand((8, 12, 3))
    image.write_png(str(tmp_path / "f.png"), frame)
    image.write_npy(str(tmp_path / "f.npy"), frame)
    np.testing.assert_array_equal(decode_png((tmp_path / "f.png").read_bytes()),
                                  image.to_uint8(frame))
    np.testing.assert_array_equal(np.load(tmp_path / "f.npy"), frame.numpy())


def test_record_writes_every_frame(tmp_path):
    eng = ct.Engine(**CFG, device="cpu").step(4)
    frames = []
    real = eng.tick

    def tick(dt_ms=16.667):
        frames.append(real(dt_ms))
        return frames[-1]

    eng.tick = tick
    assert video.record(eng, str(tmp_path), 3) == 3
    index = json.loads((tmp_path / "index.json").read_text())
    assert index == {"frames": 3, "pattern": "frame_%06d.png"}
    for i, f in enumerate(frames):
        got = decode_png((tmp_path / f"frame_{i:06d}.png").read_bytes())
        np.testing.assert_array_equal(got, image.to_uint8(f))


# ----------------------------------------------------------- server ---
@pytest.fixture
def viewer():
    return server.ViewerServer(device="cpu", **CFG)


def test_viewer_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        server.ViewerServer(**CFG)


def test_main_defaults_to_the_card(monkeypatch):
    from cellularautomatons3d_tpu_torch.viewer import __main__ as cli

    calls = []
    monkeypatch.setattr(cli, "serve", lambda **kw: calls.append(kw))
    monkeypatch.setattr("sys.argv", ["viewer", "--grid", "32"])
    cli.main()
    monkeypatch.setattr("sys.argv", ["viewer", "--device", "cpu", "--mesh", "2",
                                     "--preset", "pyroclastic"])
    cli.main()
    assert calls[0]["device"] == "cuda" and calls[0]["grid_size"] == 32
    assert calls[1]["device"] == "cpu" and calls[1]["mesh_devices"] == 2
    assert calls[1]["total_states"] == ct.PRESETS["pyroclastic"]["total_states"]


def test_field_spec(viewer):
    spec = {f["name"]: f for f in viewer.field_spec()}
    assert [f[0] for f in server.FIELDS] == list(spec)
    assert spec["grid_size"]["value"] == 32 and spec["grid_size"]["restart"]
    assert spec["light.magnitude"]["value"] == viewer.engine.config.light.magnitude
    assert spec["neighbourhood"]["options"] == list(ct.NEIGHBOURHOOD_MAP)
    assert isinstance(spec["base_reflectivity"]["value"], list)
    json.dumps(spec)


def test_handle_input_each_kind(viewer):
    eng = viewer.engine
    view0 = eng.camera.view_mat.copy()
    out = viewer.handle_input({"type": "keys", "dt": 0.1, "translate": [0, 0, -1]})
    assert out == {"ok": True, "restart_required": False, "simulation_step": 0}
    assert eng.camera.view_mat[2, 3] < view0[2, 3]
    view1 = eng.camera.view_mat.copy()
    viewer.handle_input({"type": "keys", "dt": 0.1, "rotate": [0, 1, 0]})
    assert not np.array_equal(eng.camera.view_mat, view1)
    view2 = eng.camera.view_mat.copy()
    viewer.handle_input({"type": "mouse", "dx": 10, "dy": -4})
    assert not np.array_equal(eng.camera.view_mat, view2)
    viewer.handle_input({"type": "wheel", "deltaY": -100})
    assert eng.camera.translation_speed_mul > 0.2
    viewer.handle_input({"type": "param", "name": "light.magnitude", "value": 7.5})
    assert eng.config.light.magnitude == 7.5
    viewer.handle_input({"type": "param", "name": "soft_shadow_samples", "value": 4})
    assert eng.render_static.soft_shadow_samples == 4
    out = viewer.handle_input({"type": "param", "name": "born", "value": "2"})
    assert out["restart_required"]
    out = viewer.handle_input({"type": "restart"})
    assert out["ok"] and not out["restart_required"] and eng.config.born == "2"


def test_handle_input_applies_mesh_devices(viewer):
    """``mesh_devices`` (once refused as ROADMAP item 12) applies on restart:
    the CPU Engine shards over a mesh of CPU shards and serves frames; a mesh
    the grid cannot divide answers ok: false and leaves the Engine as it
    was."""
    eng = viewer.engine
    eng.step(3)
    out = viewer.handle_input({"type": "param", "name": "mesh_devices", "value": 2})
    assert out["ok"] and out["restart_required"]
    out = viewer.handle_input({"type": "restart"})
    assert out == {"ok": True, "restart_required": False, "simulation_step": 0}
    assert eng.mesh.shape == {"z": 2} and eng.config.mesh_devices == 2
    png = viewer.frame_png()
    assert decode_png(png).shape == (CFG["height"], CFG["width"], 3)
    eng.step(2)
    state = eng.state_dense()
    viewer.handle_input({"type": "param", "name": "mesh_devices", "value": 3})
    out = viewer.handle_input({"type": "restart"})
    assert out["ok"] is False and "divisible" in out["error"]
    assert out["restart_required"] and out["simulation_step"] == 2
    assert eng.config.mesh_devices == 2 and (eng.state_dense() == state).all()
    viewer.frame_png()  # the engine still renders
    viewer.handle_input({"type": "param", "name": "mesh_devices", "value": 0})
    out = viewer.handle_input({"type": "restart"})
    assert out["ok"] and out["simulation_step"] == 0 and eng.mesh is None


def test_handle_input_switches_to_the_reference_pipeline(viewer):
    """``pipeline`` and ``render_variant`` (once refused) apply like any
    render field: the Engine swaps its history, keeps its state and serves
    the reference pipeline's frames."""
    from cellularautomatons3d_tpu_torch.render.renderer import RenderHistory
    from cellularautomatons3d_tpu_torch.render.renderer_fast import FastHistory

    eng = viewer.engine
    eng.step(3)
    state = eng.state.clone()
    out = viewer.handle_input({"type": "param", "name": "pipeline", "value": "reference"})
    assert out == {"ok": True, "restart_required": False, "simulation_step": 3}
    assert eng.config.pipeline == "reference" and isinstance(eng.history, RenderHistory)
    assert torch.equal(eng.state, state)
    assert decode_png(viewer.frame_png()).shape == (eng.config.height, eng.config.width, 3)
    out = viewer.handle_input({"type": "param", "name": "render_variant", "value": "simple"})
    assert out["ok"] and eng.config.render_variant == "simple"
    viewer.frame_png()
    viewer.handle_input({"type": "param", "name": "render_variant", "value": "clustered"})
    viewer.handle_input({"type": "param", "name": "pipeline", "value": "fast"})
    assert eng.config.pipeline == "fast" and isinstance(eng.history, FastHistory)


def test_http_frame_and_input(viewer):
    """One GET /frame, /fields, / and one POST /input over a real socket on
    127.0.0.1 (http.client: no proxy), the server in a thread; a foreign
    Origin is refused."""
    httpd = viewer.make_server(port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=60)

    def request(method, path, body=None, headers=None):
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()

    try:
        frames = []
        real = viewer.engine.tick
        viewer.engine.tick = lambda dt_ms=16.667: frames.append(real(dt_ms)) or frames[-1]
        status, ctype, png = request("GET", "/frame")
        assert (status, ctype) == (200, "image/png")
        np.testing.assert_array_equal(decode_png(png), image.to_uint8(frames[-1]))
        assert decode_png(png).shape == (32, 64, 3)
        status, _, body = request("GET", "/fields")
        assert status == 200 and len(json.loads(body)) == len(server.FIELDS)
        status, _, body = request("GET", "/")
        assert status == 200 and b'<img id="frame"' in body
        msg = json.dumps({"type": "mouse", "dx": 5, "dy": 2})
        view = viewer.engine.camera.view_mat.copy()
        status, _, body = request("POST", "/input", msg, {"Content-Type": "application/json"})
        assert status == 200 and json.loads(body) == {
            "ok": True, "restart_required": False,
            "simulation_step": viewer.engine.simulation_step}
        assert not np.array_equal(viewer.engine.camera.view_mat, view)
        status, _, _ = request("POST", "/input", msg, {"Origin": "http://example.com"})
        assert status == 403
        assert request("GET", "/nothing")[0] == 404
    finally:
        conn.close()
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
