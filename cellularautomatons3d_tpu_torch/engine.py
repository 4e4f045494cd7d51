"""Engine: lifecycle, frame loop and reconfiguration on one device.

Port of ``cellularautomatons3d_tpu.engine.Engine`` for the fast pipeline:
the same live/restart parameter split, frame-loop cadence (render every
frame, step when the accumulated frame time crosses
``compute_step_duration_ms``, main_pathtraced.js:1838-1847) and fused
production loop, on an explicit torch ``device``.

On a CUDA device every CA step and every frame goes through the hand
kernels (``csrc/ca_step.cu``, ``csrc/render_fast.cu``); on the CPU through
their plain torch versions.  ``device="cuda"`` without a usable card
raises: nothing moves silently to the CPU.

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP.md
queue-1 item: soft shadows, GI and ``gi_temporal`` (6); grids above 256³
(7); a moving camera once history exists (8); checkpoints (9); the
reference pipeline (11); ``mesh_devices`` (12); multi-state rules (14).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.automaton import AutomatonSpec
from .ops import packing
from .ops.ca_step import step_packed
from .render.camera import CameraRig
from .render.renderer import RenderParams, RenderStatic
from .render.renderer_fast import (
    FastHistory,
    check_supported,
    init_fast_history,
    make_fused_loop,
    render_frame_fast,
)
from .utils.config import EngineConfig

__all__ = ["Engine"]


def _check_config(cfg: EngineConfig) -> None:
    if cfg.pipeline != "fast":
        raise NotImplementedError(
            "pipeline='reference' is not ported yet (ROADMAP.md queue 1, item 11)"
        )
    if cfg.mesh_devices:
        raise NotImplementedError(
            "mesh_devices is not ported yet (ROADMAP.md queue 1, item 12)"
        )
    if cfg.total_states > 2:
        raise NotImplementedError(
            "multi-state rules are not ported yet (ROADMAP.md queue 1, item 14)"
        )


def _render_static(cfg: EngineConfig) -> RenderStatic:
    s = RenderStatic(
        width=cfg.width,
        height=cfg.height,
        grid_size=cfg.grid_size,
        indirect_lighting=bool(cfg.indirect_lighting),
        soft_shadow_samples=int(cfg.soft_shadow_samples),
        gi_temporal=bool(cfg.gi_temporal),
    )
    check_supported(s)
    return s


class Engine:
    """A running automaton + renderer with carried temporal state."""

    def __init__(self, config: EngineConfig | None = None, device="cuda",
                 **overrides):
        if config is None:
            config = EngineConfig(**overrides)
        elif overrides:
            config = config.replace(**overrides)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Engine(device='cuda') needs a CUDA device, and "
                "torch.cuda.is_available() is false; pass device='cpu' for "
                "the plain torch path"
            )
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {self.device}")
        self.config = config
        self.camera = CameraRig()
        self._pending_restart: list[tuple[str, object]] = []
        self._time_ms = 0.0
        self._build()

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    def _build(self):
        cfg = self.config
        _check_config(cfg)
        self.spec = AutomatonSpec.from_config(cfg)
        self.render_static = _render_static(cfg)
        self.simulation_step = 0
        self._frame_duration = 0.0
        self.history = init_fast_history(cfg.width, cfg.height, self.device)
        self._seed_state()

    def _seed_state(self):
        cfg = self.config
        if cfg.random_initial_state:
            dense = packing.seed_random_block(cfg.grid_size, rng=cfg.seed)
        else:
            dense = packing.seed_center(cfg.grid_size)
        self.set_state_dense(dense)

    # ------------------------------------------------------------------ #
    # state accessors
    # ------------------------------------------------------------------ #
    def set_state_dense(self, dense: np.ndarray):
        """Load a dense ``uint8[Z, Y, X]`` 0/1 grid as the current state."""
        words = packing.pack_grid(dense).view(np.int32)
        self.state = torch.from_numpy(words).to(self.device)

    def state_dense(self) -> np.ndarray:
        """Current state as dense ``uint8[Z, Y, X]`` 0/1 cells."""
        words = self.state.cpu().numpy().view(np.uint32)
        return packing.unpack_grid(words)

    # ------------------------------------------------------------------ #
    # simulation
    # ------------------------------------------------------------------ #
    def step(self, n: int = 1):
        """Advance the CA ``n`` generations."""
        for _ in range(n):
            self.state = step_packed(self.state, self.spec)
            self.simulation_step += 1
        return self

    # ------------------------------------------------------------------ #
    # rendering
    # ------------------------------------------------------------------ #
    def _light_position(self) -> np.ndarray:
        light = self.config.light
        x, y, z = light.position
        if light.animate:
            # main_pathtraced.js:1752-1760 (performance.now()*0.0007 orbit).
            t = self._time_ms * 0.0007
            y = np.sin(t) * light.orbit_distance
            x = np.cos(t) * light.orbit_distance
        return np.array([x, y, z], dtype=np.float32)

    def render_params(self) -> RenderParams:
        cfg = self.config
        view = self.camera.matrices(cfg.width, cfg.height)[0]
        f32 = np.float32
        return RenderParams(
            view_mat=np.asarray(view, f32),
            elapsed_time=f32(self._time_ms * 1e-4),
            cell_size=f32(cfg.cell_size),
            temporal_alpha=f32(cfg.temporal_alpha),
            gamma=f32(cfg.gamma),
            roughness=f32(cfg.roughness),
            base_reflectivity=np.asarray(cfg.base_reflectivity, f32),
            material_color=np.asarray(cfg.material_color, f32),
            light_pos=self._light_position(),
            light_magnitude=f32(cfg.light.magnitude),
            show_depth_overlay=f32(1.0 if cfg.show_depth_overlay else 0.0),
            light_radius=f32(cfg.light_radius),
            emissive_color=np.asarray(cfg.emissive_color, f32),
            emissive_strength=f32(cfg.emissive_strength),
        )

    def render(self, dt_ms: float = 16.667) -> torch.Tensor:
        """Render one frame [H, W, 3]; advances the frame clock and camera
        history."""
        self._time_ms += dt_ms
        params = self.render_params()
        moved = not np.array_equal(self.camera.view_mat, self.camera.prev_view_mat)
        # With no history yet (every id -1) a moved camera blends nothing,
        # exactly like a static one; only a move over a live history needs
        # the reprojection that is not ported yet.
        if moved and bool((self.history.hit_idx >= 0).any()):
            raise NotImplementedError(
                "a moving camera (history reprojection) is not ported yet "
                "(ROADMAP.md queue 1, item 8)"
            )
        frame, _, self.history = render_frame_fast(
            self.render_static, self.state, params, self.history, True
        )
        self.camera.end_frame()
        return frame

    def tick(self, dt_ms: float = 16.667) -> torch.Tensor:
        """One frame-loop iteration with the reference's cadence: render
        first, then step the CA if the sim timer fired
        (main_pathtraced.js:1833-1850)."""
        self._frame_duration += dt_ms
        frame = self.render(dt_ms)
        if self._frame_duration >= self.config.compute_step_duration_ms:
            self.step()
            self._frame_duration = 0.0
        return frame

    def run(self, frames: int, dt_ms: float = 16.667, sink=None):
        """Run the frame loop for ``frames`` iterations; optionally feed
        each frame to ``sink(frame_idx, frame)``."""
        frame = None
        for i in range(frames):
            frame = self.tick(dt_ms)
            if sink is not None:
                sink(i, frame)
        return frame

    def run_fused(self, frames: int, steps_per_frame: int = 1,
                  reset_every: int = 0) -> torch.Tensor:
        """Run (steps_per_frame CA steps + 1 composed frame) × frames with
        no host synchronisation (static camera).  ``reset_every > 0``
        restores the starting state after every that many frames, as the
        benchmark's pinned line does.  Returns the last frame."""
        run = make_fused_loop(
            self.render_static, self.spec, frames, steps_per_frame, reset_every
        )
        self.state, self.history, frame = run(
            self.state, self.render_params(), self.history
        )
        self.simulation_step += frames * steps_per_frame
        self._time_ms += frames * 16.667
        self.camera.end_frame()
        return frame

    # ------------------------------------------------------------------ #
    # reconfiguration (the UI input / restart paths)
    # ------------------------------------------------------------------ #
    _RENDER_REBUILD_FIELDS = frozenset(
        {
            "pipeline",
            "render_variant",
            "depth_samples",
            "shadow_samples",
            "indirect_lighting",
            "indirect_bounces",
            "soft_shadow_samples",
            "gi_temporal",
            "width",
            "height",
        }
    )

    def set(self, name: str, value):
        """Set a parameter by config-field name.  Live fields apply
        immediately; restart-bound fields are deferred until
        :meth:`restart` (main_pathtraced.js:639-650)."""
        if name in EngineConfig.RESTART_FIELDS:
            self._pending_restart.append((name, value))
            return self
        if "." in name:  # e.g. "light.magnitude"
            head, tail = name.split(".", 1)
            nested = dataclasses.replace(getattr(self.config, head), **{tail: value})
            self.config = self.config.replace(**{head: nested})
            return self
        cfg = self.config.replace(**{name: value})
        if name in self._RENDER_REBUILD_FIELDS:
            # Rebuild RenderStatic (and the history on a resize) without
            # touching simulation state, the live-resize path
            # (main_pathtraced.js:781-797); an unported setting raises
            # before anything changes.
            _check_config(cfg)
            self.render_static = _render_static(cfg)
            if self.history.color.shape[:2] != (cfg.height, cfg.width):
                self.history = init_fast_history(cfg.width, cfg.height, self.device)
        self.config = cfg
        return self

    @property
    def restart_required(self) -> bool:
        return bool(self._pending_restart)

    def restart(self):
        """Apply deferred values, reseed state (main_pathtraced.js:624-637)."""
        updates = dict(self._pending_restart)
        self._pending_restart.clear()
        if updates:
            self.config = self.config.replace(**updates)
        self._time_ms = 0.0
        self._build()
        return self
