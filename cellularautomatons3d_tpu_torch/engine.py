"""Engine: lifecycle, frame loop and reconfiguration on one device.

Port of ``cellularautomatons3d_tpu.engine.Engine`` for the fast pipeline:
the same live/restart parameter split, frame-loop cadence (render every
frame, step when the accumulated frame time crosses
``compute_step_duration_ms``, main_pathtraced.js:1838-1847) and fused
production loop, on an explicit torch ``device``.

Every grid the reference takes, 32³ to 1024³, renders, for binary rules
and for multi-state (Generations) rules, ``total_states`` 3 to 10, whose
state is ``spec.age_bits`` age bit-planes and whose dying cells fade with
age.  On a CUDA device every CA step and every frame goes through the hand
kernels: the step ``csrc/ca_step.cu`` (binary, or the alive-plane pass and
the multi-state step); up to 256³ the frame kernel ``csrc/render_fast.cu``,
with soft shadows or GI also ``csrc/shadow_sweep.cu`` and
``csrc/cell_state.cu``; above 256³ the primary-hit kernel
``csrc/primary_sweep.cu`` and ``csrc/shadow_sweep.cu`` for every frame,
with GI also ``csrc/cell_state.cu``.  On the CPU the same calls run their
plain torch versions.  ``device="cuda"`` without a usable card raises:
nothing moves silently to the CPU.  With ``gi_temporal`` each
:meth:`Engine.render` passes its frame count as the sample index, so the
soft-shadow sample and the GI slot rotate and the EMA converges to the
full lighting.

``pipeline="reference"`` renders through the exact reference pipeline
(``render.renderer.render_frame``, ``render_variant`` "clustered" or
"simple") in plain torch on the Engine's device, with its f16 colour / depth
:class:`~.render.renderer.RenderHistory`; the CA still steps through the
hand kernels.

A camera move between frames reprojects the history through the previous
view-projection (``renderer_fast.reproject_history``), as the JAX Engine
does; :meth:`Engine.save` / :meth:`Engine.load` write and read the JAX
package's npz checkpoints, so a file from either package loads in the other.

Not ported yet, raising ``NotImplementedError`` with its ROADMAP.md queue-1
item: ``mesh_devices`` (12).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from .models.automaton import AutomatonSpec
from .ops import packing
from .ops.ca_step import step_packed, visibility_plane
from .render.camera import CameraRig
from .render.renderer import (
    RenderHistory,
    RenderParams,
    RenderStatic,
    init_history,
    render_frame,
)
from .render.renderer_fast import (
    FastHistory,
    init_fast_history,
    make_fused_loop,
    render_frame_fast,
)
from .utils.config import EngineConfig

__all__ = ["Engine"]


def _check_config(cfg: EngineConfig) -> None:
    if cfg.mesh_devices:
        raise NotImplementedError(
            "mesh_devices is not ported yet (ROADMAP.md queue 1, item 12)"
        )


def _render_static(cfg: EngineConfig) -> RenderStatic:
    return RenderStatic(
        width=cfg.width,
        height=cfg.height,
        grid_size=cfg.grid_size,
        depth_samples=int(cfg.depth_samples),
        shadow_samples=int(cfg.shadow_samples),
        indirect_lighting=bool(cfg.indirect_lighting),
        soft_shadow_samples=int(cfg.soft_shadow_samples),
        indirect_bounces=int(cfg.indirect_bounces),
        gi_temporal=bool(cfg.gi_temporal),
    )


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
        self._render_count = 0
        self.history = self._init_history(cfg)
        self._seed_state()

    def _init_history(self, cfg: EngineConfig):
        """Zero history of the pipeline's type: ``FastHistory`` for the fast
        pipeline, ``RenderHistory`` for the reference one."""
        init = init_fast_history if cfg.pipeline == "fast" else init_history
        return init(cfg.width, cfg.height, self.device)

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
        """Load a dense ``uint8[Z, Y, X]`` age grid as the current state
        (0/1 cells for a binary rule): packed words ``[W, Z, Y]``, or for a
        multi-state rule the age bit-planes ``[B, W, Z, Y]``."""
        if self.spec.total_states == 2:
            words = packing.pack_grid(dense)
        else:
            words = np.stack([packing.pack_grid((dense >> i) & 1)
                              for i in range(self.spec.age_bits)])
        self.state = torch.from_numpy(words.view(np.int32)).to(self.device)

    def state_dense(self) -> np.ndarray:
        """Current state as dense ``uint8[Z, Y, X]`` ages."""
        words = self.state.cpu().numpy().view(np.uint32)
        if self.spec.total_states == 2:
            return packing.unpack_grid(words)
        return sum(packing.unpack_grid(words[i]).astype(np.uint8) << i
                   for i in range(words.shape[0]))

    def _visibility_plane(self) -> torch.Tensor:
        """Packed occupancy for the renderer: any cell with age ≥ 1."""
        return visibility_plane(self.state, self.spec)

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
        view, prev_view, _, prev_proj_view = self.camera.matrices(cfg.width, cfg.height)
        f32 = np.float32
        return RenderParams(
            view_mat=np.asarray(view, f32),
            prev_view_mat=np.asarray(prev_view, f32),
            prev_proj_view=np.asarray(prev_proj_view, f32),
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
        multistate = self.spec.total_states > 2
        if self.config.pipeline == "fast":
            camera_static = bool(
                np.array_equal(self.camera.view_mat, self.camera.prev_view_mat)
            )
            sample_idx = self._render_count if self.config.gi_temporal else None
            ages = {}
            if multistate:
                ages = dict(ages=self.state, total_states=self.spec.total_states)
            frame, _, self.history = render_frame_fast(
                self.render_static, self._visibility_plane(), params, self.history,
                camera_static, sample_idx, **ages,
            )
            self._render_count += 1
        else:
            frame, self.history = render_frame(
                self.render_static, self._visibility_plane(), params, self.history,
                self.state if multistate else None, self.spec.total_states,
                self.config.render_variant,
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
        no host synchronisation (static camera; fast pipeline).
        ``reset_every > 0`` restores the starting state after every that many
        frames, as the benchmark's pinned line does, and the generation
        count grows by the steps of the frames after the last restore.
        Returns the last frame."""
        if self.config.pipeline != "fast":
            raise ValueError("run_fused requires the fast pipeline")
        run = make_fused_loop(
            self.render_static, self.spec, frames, steps_per_frame, reset_every
        )
        self.state, self.history, frame = run(
            self.state, self.render_params(), self.history
        )
        standing = frames % reset_every if reset_every > 0 else frames
        self.simulation_step += standing * steps_per_frame
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
            # Rebuild RenderStatic, and the history when its type (the
            # pipeline) or its size no longer matches, without touching
            # simulation state: the live-resize path (main_pathtraced.js:
            # 781-797).
            self.render_static = _render_static(cfg)
            want_fast = cfg.pipeline == "fast"
            have_fast = isinstance(self.history, FastHistory)
            shape_ok = self.history.color.shape[:2] == (cfg.height, cfg.width)
            if want_fast != have_fast or not shape_ok:
                self.history = self._init_history(cfg)
        self.config = cfg
        return self

    @property
    def restart_required(self) -> bool:
        return bool(self._pending_restart)

    def restart(self):
        """Apply deferred values, reseed state (main_pathtraced.js:624-637)."""
        updates = dict(self._pending_restart)
        cfg = self.config.replace(**updates) if updates else self.config
        # An unported setting raises before anything changes; its pending
        # value stays until a later set() overrides it.
        _check_config(cfg)
        self._pending_restart.clear()
        self.config = cfg
        self._time_ms = 0.0
        self._build()
        return self

    # ------------------------------------------------------------------ #
    # checkpoint / resume (the JAX package's npz format)
    # ------------------------------------------------------------------ #
    def save(self, path: str, backend: str = "npz"):
        """Checkpoint to ``path`` as the JAX package's npz (engine.py:457-489
        there): the state as ``uint32`` words (age planes for a multi-state
        rule), the counters, the camera with its previous matrices, the
        config as JSON and the f16 history (colour and hit ids for the fast
        pipeline, colour and depth for the reference one), so either package
        loads it."""
        if backend == "orbax":
            raise NotImplementedError(
                "orbax checkpoints are the JAX package's (cellularautomatons3d_tpu"
                ".Engine.save(path, backend='orbax')); this Engine writes npz"
            )
        if backend != "npz":
            raise ValueError(f"unknown checkpoint backend {backend!r}")
        if isinstance(self.history, FastHistory):
            hist = dict(history_idx=self.history.hit_idx.cpu().numpy())
        else:
            hist = dict(history_depth=self.history.depth.cpu().numpy())
        np.savez_compressed(
            path,
            state=self.state.cpu().numpy().view(np.uint32),
            simulation_step=self.simulation_step,
            time_ms=self._time_ms,
            frame_duration=self._frame_duration,
            view_mat=self.camera.view_mat,
            prev_view_mat=self.camera.prev_view_mat,
            prev_proj_view=self.camera.prev_proj_view,
            config=json.dumps(dataclasses.asdict(self.config)),
            history_color=self.history.color.cpu().numpy(),
            **hist,
        )

    @classmethod
    def load(cls, path: str, device="cuda") -> "Engine":
        """An Engine on ``device`` resumed from an npz checkpoint written by
        :meth:`save` or by the JAX package's ``Engine.save`` (engine.py:573-608
        there).  Files that predate ``prev_proj_view`` or ``frame_duration``
        keep their defaults, as in the reference."""
        if os.path.isdir(path):
            raise NotImplementedError(
                f"{path} is a directory, an orbax checkpoint: load it with the "
                "JAX package (cellularautomatons3d_tpu.Engine.load)"
            )
        with np.load(path, allow_pickle=False) as data:
            cfg = EngineConfig(**json.loads(str(data["config"])))
            eng = cls(cfg, device=device)
            words = data["state"]
            if words.dtype != np.uint32 or words.shape != tuple(eng.state.shape):
                raise ValueError(
                    f"checkpoint state is {words.dtype}{list(words.shape)}, expected "
                    f"uint32{list(eng.state.shape)} for this config"
                )
            eng.state = torch.from_numpy(words.view(np.int32)).to(eng.device)
            eng.simulation_step = int(data["simulation_step"])
            eng._time_ms = float(data["time_ms"])
            color = torch.from_numpy(data["history_color"].astype(np.float16)).to(eng.device)
            if "history_idx" in data:
                eng.history = FastHistory(
                    color=color,
                    hit_idx=torch.from_numpy(data["history_idx"].astype(np.int32)).to(eng.device),
                )
            else:
                eng.history = RenderHistory(
                    color=color,
                    depth=torch.from_numpy(data["history_depth"].astype(np.float16)).to(eng.device),
                )
            eng.camera.view_mat = data["view_mat"].astype(np.float32)
            eng.camera.prev_view_mat = data["prev_view_mat"].astype(np.float32)
            if "prev_proj_view" in data:
                eng.camera.prev_proj_view = data["prev_proj_view"].astype(np.float32)
            if "frame_duration" in data:
                eng._frame_duration = float(data["frame_duration"])
        return eng
