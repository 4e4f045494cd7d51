"""Engine: lifecycle, frame loop and reconfiguration, on one device or a mesh.

Port of ``cellularautomatons3d_tpu.engine.Engine``: the same live/restart
parameter split, frame-loop cadence (render every frame, step when the
accumulated frame time crosses ``compute_step_duration_ms``,
main_pathtraced.js:1838-1847) and fused production loop, on an explicit
torch ``device``.

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

``mesh_devices=N`` (or ``mesh_shape=(mz, my)``) shards the Engine over a
mesh (``parallel.sharded``, the JAX Engine's mesh mode): the state split
along Z (or Z and Y) and stepped with halo exchange through the slab mode of
the step kernel, the fast pipeline's frame rendered by pixel rows, each
shard its ``height / N`` rows of the whole window from the gathered volume
(``render_frame_fast(row0=, full_height=)``), with the history split the same
way.  ``mesh_device_list`` names the mesh's devices, which may repeat
(``[torch.device("cuda", 0)] * 4`` puts four shards on one card); without
it a CPU Engine puts every shard on the CPU and a CUDA Engine takes
``cuda:0`` ... ``cuda:N-1``, raising when there are fewer cards.  The
reference pipeline renders the gathered state on the mesh's first device.
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
from .parallel.sharded import (
    Sharded,
    make_mesh,
    make_sharded_step,
    place_rows,
    shard_state,
    to_numpy,
)
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
                 mesh_device_list=None, **overrides):
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
        self.mesh_device_list = None if mesh_device_list is None else list(mesh_device_list)
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
        self.spec = AutomatonSpec.from_config(cfg)
        self.render_static = _render_static(cfg)
        self.simulation_step = 0
        self._frame_duration = 0.0
        self._render_count = 0
        self.mesh = self._make_mesh(cfg)
        self._sharded_step = None
        if self.mesh is not None:
            self._sharded_step = make_sharded_step(self.spec, self.mesh)
        self.history = self._init_history(cfg)
        self._seed_state()

    def _make_mesh(self, cfg: EngineConfig):
        """The mesh of ``cfg.mesh_devices`` (``cfg.mesh_shape``) over
        ``mesh_device_list``, or over every shard on the CPU for a CPU Engine
        and the first cards for a CUDA one; None without a mesh."""
        if not cfg.mesh_devices:
            return None
        devices = self.mesh_device_list
        if devices is None and self.device.type == "cpu":
            devices = [self.device] * cfg.mesh_devices
        return make_mesh(cfg.mesh_devices, devices=devices, shape=cfg.mesh_shape)

    def _place_history(self, history):
        """A history on the Engine's device, or row-sharded over its mesh
        (every mesh axis: a 2-D mesh splits rows mz · my ways)."""
        return place_rows(history, self.device, self.mesh)

    def _init_history(self, cfg: EngineConfig):
        """Zero history of the pipeline's type: ``FastHistory`` for the fast
        pipeline, ``RenderHistory`` for the reference one."""
        init = init_fast_history if cfg.pipeline == "fast" else init_history
        return self._place_history(init(cfg.width, cfg.height, self.device))

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
        self._set_words(words)

    def _set_words(self, words: np.ndarray):
        """Load packed ``uint32`` words as the state: on the Engine's device,
        or sharded over its mesh."""
        state = torch.from_numpy(words.view(np.int32))
        if self.mesh is None:
            self.state = state.to(self.device)
        else:
            self.state = shard_state(state, self.mesh)

    def _full_state(self) -> torch.Tensor:
        """The state as one tensor: a mesh Engine's gathered on its first
        device."""
        return self.state.full() if self.mesh is not None else self.state

    def state_dense(self) -> np.ndarray:
        """Current state as dense ``uint8[Z, Y, X]`` ages."""
        words = to_numpy(self.state).view(np.uint32)
        if self.spec.total_states == 2:
            return packing.unpack_grid(words)
        return sum(packing.unpack_grid(words[i]).astype(np.uint8) << i
                   for i in range(words.shape[0]))

    def _visibility_plane(self) -> torch.Tensor:
        """Packed occupancy for the renderer: any cell with age ≥ 1."""
        return visibility_plane(self._full_state(), self.spec)

    # ------------------------------------------------------------------ #
    # simulation
    # ------------------------------------------------------------------ #
    def step(self, n: int = 1):
        """Advance the CA ``n`` generations."""
        for _ in range(n):
            if self._sharded_step is not None:
                self.state = self._sharded_step(self.state)
            else:
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
        if self.config.pipeline == "fast" and self.mesh is not None:
            # As the JAX mesh render: no sample index, even with gi_temporal.
            frame = self._mesh_frame(self.state, params, camera_static, None)
        elif self.config.pipeline == "fast":
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
            # On a mesh: the gathered state and history on its first device,
            # the single-device frame, the history split by rows again.
            history = self.history
            if self.mesh is not None:
                history = type(history)(*(t.full() for t in history))
            frame, history = render_frame(
                self.render_static, self._visibility_plane(), params, history,
                self._full_state() if multistate else None, self.spec.total_states,
                self.config.render_variant,
            )
            self.history = history if self.mesh is None else self._place_history(history)
        self.camera.end_frame()
        return frame

    def _mesh_frame(self, state: Sharded, params: RenderParams,
                    camera_static: bool, sample_idx) -> torch.Tensor:
        """One fast-pipeline frame over the mesh (the JAX Engine's
        ``_build_mesh_render``): each shard renders its ``height / N`` rows
        of the window (``row0`` = its flat mesh index × ``height / N``) from
        the volume gathered on its device (once per device) and its row
        shard of the history, which it updates.  Returns the frame gathered
        on the mesh's first device."""
        mesh, s = self.mesh, self.render_static
        rows = s.height // mesh.size
        s_local = dataclasses.replace(s, height=rows)
        multistate = self.spec.total_states > 2
        volumes = {}
        frames = []
        colors = np.empty(mesh.devices.shape, dtype=object)
        ids = np.empty(mesh.devices.shape, dtype=object)
        for k, pos in enumerate(np.ndindex(mesh.devices.shape)):
            dev = mesh.devices[pos]
            if dev not in volumes:
                full = state.full(dev)
                volumes[dev] = (visibility_plane(full, self.spec), full)
            vis, full = volumes[dev]
            ages = dict(ages=full, total_states=self.spec.total_states) if multistate else {}
            hist = FastHistory(self.history.color.shards[pos], self.history.hit_idx.shards[pos])
            frame, _, hist = render_frame_fast(
                s_local, vis, params, hist, camera_static, sample_idx,
                row0=k * rows, full_height=s.height, **ages,
            )
            frames.append(frame.to(mesh.devices.flat[0]))
            colors[pos], ids[pos] = hist
        self.history = FastHistory(self.history.color.like(colors),
                                   self.history.hit_idx.like(ids))
        return torch.cat(frames, 0)

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
        if self.mesh is not None:
            frame = self._run_fused_mesh(frames, steps_per_frame, reset_every)
        else:
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

    def _run_fused_mesh(self, frames: int, steps_per_frame: int, reset_every: int):
        """The mesh's fused loop (the JAX Engine's ``_build_mesh_fused_loop``):
        per frame the sharded steps, then :meth:`_mesh_frame` with a static
        camera and, with ``gi_temporal``, the loop counter as the sample
        index; the history stays f16 between frames, as
        ``render_frame_fast`` keeps it."""
        params = self.render_params()
        start = st = self.state
        frame = None
        for i in range(frames):
            for _ in range(steps_per_frame):
                st = self._sharded_step(st)
            frame = self._mesh_frame(st, params, True,
                                     i if self.render_static.gi_temporal else None)
            if reset_every > 0 and (i + 1) % reset_every == 0:
                st = start
        self.state = st
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
        # A mesh the devices cannot hold, or whose shards the step refuses,
        # raises before anything changes; its pending value stays until a
        # later set() overrides it.
        mesh = self._make_mesh(cfg)
        if mesh is not None:
            make_sharded_step(AutomatonSpec.from_config(cfg), mesh)
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
            hist = dict(history_idx=to_numpy(self.history.hit_idx))
        else:
            hist = dict(history_depth=to_numpy(self.history.depth))
        np.savez_compressed(
            path,
            state=to_numpy(self.state).view(np.uint32),
            simulation_step=self.simulation_step,
            time_ms=self._time_ms,
            frame_duration=self._frame_duration,
            view_mat=self.camera.view_mat,
            prev_view_mat=self.camera.prev_view_mat,
            prev_proj_view=self.camera.prev_proj_view,
            config=json.dumps(dataclasses.asdict(self.config)),
            history_color=to_numpy(self.history.color),
            **hist,
        )

    @classmethod
    def load(cls, path: str, device="cuda", mesh_device_list=None) -> "Engine":
        """An Engine on ``device`` resumed from an npz checkpoint written by
        :meth:`save` or by the JAX package's ``Engine.save`` (engine.py:573-608
        there).  A mesh Engine's file (``mesh_devices`` in its config) resumes
        as a mesh Engine over ``mesh_device_list`` (as the constructor places
        it without one), with the state and history sharded.  Files that
        predate ``prev_proj_view`` or ``frame_duration`` keep their defaults,
        as in the reference."""
        if os.path.isdir(path):
            raise NotImplementedError(
                f"{path} is a directory, an orbax checkpoint: load it with the "
                "JAX package (cellularautomatons3d_tpu.Engine.load)"
            )
        with np.load(path, allow_pickle=False) as data:
            cfg = EngineConfig(**json.loads(str(data["config"])))
            eng = cls(cfg, device=device, mesh_device_list=mesh_device_list)
            words = data["state"]
            if words.dtype != np.uint32 or words.shape != tuple(eng.state.shape):
                raise ValueError(
                    f"checkpoint state is {words.dtype}{list(words.shape)}, expected "
                    f"uint32{list(eng.state.shape)} for this config"
                )
            eng._set_words(words)
            eng.simulation_step = int(data["simulation_step"])
            eng._time_ms = float(data["time_ms"])
            color = torch.from_numpy(data["history_color"].astype(np.float16))
            if "history_idx" in data:
                history = FastHistory(
                    color=color,
                    hit_idx=torch.from_numpy(data["history_idx"].astype(np.int32)),
                )
            else:
                history = RenderHistory(
                    color=color,
                    depth=torch.from_numpy(data["history_depth"].astype(np.float16)),
                )
            eng.history = eng._place_history(history)
            eng.camera.view_mat = data["view_mat"].astype(np.float32)
            eng.camera.prev_view_mat = data["prev_view_mat"].astype(np.float32)
            if "prev_proj_view" in data:
                eng.camera.prev_proj_view = data["prev_proj_view"].astype(np.float32)
            if "frame_duration" in data:
                eng._frame_duration = float(data["frame_duration"])
        return eng
