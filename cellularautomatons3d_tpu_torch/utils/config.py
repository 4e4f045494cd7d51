"""Typed engine configuration with the reference's live/restart split.

The reference partitions its parameter surface (the UI field spec,
main_pathtraced.js:259-448) into **live** parameters — uploaded via the
uniform arena every frame, changeable without touching sim state — and
**restart-bound** parameters (``applyOnRestart``) — deferred until the user
restarts the simulation (main_pathtraced.js:624-664).

In the port the same split holds:

* *live* parameters are kernel arguments, read on the next frame;
* *restart* parameters change shapes or the automaton spec (grid size,
  neighbourhood, rule masks, state count, boundary) and take effect on
  :meth:`Engine.restart`, like the reference's restart path
  (main_pathtraced.js:624-637).

Copied from ``cellularautomatons3d_tpu.utils.config`` with the same fields
and defaults (main_pathtraced.js:100-153, SURVEY.md §2.1).  The port's
Engine takes every rule (``total_states`` 2 to 10), grid and lighting
setting, both pipelines and the mesh (``mesh_devices``, ``mesh_shape``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from ..models.rules import RuleSet
from ..models.neighbourhoods import NEIGHBOURHOOD_MAP
from ..types import BoundaryMode

__all__ = ["BoundaryMode", "LightConfig", "EngineConfig", "snap_grid_size"]


def snap_grid_size(v: int) -> int:
    """Round to the closest multiple of 32 (≤16 down, else up), the UI
    formatter at main_pathtraced.js:674-693."""
    m = v % 32
    if m == 0:
        return v
    return v - m if m <= 16 else v - m + 32


@dataclasses.dataclass
class LightConfig:
    """Point light (main_pathtraced.js:161-172) + orbit animation
    (main_pathtraced.js:1752-1760)."""

    position: Tuple[float, float, float] = (0.721, 1.0, 1.0)
    magnitude: float = 5.0
    animate: bool = False
    orbit_distance: float = 2.0


@dataclasses.dataclass
class EngineConfig:
    # --- restart-bound (shape / trace-time constants) ---------------------
    grid_size: int = 64                      # snapped to ×32, 3..1024
    neighbourhood: str = "von neumann"       # NEIGHBOURHOOD_MAP key
    born: str = "1,3"
    survive: str = "0-6"
    born_edges: str = "27"
    survive_edges: str = "27"
    born_corners: str = "27"
    survive_corners: str = "27"
    total_states: int = 2                    # ≥2; >2 = Generations-style decay
    random_initial_state: bool = False
    boundary: str = BoundaryMode.CLAMP_REF
    seed: int = 0                            # RNG seed for random init

    # --- live (kernel operands) -------------------------------------------
    cell_size: float = 0.85                  # visible cube fraction of a cell
    depth_samples: int = 35
    shadow_samples: int = 30
    temporal_alpha: float = 0.1
    gamma: float = 2.0                       # applied as pow(c, 1/gamma)
    roughness: float = 0.29
    base_reflectivity: Tuple[float, float, float] = (0.17, 0.17, 0.17)
    material_color: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # 0 ⇒ rainbow
    light: LightConfig = dataclasses.field(default_factory=LightConfig)
    show_depth_overlay: bool = False
    compute_step_duration_ms: float = 48.0   # sim cadence throttle
    width: int = 1920
    height: int = 1080
    # Render pipeline: "reference" = exact replication of the WGSL renderer
    # (stochastic march + reprojection, renderer.py); "fast" = the
    # deterministic exact DDA traversal (render_fast.py up to 256³,
    # render_slab.py above).
    pipeline: str = "fast"
    # Reference-pipeline shader variant: "clustered" (the active
    # pathtraced_fragment_clustered.wgsl, Cook-Torrance PBR) or "simple"
    # (the retained non-clustered pathtraced_fragment.wgsl: ad-hoc
    # reflect+diffuse lighting, fixed gamma 2.2 / alpha 0.1 — BASELINE
    # config 1 names this pipeline).
    render_variant: str = "clustered"
    # --- lighting extensions (BASELINE config 4; zero-defaults = reference) --
    indirect_lighting: bool = False      # one-bounce GI (wgsl:307-377, enabled)
    indirect_bounces: int = 1            # GI recursion depth (4^b neighbours)
    soft_shadow_samples: int = 1         # >1 = area-light soft shadows
    # Temporally-amortized lighting: soft shadows / GI evaluate ONE
    # rotating sample per frame and converge through the temporal EMA —
    # the reference's stochastic-accumulation pattern (wgsl:644,429-471)
    # applied to the extended lighting.  Real-time GI mode.
    gi_temporal: bool = False
    light_radius: float = 0.0            # area-light radius for soft shadows
    emissive_color: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    emissive_strength: float = 0.0
    # --- multi-chip scaling (BASELINE config 5; new capability) ----------
    # 0 = single device.  N > 1 builds an N-device 1-D mesh: the CA state
    # is Z-sharded with ICI halo exchange (parallel/sharded.py) and frames
    # are rendered pixel-row-sharded over the replicated packed grid.
    mesh_devices: int = 0
    # Pod scale: (mz, my) builds a 2-D (z, y) mesh — the grid shards along
    # Z and Y (z-then-y halo exchange), frames row-shard over all mz·my
    # devices.  Mutually consistent with mesh_devices (product must match
    # when both are set).
    mesh_shape: Tuple[int, int] | None = None

    def __post_init__(self):
        self.grid_size = snap_grid_size(int(self.grid_size))
        if not (32 <= self.grid_size <= 1024):
            raise ValueError(f"grid_size {self.grid_size} outside [32, 1024]")
        if self.neighbourhood not in NEIGHBOURHOOD_MAP:
            raise ValueError(f"unknown neighbourhood {self.neighbourhood!r}")
        if self.boundary not in BoundaryMode.ALL:
            raise ValueError(f"unknown boundary mode {self.boundary!r}")
        if self.total_states < 2:
            raise ValueError("total_states must be ≥ 2")
        if self.pipeline not in ("fast", "reference"):
            raise ValueError(f"unknown pipeline {self.pipeline!r}")
        if self.render_variant not in ("clustered", "simple"):
            raise ValueError(f"unknown render_variant {self.render_variant!r}")
        if self.render_variant == "simple":
            self.pipeline = "reference"  # only the exact path has it
        # Fast pipeline covers the full reference grid range (≤ 1024,
        # main_pathtraced.js:274-277): ≤ 256 the fused frame kernel K1;
        # 257-1024 the sliced path (render_slab.py), one launch of K4 over
        # the whole volume.
        if isinstance(self.light, dict):
            self.light = LightConfig(**self.light)
        if self.mesh_shape is not None:
            self.mesh_shape = tuple(int(v) for v in self.mesh_shape)
            mz, my = self.mesh_shape
            if self.mesh_devices and self.mesh_devices != mz * my:
                raise ValueError(
                    f"mesh_devices {self.mesh_devices} != mesh_shape "
                    f"product {mz * my}"
                )
            self.mesh_devices = mz * my
            if self.grid_size % mz or self.grid_size % my:
                raise ValueError(
                    f"grid_size {self.grid_size} not divisible by mesh_shape "
                    f"{self.mesh_shape}"
                )
        if self.mesh_devices:
            if self.grid_size % self.mesh_devices:
                raise ValueError(
                    f"grid_size {self.grid_size} not divisible by "
                    f"mesh_devices {self.mesh_devices}"
                )
            if self.height % self.mesh_devices:
                raise ValueError(
                    f"height {self.height} not divisible by "
                    f"mesh_devices {self.mesh_devices} (row-sharded render)"
                )

    def ruleset(self) -> RuleSet:
        return RuleSet.from_strings(
            born=self.born,
            survive=self.survive,
            born_edges=self.born_edges,
            survive_edges=self.survive_edges,
            born_corners=self.born_corners,
            survive_corners=self.survive_corners,
        )

    # Fields whose change requires an engine restart (recompile/reshape),
    # mirroring the reference's applyOnRestart markers
    # (main_pathtraced.js:268-448).
    RESTART_FIELDS = frozenset(
        {
            "grid_size",
            "neighbourhood",
            "born",
            "survive",
            "born_edges",
            "survive_edges",
            "born_corners",
            "survive_corners",
            "total_states",
            "random_initial_state",
            "boundary",
            "seed",
            "mesh_devices",
            "mesh_shape",
            # width/height are live: the Engine reallocates history buffers
            # on resize, matching the reference's mid-run resize path
            # (main_pathtraced.js:781-797).
        }
    )

    def replace(self, **kwargs) -> "EngineConfig":
        return dataclasses.replace(self, **kwargs)
