"""cellularautomatons3d_tpu_torch — the engine on PyTorch and CUDA.

A port of ``cellularautomatons3d_tpu`` (JAX/Pallas on a TPU) to PyTorch
with hand-written CUDA kernels for an NVIDIA H100 (``sm_90a``).  The JAX
package stays the reference; this package imports ``torch`` and never
``jax``, and keeps the reference's module paths and names.

It covers the bit-packed CA step for binary and multi-state (Generations)
rules (``ops.ca_step``, kernels ``csrc/ca_step.cu``; a multi-state state is
``spec.age_bits`` age bit-planes, and K1 and K4 fetch the hit cell's age
from them to fade dying cells) and the fast renderer at every grid from 32³ to
1024³: up to 256³ the fused frame kernel K1 (``render.render_fast``,
kernel ``csrc/render_fast.cu``), above it the sliced path
(``render.render_slab.raytrace_sliced``) with the primary-hit kernel K4
(``csrc/primary_sweep.cu``); and the extended lighting -- soft shadows,
one- and multi-bounce GI, the temporally amortized mode
(``render.render_slab`` with the occlusion kernel K2,
``csrc/shadow_sweep.cu``, and the cell-state kernel K3,
``csrc/cell_state.cu``) -- driven by :class:`Engine` (``step``, ``render``,
``tick``, ``run``, ``run_fused``).  Opt-in paths, off by default as in
the reference: the multi-query occlusion kernel K5
(``csrc/shadow_multi.cu``, ``CA3D_OCC_SWEEP=0``), the patch prepass K6
(``csrc/prepass.cuh``, run inside K1 on the card, and alone as
``csrc/prepass.cu``) with K1's column-mask gate
(``render_fast.raytrace_tiles(use_prepass=True)``), and K1's descents
``CA3D_MIP1=1`` (the plane mip, ``csrc/plane_occupancy.cu``) and
``CA3D_SLICEGATE=1`` (``render.render_fast``).  On a CPU device the
same calls run the kernels' plain torch versions.

The exact reference pipeline (``Engine(pipeline="reference")``, and its
``render_variant="simple"``): ``render.renderer.render_frame``, the
shader's stochastic march, temporal depth refinement, shadow march and
colour reprojection in plain torch on the Engine's device, as the reference
runs it in XLA (``render.raymarch``, ``render.intersect``, ``render.brdf``).

The interactive path: a camera move between frames reprojects the temporal
history (``render.renderer_fast.reproject_history``); :meth:`Engine.save` /
:meth:`Engine.load` read and write the JAX package's npz checkpoints; the
viewer (``python -m cellularautomatons3d_tpu_torch.viewer``, its Engine on the
card unless ``--device cpu``) streams PNG frames (``utils.image``,
``utils.video``, the C codec ``native/framesink.c`` built at first use).

Multi-device: ``Engine(mesh_devices=N)`` / ``Engine(mesh_shape=(mz, my))``
shards the state along Z (or Z and Y) over a mesh of devices and the frame
by pixel rows (``parallel.sharded``: halo exchange by copies between the
shards' devices, the slab mode of ``csrc/ca_step.cu`` stepping each shard);
``parallel.dryrun_multichip`` runs every mesh path once.  ``utils.metrics``
and ``utils.profiling`` time and trace (CUDA events, ``torch.profiler``); the
attribution tools of ``tools`` (``python -m
cellularautomatons3d_tpu_torch.tools.<name>``: ``profile_trace``,
``trace_summary``, ``profile_gi``, ``profile_frame``, ``bench_dense``,
``bench_scale``, ``bench_512_ablate``) measure where a frame's time goes.
"""

from .utils.config import EngineConfig, LightConfig, BoundaryMode
from .models import (
    AutomatonSpec,
    RuleSet,
    NEIGHBOURHOOD_MAP,
    get_neighbourhood,
    PRESETS,
    preset_config,
)
from .engine import Engine
from .interop import from_reference, to_reference
from .utils import image, metrics, profiling, video
from .ops import (
    pack_grid,
    unpack_grid,
    seed_center,
    seed_random_block,
    step_dense,
    step_packed,
    step_packed_multistate,
    make_step_fn,
)

__version__ = "0.1.0"

__all__ = [
    "Engine",
    "EngineConfig",
    "LightConfig",
    "BoundaryMode",
    "AutomatonSpec",
    "RuleSet",
    "NEIGHBOURHOOD_MAP",
    "get_neighbourhood",
    "PRESETS",
    "preset_config",
    "from_reference",
    "to_reference",
    "pack_grid",
    "unpack_grid",
    "seed_center",
    "seed_random_block",
    "step_dense",
    "step_packed",
    "step_packed_multistate",
    "make_step_fn",
    "__version__",
]
