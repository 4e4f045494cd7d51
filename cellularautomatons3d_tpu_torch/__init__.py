"""cellularautomatons3d_tpu_torch — the engine on PyTorch and CUDA.

A port of ``cellularautomatons3d_tpu`` (JAX/Pallas on a TPU) to PyTorch
with hand-written CUDA kernels for an NVIDIA H100 (``sm_90a``).  The JAX
package stays the reference; this package imports ``torch`` and never
``jax``, and keeps the reference's module paths and names.

This first slice covers the main path: the binary bit-packed CA step
(``ops.ca_step``, kernel ``csrc/ca_step.cu``) and the fast renderer's fused
frame kernel K1 (``render.render_fast``, kernel ``csrc/render_fast.cu``),
driven by :class:`Engine` (``step``, ``render``, ``tick``, ``run``,
``run_fused``).  On a CPU device the same calls run the kernels' plain
torch versions.
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
from .ops import (
    pack_grid,
    unpack_grid,
    seed_center,
    seed_random_block,
    step_packed,
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
    "step_packed",
    "make_step_fn",
    "__version__",
]
