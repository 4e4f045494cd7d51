from .packing import (
    pack_grid,
    unpack_grid,
    packed_shape,
    seed_center,
    seed_random_block,
    to_reference_order,
    from_reference_order,
)
from .ca_step import step_packed, make_step_fn, fires_plane, fires_plane_cuda
from .occupancy import coarse_occupancy

__all__ = [
    "pack_grid",
    "unpack_grid",
    "packed_shape",
    "seed_center",
    "seed_random_block",
    "to_reference_order",
    "from_reference_order",
    "step_packed",
    "make_step_fn",
    "fires_plane",
    "fires_plane_cuda",
    "coarse_occupancy",
]
