from .packing import (
    pack_grid,
    unpack_grid,
    packed_shape,
    seed_center,
    seed_random_block,
    to_reference_order,
    from_reference_order,
)
from .ca_reference import step_dense, run_dense
from .ca_step import (
    step_packed,
    step_packed_multistate,
    step_packed_multistate_cuda,
    make_step_fn,
    fires_plane,
    fires_plane_cuda,
    visibility_plane,
)
from .loop import make_multi_step
from .occupancy import coarse_occupancy, occupancy_mip, occupancy_mip_box

__all__ = [
    "pack_grid",
    "unpack_grid",
    "packed_shape",
    "seed_center",
    "seed_random_block",
    "to_reference_order",
    "from_reference_order",
    "step_dense",
    "run_dense",
    "step_packed",
    "step_packed_multistate",
    "step_packed_multistate_cuda",
    "make_step_fn",
    "make_multi_step",
    "visibility_plane",
    "fires_plane",
    "fires_plane_cuda",
    "coarse_occupancy",
    "occupancy_mip",
    "occupancy_mip_box",
]
