"""Multi-device stepping and the port's multi-device dry run."""

from .sharded import (
    AXIS,
    AXIS_Y,
    Mesh,
    Sharded,
    exchange_halos,
    make_mesh,
    make_sharded_step,
    shard_rows,
    shard_state,
    halo_exchange_y,
    halo_exchange_z,
)
from .dryrun import dryrun_multichip

__all__ = [
    "AXIS",
    "AXIS_Y",
    "Mesh",
    "Sharded",
    "exchange_halos",
    "make_mesh",
    "make_sharded_step",
    "shard_rows",
    "shard_state",
    "halo_exchange_y",
    "halo_exchange_z",
    "dryrun_multichip",
]
