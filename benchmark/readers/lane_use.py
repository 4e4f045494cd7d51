"""The share, in %, of the occlusion lanes K2 traced whose flag the shade
kernel read: the program's work counters ``occlusion_lanes_read`` over
``occlusion_lanes``."""

from . import program


def read(ctx, spec):
    c = program.counts()
    if not c or not c.get("occlusion_lanes"):
        return None
    return 100.0 * c["occlusion_lanes_read"] / c["occlusion_lanes"]
