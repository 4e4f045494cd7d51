"""Many CA generations in one call.

Port of ``cellularautomatons3d_tpu.ops.loop``: the reference fuses the
generations into one jitted ``fori_loop``; here they are a plain loop over
:func:`~.ca_step.step_packed` (one kernel launch per generation for binary
rules, two for multi-state rules, on a CUDA tensor) with no host
synchronisation inside, so the launches queue on the stream back to back.
"""

from __future__ import annotations

from ..models.automaton import AutomatonSpec
from .ca_step import step_packed

__all__ = ["make_multi_step"]


def make_multi_step(spec: AutomatonSpec, steps: int):
    """``state → state`` advancing ``steps`` generations, for both state
    kinds (packed words, or age planes when ``spec.total_states > 2``).
    The input state is not modified."""

    def run(state):
        for _ in range(steps):
            state = step_packed(state, spec)
        return state

    return run
