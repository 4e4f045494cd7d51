"""Static automaton specification: the restart-bound contract of a CA step.

An :class:`AutomatonSpec` bundles everything that is fixed between
restarts: grid size, neighbourhood offsets, rule masks, state count and
boundary mode (the reference's restart path, main_pathtraced.js:624-637).
Copied unchanged from ``cellularautomatons3d_tpu.models.automaton``; the
CUDA step kernel takes the offsets and masks as runtime arguments, so a new
spec needs no rebuild.

Rule evaluation semantics (compute_clustered.wgsl:192-247):

* three neighbour counts per cell — the configurable *main* neighbourhood,
  plus fixed *edges* (12) and *corners* (8) groups;
* each group looks up ``lut[state][count + 27*group]`` with ``lut[0]=born``,
  ``lut[1]=survive`` (compute_clustered.wgsl:165-190,208-232);
* the next state is 1 iff **any** group evaluates to 1
  (compute_clustered.wgsl:232).

Multi-state decay ("Generations"-style, the capability behind the vestigial
``_totalStates`` hook, main_pathtraced.js:133,431-439 and BASELINE.json
config 2): ages 0=dead, 1=alive, 2..S-1 dying.  Only age-1 cells count as
neighbours; a dead cell that is born becomes 1; an alive cell that fails
survive starts dying (→2, or →0 when S=2); dying cells age by 1 per step and
die after S-1.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .neighbourhoods import EDGES, CORNERS, get_neighbourhood
from .rules import RuleSet
from ..types import BoundaryMode

__all__ = ["AutomatonSpec"]


def _as_tuple3(arr: np.ndarray) -> tuple[tuple[int, int, int], ...]:
    return tuple(tuple(int(v) for v in row) for row in arr)


@dataclasses.dataclass(frozen=True)
class AutomatonSpec:
    grid_size: int
    offsets_main: tuple[tuple[int, int, int], ...]
    rules: RuleSet
    total_states: int = 2
    boundary: str = BoundaryMode.CLAMP_REF
    # Fixed mixed-mode groups (compute_clustered.wgsl:12-13).
    offsets_edges: tuple[tuple[int, int, int], ...] = _as_tuple3(EDGES)
    offsets_corners: tuple[tuple[int, int, int], ...] = _as_tuple3(CORNERS)

    @classmethod
    def from_config(cls, cfg) -> "AutomatonSpec":
        """Build from an :class:`~..utils.config.EngineConfig`."""
        return cls(
            grid_size=cfg.grid_size,
            offsets_main=_as_tuple3(get_neighbourhood(cfg.neighbourhood)),
            rules=cfg.ruleset(),
            total_states=cfg.total_states,
            boundary=cfg.boundary,
        )

    @classmethod
    def from_rule_strings(
        cls,
        grid_size: int,
        neighbourhood: str = "von neumann",
        born: str = "1,3",
        survive: str = "0-6",
        total_states: int = 2,
        boundary: str = BoundaryMode.CLAMP_REF,
        **mixed,
    ) -> "AutomatonSpec":
        return cls(
            grid_size=grid_size,
            offsets_main=_as_tuple3(get_neighbourhood(neighbourhood)),
            rules=RuleSet.from_strings(born=born, survive=survive, **mixed),
            total_states=total_states,
            boundary=boundary,
        )

    @property
    def groups(self):
        """((offsets, born_mask, survive_mask), ...) for main/edges/corners,
        with masks statically pruned to reachable counts (≤ #offsets)."""
        out = []
        for offs, (bm, sm) in zip(
            (self.offsets_main, self.offsets_edges, self.offsets_corners),
            self.rules.masks(),
        ):
            reach = (1 << (len(offs) + 1)) - 1  # counts 0..len(offs)
            out.append((offs, bm & reach, sm & reach))
        return tuple(out)

    @property
    def age_bits(self) -> int:
        """Bit-planes needed to store ages 0..total_states-1."""
        return max(1, (self.total_states - 1).bit_length())

    def active_groups(self):
        """Groups that can ever fire (skips disabled edges/corners groups —
        the default "27"-rule disables them, SURVEY.md §2.1)."""
        return tuple(g for g in self.groups if g[1] or g[2])
