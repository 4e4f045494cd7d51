from .neighbourhoods import (
    NEIGHBOURHOOD_MAP,
    EDGES,
    CORNERS,
    MOORE,
    MOORE_2D,
    VON_NEUMANN,
    VON_NEUMANN_2D,
    get_neighbourhood,
)
from .rules import RuleSet, parse_rule_string, counts_to_mask, mask_to_counts
from .automaton import AutomatonSpec
from .presets import PRESETS, preset_config

__all__ = [
    "NEIGHBOURHOOD_MAP",
    "EDGES",
    "CORNERS",
    "MOORE",
    "MOORE_2D",
    "VON_NEUMANN",
    "VON_NEUMANN_2D",
    "get_neighbourhood",
    "RuleSet",
    "parse_rule_string",
    "counts_to_mask",
    "mask_to_counts",
    "AutomatonSpec",
    "PRESETS",
    "preset_config",
]
