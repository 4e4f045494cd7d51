"""Named rule presets covering the reference defaults and BASELINE configs.

Rule notation for 3D "Life-like" CA is conventionally
``survive / born / states / neighbourhood``.  The presets below cover:

* the reference's shipped default (B1,3 / S0-6 / von Neumann,
  main_pathtraced.js:123-125) and its commented-out Conway 2D config
  (main_pathtraced.js:126-128);
* the known-answer rules kept in the reference's comments
  (compute.wgsl:103-154): Conway's Life, 4/4/4/M, 0-6/1,3/2/VN;
* BASELINE.json configs: "Amoeba" (config 1 names rule 4/4/5),
  a Clouds-style multi-state decay rule (config 2), and the classic
  445 / Pyroclastic / Builder community rules for demos.
"""

from __future__ import annotations

__all__ = ["PRESETS", "preset_config"]

# name → dict of EngineConfig overrides
PRESETS: dict[str, dict] = {
    # Reference shipped default (main_pathtraced.js:123-125).
    "reference-default": dict(
        neighbourhood="von neumann", born="1,3", survive="0-6", total_states=2
    ),
    # Conway's Game of Life on one z-slice (main_pathtraced.js:126-128).
    "conway-2d": dict(
        neighbourhood="moore 2D", born="3", survive="2,3", total_states=2
    ),
    # 4/4/4/M from the reference's comments (compute.wgsl:120-132).
    "444m": dict(neighbourhood="moore", born="4", survive="4", total_states=2),
    # BASELINE config 1: rule 4/4/5 "Amoeba" (S4/B4/5 states, Moore).
    "amoeba-445": dict(
        neighbourhood="moore", born="4", survive="4", total_states=5
    ),
    # Classic community rules (capability demos for multi-state decay):
    # Clouds 1: 13-26/13-14,17-19/2/M
    "clouds": dict(
        neighbourhood="moore", born="13,14,17-19", survive="13-26", total_states=2
    ),
    # Clouds with fading ages (BASELINE config 2 description).
    "clouds-decay": dict(
        neighbourhood="moore", born="13,14,17-19", survive="13-26", total_states=8
    ),
    # 445: 4/4/5/M (same as amoeba-445, community name).
    "445": dict(neighbourhood="moore", born="4", survive="4", total_states=5),
    # Pyroclastic: 4-7/6-8/10/M
    "pyroclastic": dict(
        neighbourhood="moore", born="6-8", survive="4-7", total_states=10
    ),
    # Builder: 2,6,9/4,6,8-9/10/M
    "builder": dict(
        neighbourhood="moore", born="4,6,8-9", survive="2,6,9", total_states=10
    ),
    # Crystal growth: 0-6/1,3/2/VN (compute.wgsl:134-154) — same as default.
    "crystal-vn": dict(
        neighbourhood="von neumann", born="1,3", survive="0-6", total_states=2
    ),
}


def preset_config(name: str, **overrides):
    """Build an :class:`~..utils.config.EngineConfig` from a preset plus
    overrides."""
    from ..utils.config import EngineConfig  # deferred: avoids import cycle
    try:
        base = dict(PRESETS[name])
    except KeyError:
        raise ValueError(
            f"unknown preset {name!r}; expected one of {sorted(PRESETS)}"
        ) from None
    base.update(overrides)
    return EngineConfig(**base)
