"""Dependency-free shared types."""

from __future__ import annotations

__all__ = ["BoundaryMode"]


class BoundaryMode:
    """How neighbour lookups behave at the grid boundary.

    * ``CLAMP_REF`` — the reference's clustered-shader semantics
      (compute_clustered.wgsl:104): the bounds check is ``0 <= c <= N``
      *inclusive* of N, and coordinate N then wraps to 0 inside
      ``getCellState`` (compute_clustered.wgsl:56-66).  Net effect: negative
      neighbour coords contribute 0, while coords at the far edge read
      row/plane 0 (a one-sided wrap).  This is the active default.
    * ``WRAP`` — full toroidal wrap, the non-clustered shader's behaviour
      (compute.wgsl:17-28; exact for power-of-two sizes, which the grid-size
      snap guarantees).
    * ``CLAMP`` — clean zero boundary on both sides (no aliasing); offered
      as the sane non-quirky option.
    """

    CLAMP_REF = "clamp_ref"
    WRAP = "wrap"
    CLAMP = "clamp"

    ALL = (CLAMP_REF, WRAP, CLAMP)
