"""Rule strings, rule sets and LUT packing for totalistic CA rules.

The rule surface matches the reference's rule compiler
(main_pathtraced.js:554-622):

* A rule *string* is a comma list of neighbour counts and inclusive ranges,
  e.g. ``"1,3"`` or ``"0-6,9"``.  Every value is clamped to 26 (the Moore
  maximum); unparsable components are silently skipped (the reference writes
  to index ``NaN`` of a typed array, which is a no-op).
* A :class:`RuleSet` holds three (born, survive) pairs — one per
  neighbourhood *group*: the configurable main group, plus the fixed edges
  and corners groups of the mixed-neighbourhood mode
  (compute_clustered.wgsl:17-18,224-232).
* For device consumption the rules are packed two ways:
  - ``lut_arrays()``: two ``uint32[81]`` dense LUTs with the three groups at
    offsets 0/27/54, byte-identical to the reference's storage buffers
    (main_pathtraced.js:155-159,583-617).
  - ``masks()``: six 27-bit Python ints (bit *c* set ⇔ count *c* matches) —
    the TPU-native form consumed by the bit-sliced step kernels, where rules
    are static trace-time constants (restart-bound parameters trigger a
    recompile, mirroring the reference's applyOnRestart split).
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

from .neighbourhoods import NEIGHBOURS_STORAGE_LEN, MAX_NEIGHBOURS

__all__ = [
    "parse_rule_string",
    "RuleSet",
    "counts_to_mask",
    "mask_to_counts",
    "counts_to_string",
]

_INT_RE = re.compile(r"^[+-]?\d+")


def _parse_int(s: str) -> int | None:
    """JS ``parseInt(s, 10)`` semantics: leading integer prefix or None."""
    m = _INT_RE.match(s)
    return int(m.group(0)) if m else None


def parse_rule_string(rules: str) -> list[int]:
    """Parse a rule string into a list of neighbour counts.

    Mirrors ``_rulesComponentsToValues`` (main_pathtraced.js:554-581):
    whitespace stripped, comma-separated components, ``a-b`` inclusive
    ranges, every emitted value clamped to 26.  Unparsable components are
    skipped (reference: NaN index write is a typed-array no-op).
    """
    result: list[int] = []
    rules = rules.replace(" ", "")
    for comp in rules.split(","):
        if "-" in comp:
            # Any '-' triggers range mode (reference: indexOf("-") > -1); a
            # NaN endpoint (e.g. "-5" → start NaN) yields an empty range.
            parts = comp.split("-")
            lo, hi = _parse_int(parts[0]), _parse_int(parts[1])
            if lo is None or hi is None:
                continue
            for v in range(lo, hi + 1):
                result.append(min(v, MAX_NEIGHBOURS))
        else:
            v = _parse_int(comp)
            if v is None:
                continue
            result.append(min(v, MAX_NEIGHBOURS))
    return result


def counts_to_mask(counts) -> int:
    """Neighbour-count list → 27-bit membership mask (negatives dropped)."""
    m = 0
    for c in counts:
        if 0 <= c <= MAX_NEIGHBOURS:
            m |= 1 << c
    return m


def mask_to_counts(mask: int) -> tuple[int, ...]:
    return tuple(c for c in range(NEIGHBOURS_STORAGE_LEN) if (mask >> c) & 1)


def counts_to_string(counts) -> str:
    """Canonical rule string for a count set: sorted, deduplicated, with
    runs of ≥ 3 consecutive counts collapsed to ``a-b`` ranges.

    The inverse of :func:`parse_rule_string` up to membership:
    ``set(parse_rule_string(counts_to_string(c))) == set(c)`` for any
    in-range counts.  (The reference has no exporter — rule state only
    flows strings → LUTs; this closes the round trip for checkpoints and
    the viewer.)
    """
    cs = sorted({c for c in counts if 0 <= c <= MAX_NEIGHBOURS})
    if not cs:
        return ""
    parts: list[str] = []
    run_start = prev = cs[0]
    for c in cs[1:] + [None]:
        if c is not None and c == prev + 1:
            prev = c
            continue
        if prev - run_start >= 2:
            parts.append(f"{run_start}-{prev}")
        elif prev != run_start:
            parts.extend([str(run_start), str(prev)])
        else:
            parts.append(str(run_start))
        if c is not None:
            run_start = prev = c
    return ",".join(parts)


@dataclasses.dataclass(frozen=True)
class RuleSet:
    """Born/survive counts for the main + edges + corners rule groups.

    ``born``/``survive`` etc. are tuples of allowed neighbour counts
    (deduplicated membership; totalistic rules only care about membership).
    The default edges/corners strings are ``"27"`` which clamps to count 26 —
    unreachable for 12-/8-cell neighbourhoods, i.e. disabled
    (main_pathtraced.js:129-132, SURVEY.md §2.1).
    """

    born: tuple[int, ...]
    survive: tuple[int, ...]
    born_edges: tuple[int, ...] = (26,)
    survive_edges: tuple[int, ...] = (26,)
    born_corners: tuple[int, ...] = (26,)
    survive_corners: tuple[int, ...] = (26,)

    @classmethod
    def from_strings(
        cls,
        born: str = "1,3",
        survive: str = "0-6",
        born_edges: str = "27",
        survive_edges: str = "27",
        born_corners: str = "27",
        survive_corners: str = "27",
    ) -> "RuleSet":
        """Build from reference-syntax rule strings (defaults =
        main_pathtraced.js:124-132)."""
        return cls(
            born=tuple(parse_rule_string(born)),
            survive=tuple(parse_rule_string(survive)),
            born_edges=tuple(parse_rule_string(born_edges)),
            survive_edges=tuple(parse_rule_string(survive_edges)),
            born_corners=tuple(parse_rule_string(born_corners)),
            survive_corners=tuple(parse_rule_string(survive_corners)),
        )

    # --- group accessors -------------------------------------------------
    @property
    def groups(self):
        """((born, survive), ...) for main/edges/corners, as count tuples."""
        return (
            (self.born, self.survive),
            (self.born_edges, self.survive_edges),
            (self.born_corners, self.survive_corners),
        )

    def masks(self) -> tuple[tuple[int, int], ...]:
        """((born_mask, survive_mask), ...) 27-bit ints per group."""
        return tuple(
            (counts_to_mask(b), counts_to_mask(s)) for b, s in self.groups
        )

    # --- reference-format dense LUTs -------------------------------------
    def lut_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """(born, survive) as ``uint32[81]`` with groups at offsets 0/27/54,
        matching the reference's storage-buffer layout
        (main_pathtraced.js:155-159,597-617, compute_clustered.wgsl:17-18).
        """
        born = np.zeros(NEIGHBOURS_STORAGE_LEN * 3, dtype=np.uint32)
        survive = np.zeros_like(born)
        for g, (b_counts, s_counts) in enumerate(self.groups):
            off = g * NEIGHBOURS_STORAGE_LEN
            for c in b_counts:
                if 0 <= c <= MAX_NEIGHBOURS:
                    born[c + off] = 1
            for c in s_counts:
                if 0 <= c <= MAX_NEIGHBOURS:
                    survive[c + off] = 1
        return born, survive

    def to_strings(self) -> dict[str, str]:
        """Canonical rule strings per group (the LUT→string round trip):
        ``RuleSet.from_strings(**rs.to_strings())`` has identical masks."""
        return {
            "born": counts_to_string(self.born),
            "survive": counts_to_string(self.survive),
            "born_edges": counts_to_string(self.born_edges),
            "survive_edges": counts_to_string(self.survive_edges),
            "born_corners": counts_to_string(self.born_corners),
            "survive_corners": counts_to_string(self.survive_corners),
        }

    @classmethod
    def from_luts(cls, born: np.ndarray, survive: np.ndarray) -> "RuleSet":
        """Rebuild a RuleSet from the reference-format ``uint32[81]`` LUT
        pair (inverse of :meth:`lut_arrays`)."""
        L = NEIGHBOURS_STORAGE_LEN

        def grp(a, g):
            seg = np.asarray(a)[g * L : (g + 1) * L]
            return tuple(int(c) for c in np.nonzero(seg)[0])

        return cls(
            born=grp(born, 0),
            survive=grp(survive, 0),
            born_edges=grp(born, 1),
            survive_edges=grp(survive, 1),
            born_corners=grp(born, 2),
            survive_corners=grp(survive, 2),
        )

    def mixed_groups_active(self) -> bool:
        """True when the edges/corners groups can ever fire (count ≤ 12/8)."""
        eb, es = counts_to_mask(self.born_edges), counts_to_mask(self.survive_edges)
        cb, cs = counts_to_mask(self.born_corners), counts_to_mask(self.survive_corners)
        edge_reach = (1 << 13) - 1      # edges group counts 0..12
        corner_reach = (1 << 9) - 1     # corners group counts 0..8
        return bool((eb | es) & edge_reach or (cb | cs) & corner_reach)
