"""Carry state between the JAX package and the port.

The JAX package keeps packed words as ``uint32[W, Z, Y]`` (for a
multi-state rule the age bit-planes ``uint32[B, W, Z, Y]``), its fast
history as ``FastHistory(color f16 [H, W, 3], hit_idx i32 [H, W])`` and the
reference pipeline's as ``RenderHistory(color f16 [H, W, 4], depth f16 [H,
W, 2])``, and the reference pipeline's per-frame operands as the NamedTuple
``RenderParams`` of float32 arrays; the port keeps the words as
``torch.int32`` with the same bits, in the same shape, both histories with
the same fields, and ``RenderParams`` as float32 numpy values.  Both functions
work on numpy values (``np.asarray`` of a JAX array is one, a mesh Engine's
sharded state included), so this module needs no JAX.  With a ``mesh``,
:func:`from_reference` gives the port's :class:`~.parallel.sharded.Sharded`
values (the state through ``shard_state``, histories split by rows), and
:func:`to_reference` gathers them.
"""

from __future__ import annotations

import numpy as np
import torch

from .parallel.sharded import place_rows, shard_state, to_numpy
from .render.renderer import RenderHistory, RenderParams
from .render.renderer_fast import FastHistory

__all__ = ["from_reference", "to_reference"]


def from_reference(value, device="cuda", mesh=None):
    """The JAX package's value → the port's, on ``device`` (the card unless
    the caller asks for the CPU), or sharded over ``mesh`` (a
    :class:`~.parallel.sharded.Mesh`: packed words along Z (and Y), the
    histories by rows, as the mesh Engine holds them).

    * packed ``uint32`` words of any shape (a binary state ``[W, Z, Y]``,
      age planes ``[B, W, Z, Y]``) → ``torch.int32`` tensor, same bits and
      shape;
    * anything with ``color`` and ``hit_idx`` (its ``FastHistory``) → the
      port's :class:`FastHistory` (f16 color, int32 ids);
    * anything with ``color`` and ``depth`` (its ``RenderHistory``) → the
      port's :class:`RenderHistory` (f16 color and depth);
    * anything whose ``_fields`` are those of the port's
      :class:`RenderParams` (its ``RenderParams``) → the port's, each field
      a float32 numpy value of the same shape and bits (host values: neither
      ``device`` nor ``mesh`` applies).
    """
    if tuple(getattr(value, "_fields", ())) == RenderParams._fields:
        return RenderParams(*_f32_fields(value))
    if hasattr(value, "color") and hasattr(value, "depth"):
        color, depth = np.asarray(value.color), np.asarray(value.depth)
        if color.dtype != np.float16 or depth.dtype != np.float16:
            raise TypeError(
                f"expected f16 color / depth, got {color.dtype} / {depth.dtype}"
            )
        return place_rows(RenderHistory(torch.from_numpy(color.copy()),
                                        torch.from_numpy(depth.copy())), device, mesh)
    if hasattr(value, "color") and hasattr(value, "hit_idx"):
        color = np.asarray(value.color)
        hit_idx = np.asarray(value.hit_idx)
        if color.dtype != np.float16 or hit_idx.dtype != np.int32:
            raise TypeError(
                f"expected f16 color / int32 ids, got {color.dtype} / {hit_idx.dtype}"
            )
        return place_rows(FastHistory(torch.from_numpy(color.copy()),
                                      torch.from_numpy(hit_idx.copy())), device, mesh)
    words = np.asarray(value)
    if words.dtype != np.uint32:
        raise TypeError(f"expected uint32 packed words, got {words.dtype}")
    words = torch.from_numpy(words.view(np.int32).copy())
    return words.to(device) if mesh is None else shard_state(words, mesh)


def to_reference(value):
    """The port's value → the JAX package's numpy form: a packed tensor
    (binary state or age planes) to ``uint32`` words of the same shape, a
    :class:`FastHistory` to a ``(color, hit_idx)`` pair of numpy arrays
    (``FastHistory(*pair)`` in the JAX package), a :class:`RenderHistory`
    to a ``(color, depth)`` pair (``RenderHistory(*pair)`` there), a
    :class:`RenderParams` to a tuple of its float32 fields
    (``RenderParams(*fields)`` there); a sharded value is gathered first."""
    if isinstance(value, RenderParams):
        return _f32_fields(value)
    if isinstance(value, (RenderHistory, FastHistory)):
        return tuple(to_numpy(t) for t in value)
    if value.dtype != torch.int32:
        raise TypeError(f"expected int32 packed words, got {value.dtype}")
    return to_numpy(value).view(np.uint32)


def _f32_fields(params) -> tuple:
    """Copies of a ``RenderParams``' fields as float32 numpy values, each of
    its own shape; raises ``TypeError`` naming a field of another type."""
    fields = tuple(np.array(v, copy=True) for v in params)
    for name, v in zip(RenderParams._fields, fields):
        if v.dtype != np.float32:
            raise TypeError(f"expected float32 RenderParams.{name}, got {v.dtype}")
    return fields
