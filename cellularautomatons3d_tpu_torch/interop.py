"""Carry state between the JAX package and the port.

The JAX package keeps packed words as ``uint32[W, Z, Y]`` (for a
multi-state rule the age bit-planes ``uint32[B, W, Z, Y]``) and its fast
history as ``FastHistory(color f16 [H, W, 3], hit_idx i32 [H, W])``; the
port keeps the words as ``torch.int32`` with the same bits, in the same
shape.  Both functions
work on numpy values (``np.asarray`` of a JAX array is one), so this module
needs no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .render.renderer_fast import FastHistory

__all__ = ["from_reference", "to_reference"]


def from_reference(value, device="cpu"):
    """The JAX package's value → the port's, on ``device``.

    * packed ``uint32`` words of any shape (a binary state ``[W, Z, Y]``,
      age planes ``[B, W, Z, Y]``) → ``torch.int32`` tensor, same bits and
      shape;
    * anything with ``color`` and ``hit_idx`` (its ``FastHistory``) → the
      port's :class:`FastHistory` (f16 color, int32 ids).
    """
    if hasattr(value, "color") and hasattr(value, "hit_idx"):
        color = np.asarray(value.color)
        hit_idx = np.asarray(value.hit_idx)
        if color.dtype != np.float16 or hit_idx.dtype != np.int32:
            raise TypeError(
                f"expected f16 color / int32 ids, got {color.dtype} / {hit_idx.dtype}"
            )
        return FastHistory(
            color=torch.from_numpy(color.copy()).to(device),
            hit_idx=torch.from_numpy(hit_idx.copy()).to(device),
        )
    words = np.asarray(value)
    if words.dtype != np.uint32:
        raise TypeError(f"expected uint32 packed words, got {words.dtype}")
    return torch.from_numpy(words.view(np.int32).copy()).to(device)


def to_reference(value):
    """The port's value → the JAX package's numpy form: a packed tensor
    (binary state or age planes) to ``uint32`` words of the same shape, a :class:`FastHistory` to a ``(color, hit_idx)`` pair
    of numpy arrays (``FastHistory(*pair)`` in the JAX package)."""
    if isinstance(value, FastHistory):
        return (
            value.color.detach().cpu().numpy(),
            value.hit_idx.detach().cpu().numpy(),
        )
    if value.dtype != torch.int32:
        raise TypeError(f"expected int32 packed words, got {value.dtype}")
    return value.detach().cpu().numpy().view(np.uint32)
