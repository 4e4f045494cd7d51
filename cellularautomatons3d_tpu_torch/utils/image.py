"""Frame sinks: PNG/NPY writers (dependency-free).

Copied from ``cellularautomatons3d_tpu.utils.image`` for the port: a frame
may be a torch tensor on any device (copied to the host) or an array.  The
PNG encoder is ``native/framesink.c`` when it builds (``native.load``), else
the pure-Python writer below, as in the reference.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .. import native

__all__ = ["to_uint8", "encode_png", "write_png", "write_npy"]


def _host(img) -> np.ndarray:
    """A torch tensor (``detach().cpu()``) or an array as numpy."""
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    return np.asarray(img)


def to_uint8(img) -> np.ndarray:
    """float image in [0, 1] (H, W, 3|4) → uint8, NaN-safe (NaN → 0)."""
    a = _host(img).astype(np.float32, copy=False)
    a = np.nan_to_num(a, nan=0.0, posinf=1.0, neginf=0.0)
    return (np.clip(a, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def encode_png(img, level: int = 1) -> bytes:
    """(H, W, 3) float [0,1] or uint8 image → PNG bytes.

    Uses the native encoder when it builds (releases the GIL; C row
    filter), else the pure-Python writer below.
    """
    a = _host(img)
    if a.dtype != np.uint8:
        a = to_uint8(a)
    if a.ndim == 2:
        a = np.repeat(a[..., None], 3, axis=-1)
    framesink = native.load()[0]
    if framesink is not None and a.shape[-1] == 3:
        h, w, _ = a.shape
        return framesink.encode_png(h, w, np.ascontiguousarray(a).tobytes(), level)
    return _encode_png_py(a, level)


def write_png(path: str, img) -> None:
    """Write an (H, W, 3|4) float [0,1] or uint8 image as PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(img, level=6))


def _encode_png_py(a: np.ndarray, level: int = 6) -> bytes:
    h, w, c = a.shape
    if c == 3:
        color_type = 2
    elif c == 4:
        color_type = 6
    else:
        raise ValueError(f"unsupported channel count {c}")

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    raw = b"".join(b"\x00" + a[row].tobytes() for row in range(h))
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, level))
        + chunk(b"IEND", b"")
    )


def write_npy(path: str, img) -> None:
    np.save(path, _host(img))
