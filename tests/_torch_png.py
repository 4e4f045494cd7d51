"""A PNG decoder for the port's encoders' output (numpy and zlib only),
shared by tests/test_torch_viewer.py and chip_smoke.py."""

import struct
import zlib

import numpy as np


def decode_png(data: bytes) -> np.ndarray:
    """An 8-bit RGB / RGBA PNG with filter 0 on every row, decoded with
    zlib: the form both encoders write.  Checks every chunk's CRC."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF, f"bad CRC in {tag!r}"
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color_type = hdr[:4]
    c = {2: 3, 6: 4}[color_type]
    assert depth == 8, f"bit depth {depth}"
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * c)
    assert (raw[:, 0] == 0).all(), "a row filter other than 0"
    return raw[:, 1:].reshape(h, w, c)
