"""Minimal RFC 6455 WebSocket support for the viewer (stdlib only).

Copied from ``cellularautomatons3d_tpu.viewer.ws``.  The reference runs in
a browser and repaints a canvas every rAF; this module upgrades the
viewer's HTTP server to a WebSocket push stream: binary messages carry PNG
frames, text messages carry JSON status; client → server text messages
carry the same input payloads as POST /input.  Server→client frames are
unmasked (per spec), client frames are unmasked on receipt; ping/pong and
close are handled.
"""

from __future__ import annotations

import base64
import hashlib
import json
import struct

__all__ = ["accept_key", "handshake", "send_frame", "recv_message"]

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT, OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG = 0, 1, 2, 8, 9, 10


def accept_key(client_key: str) -> str:
    digest = hashlib.sha1((client_key + _GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def handshake(handler) -> bool:
    """Upgrade an http.server request to a WebSocket.  Returns success."""
    key = handler.headers.get("Sec-WebSocket-Key")
    if not key or handler.headers.get("Upgrade", "").lower() != "websocket":
        return False
    handler.send_response(101, "Switching Protocols")
    handler.send_header("Upgrade", "websocket")
    handler.send_header("Connection", "Upgrade")
    handler.send_header("Sec-WebSocket-Accept", accept_key(key))
    handler.end_headers()
    handler.wfile.flush()
    return True


def send_frame(sock_file, payload: bytes, opcode: int = OP_BINARY) -> None:
    """Write one unmasked server→client frame."""
    n = len(payload)
    header = bytearray([0x80 | opcode])
    if n < 126:
        header.append(n)
    elif n < 1 << 16:
        header.append(126)
        header += struct.pack(">H", n)
    else:
        header.append(127)
        header += struct.pack(">Q", n)
    sock_file.write(bytes(header) + payload)
    sock_file.flush()


def send_text(sock_file, obj) -> None:
    send_frame(sock_file, json.dumps(obj).encode(), OP_TEXT)


def recv_message(rfile):
    """Read one client frame → (opcode, payload) or (None, b"") on EOF.

    Client frames are always masked (RFC 6455 §5.1); fragmented control
    flow is not needed for the viewer's tiny JSON inputs, but continuation
    frames are concatenated for robustness.
    """
    parts = []
    opcode = None
    while True:
        head = rfile.read(2)
        if len(head) < 2:
            return None, b""
        fin = head[0] & 0x80
        op = head[0] & 0x0F
        masked = head[1] & 0x80
        ln = head[1] & 0x7F
        if ln == 126:
            ln = struct.unpack(">H", rfile.read(2))[0]
        elif ln == 127:
            ln = struct.unpack(">Q", rfile.read(8))[0]
        mask = rfile.read(4) if masked else b"\x00" * 4
        data = rfile.read(ln)
        if masked:
            data = bytes(b ^ mask[i % 4] for i, b in enumerate(data))
        if opcode is None:
            opcode = op
        parts.append(data)
        if fin:
            return opcode, b"".join(parts)
