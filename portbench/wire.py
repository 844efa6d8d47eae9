"""The serve plane's wire protocol, as a client speaks it: a frozen copy.

Copied from the port's client side (``io/serve_client.py``, the header of
``io/sockets.py``, the s16 codec of ``io/pcm.py``) so that a later change
to the port's client cannot move the yardstick. A stream is one duplex TCP
connection: the client sends the 12-byte header and interleaved PCM at the
input rate, the server answers with a header at rate * ratio and the
upsampled PCM on the same connection; a half-close flushes the final
partial block.
"""

from __future__ import annotations

import socket
import struct

import numpy as np

MAGIC = b"TOTN"
VERSION = 1
#: magic, version, format, channels, flags, rate
HEADER = struct.Struct("<4sBBBBI")
HEADER_BYTES = HEADER.size

#: wire format name -> (header code, bytes a sample)
FORMATS = {"f32": (0, 4), "s16": (1, 2)}

#: s16 conversion constants (io/pcm.py: the reference's ALSA semantics)
S16_SCALE = 32768.0
S16_CLAMP_HI = 0.9999695


def pack_header(fmt: str, channels: int, rate: int) -> bytes:
    return HEADER.pack(MAGIC, VERSION, FORMATS[fmt][0], channels, 0, rate)


def unpack_header(raw: bytes) -> tuple[int, int, int]:
    """-> (format code, channels, rate); raises on a malformed header."""
    magic, ver, code, channels, _flags, rate = HEADER.unpack(raw)
    if magic != MAGIC or ver != VERSION:
        raise ValueError(f"bad stream header {raw!r}")
    return code, channels, rate


def recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError(f"peer closed after {len(buf)}/{n} bytes")
        buf += chunk
    return bytes(buf)


def connect(host: str, port: int, fmt: str, channels: int, rate: int,
            timeout_s: float = 60.0) -> tuple[socket.socket, int]:
    """Open one stream: connect, send the header, read the server's.
    Returns (blocking socket, announced output rate)."""
    sock = socket.create_connection((host, port), timeout=timeout_s)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    try:
        sock.sendall(pack_header(fmt, channels, rate))
        code, ch, out_rate = unpack_header(recv_exact(sock, HEADER_BYTES))
    except (OSError, ValueError):
        sock.close()
        raise
    if code != FORMATS[fmt][0] or ch != channels or out_rate % rate:
        sock.close()
        raise OSError(f"server answered format {code}, {ch} channels, "
                      f"{out_rate} Hz to {fmt}, {channels}, {rate} Hz")
    return sock, out_rate


def quantize_s16(x: np.ndarray) -> np.ndarray:
    """float -> int16 values: clamp to [-1, 0.9999695], scale by 32768,
    truncate toward zero (io/pcm.float_to_pcm without dither)."""
    x = np.asarray(x, np.float32)
    clamped = np.clip(x, np.float32(-1.0), np.float32(S16_CLAMP_HI))
    return (clamped * np.float32(S16_SCALE)).astype(np.int16)


def encode(frames: np.ndarray, fmt: str) -> bytes:
    """[channels, n] float32 -> interleaved wire bytes."""
    flat = np.ascontiguousarray(np.asarray(frames, np.float32).T).reshape(-1)
    if fmt == "f32":
        return flat.astype("<f4", copy=False).tobytes()
    return quantize_s16(flat).astype("<i2", copy=False).tobytes()


def decode(raw: bytes | memoryview, fmt: str, channels: int) -> np.ndarray:
    """Interleaved wire bytes -> [n, channels] raw sample values (float32
    for f32, int16 for s16)."""
    dtype = "<f4" if fmt == "f32" else "<i2"
    return np.frombuffer(raw, dtype).reshape(-1, channels)
