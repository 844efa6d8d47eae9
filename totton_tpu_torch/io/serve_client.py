"""Client side of the totton-serve wire protocol.

totton-serve (totton_tpu/serve.py) speaks one duplex connection per
stream: the client sends the 12-byte totton header (+ an optional
per-stream Equalizer-APO EQ block) followed by interleaved PCM at the
serve rate, and reads the upsampled stream back at rate*ratio on the
same socket. Until now only the tests and benches spoke it, each with a
hand-rolled pump; this module is the supported consumer surface — a
small synchronous library class plus the full-duplex pump used by the
totton-serve-client CLI.

The reference has no serving plane to consume (its streamer is
one-process-per-stream over ALSA, src/alsa/alsa_streamer_main.cpp);
this client is the access path to the rebuild's multi-stream tier.

Usage (library)::

    with ServeClient("tcp://dsp-host:9100", channels=2, rate=44100) as c:
        y = c.upsample(x)          # [2, n] float32 -> [2, n*ratio]

or incrementally: ``send()`` / ``end_input()`` on the write side while
``read_frames()`` drains the read side (a slow reader throttles itself
via the server's per-stream backpressure — never other streams).
"""

from __future__ import annotations

import socket
import struct
import threading

import numpy as np

from totton_tpu_torch.io.pcm import (
    PcmFormat,
    bytes_per_sample,
    float_to_pcm,
    interleave,
    pcm_to_float,
)
from totton_tpu_torch.io.sockets import (
    FLAG_EQ_BLOCK,
    HEADER_BYTES,
    SocketSpec,
    _connect,
    _recv_exact,
    _tune,
    pack_header,
    unpack_header,
)

#: default frames per sendall in the streaming pump — small enough that
#: the server's adaptive depth sees a steady trickle, large enough that
#: syscall overhead is negligible
DEFAULT_CHUNK_FRAMES = 4096


class ServeClient:
    """One upsampling stream against a running totton-serve.

    Connects, performs the header (+ optional EQ block) handshake, and
    exposes the duplex stream: float [channels, n] frames in, upsampled
    float [channels, n*ratio] frames out. ``fmt=None`` is the lossless
    float32 wire format; s16/s24/s32 round-trip through the server's
    bit-exact PCM conversions (and s16 is required by --device-pcm
    servers).
    """

    def __init__(self, server: str, channels: int, rate: int,
                 fmt: PcmFormat | None = None,
                 eq_text: str | None = None,
                 timeout_s: float = 120.0,
                 connect_window_s: float = 10.0) -> None:
        spec = SocketSpec(server)
        if spec.listen:
            raise ValueError(
                f"{server!r} is a listen spec; the client connects "
                "(tcp://host:port or unix:/path)")
        if rate <= 0:
            raise ValueError(f"rate must be a positive sample rate: {rate}")
        self.channels = channels
        self.rate = rate
        self.fmt = fmt
        self._frame_in = channels * (4 if fmt is None
                                     else bytes_per_sample(fmt))
        self.sock = _connect(spec, connect_window_s)
        _tune(self.sock, spec)
        self.sock.settimeout(timeout_s)
        try:
            flags = FLAG_EQ_BLOCK if eq_text is not None else 0
            self.sock.sendall(pack_header(fmt, channels, rate, flags=flags))
            if eq_text is not None:
                raw = eq_text.encode("utf-8")
                self.sock.sendall(struct.pack("<I", len(raw)) + raw)
            rfmt, rch, rrate = unpack_header(
                _recv_exact(self.sock, HEADER_BYTES))
        except (OSError, ValueError):
            self.sock.close()
            raise
        if (rfmt, rch) != (fmt, channels):
            self.sock.close()
            raise OSError(
                f"server answered fmt={rfmt} channels={rch}, "
                f"requested fmt={fmt} channels={channels}")
        if rrate <= 0 or rrate % rate:
            self.sock.close()
            raise OSError(
                f"server announced output rate {rrate}, not a positive "
                f"multiple of the requested rate {rate}")
        #: the upsampled output rate the server announced (rate * ratio)
        self.output_rate = rrate
        self.ratio = rrate // rate
        self._rbuf = bytearray()
        self._eof = False

    # -- write side -------------------------------------------------------

    def send(self, frames: np.ndarray) -> None:
        """Send [channels, n] float frames (blocks under backpressure)."""
        if frames.shape[0] != self.channels:
            raise ValueError(
                f"expected {self.channels} channels, got {frames.shape[0]}")
        flat = interleave(np.asarray(frames, np.float32))
        if self.fmt is None:
            self.sock.sendall(flat.astype("<f4").tobytes())
        else:
            self.sock.sendall(float_to_pcm(flat, self.fmt))

    def end_input(self) -> None:
        """Half-close: no more input; the server flushes the final
        partial block zero-padded/trimmed and closes after the tail."""
        try:
            self.sock.shutdown(socket.SHUT_WR)
        except OSError:
            pass

    # -- read side --------------------------------------------------------

    def read_frames(self) -> np.ndarray | None:
        """Next chunk of upsampled [channels, m] frames (m varies with
        what the server has queued), or None at end of stream."""
        while True:
            whole = len(self._rbuf) // self._frame_in * self._frame_in
            if whole:
                raw = bytes(self._rbuf[:whole])
                del self._rbuf[:whole]
                return self._decode(raw)
            if self._eof:
                if self._rbuf:
                    raise OSError(
                        f"{len(self._rbuf)} trailing bytes are not a "
                        "whole frame")
                return None
            got = self.sock.recv(65536)
            if not got:
                self._eof = True
                continue
            self._rbuf += got

    def _decode(self, raw: bytes) -> np.ndarray:
        if self.fmt is None:
            flat = np.frombuffer(raw, "<f4").astype(np.float32)
        else:
            flat = pcm_to_float(raw, self.fmt)
        return flat.reshape(-1, self.channels).T

    # -- whole-signal convenience ----------------------------------------

    def upsample(self, x: np.ndarray,
                 chunk_frames: int = DEFAULT_CHUNK_FRAMES) -> np.ndarray:
        """Full round trip: stream [channels, n] through the server and
        return the complete [channels, ~n*ratio] output. The write side
        pumps from a thread so server backpressure can never deadlock
        against an unread output backlog."""
        err: list[BaseException] = []

        def pump() -> None:
            try:
                for i in range(0, x.shape[1], chunk_frames):
                    self.send(x[:, i:i + chunk_frames])
                self.end_input()
            except BaseException as e:  # surfaced after the read loop
                err.append(e)

        t = threading.Thread(target=pump, name="serve-client-pump")
        t.start()
        parts = []
        try:
            while (y := self.read_frames()) is not None:
                parts.append(y)
        finally:
            t.join()
        if err:
            raise err[0]
        return (np.concatenate(parts, axis=1) if parts
                else np.zeros((self.channels, 0), np.float32))

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def __enter__(self) -> "ServeClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
