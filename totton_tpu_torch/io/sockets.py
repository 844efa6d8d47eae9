"""Network audio transport: PCM streaming over TCP / unix-domain sockets.

The reference's live loop talks to ALSA hardware on both ends
(src/alsa/alsa_streamer_main.cpp:495-611). On a TPU host audio arrives over
the network; this module is the live-device analog: a framed PCM stream on
a stream socket, usable as `--in` / `--out` endpoints of totton-stream:

  totton-stream --in tcp-listen://:9000 --out tcp://dac-host:9001 --ratio 16

Spec grammar (both sources and sinks accept all four):
  tcp://host:port          active connect
  tcp-listen://[host]:port bind + accept ONE peer (host defaults 0.0.0.0)
  unix:/path               active connect (unix domain)
  unix-listen:/path        bind + accept ONE peer

Wire format: one 12-byte header sent by the AUDIO-SENDING side (whichever
end writes samples — independent of who initiated the connection), then an
endless interleaved sample stream:

  magic  b"TOTN"          4 bytes
  version u8 = 1
  format  u8              0 = float32 LE, 1 = S16_LE, 2 = S24_3LE, 3 = S32_LE
  channels u8
  flags   u8              reserved, 0
  rate    u32 LE          input sample rate in Hz

float32 (format 0) is the lossless chaining format between totton processes
(no quantization at process boundaries); the integer formats carry the
bit-exact PCM conversions of io/pcm.py (reference alsa_common semantics).

Semantics match the file/pipe endpoints: sources are low-latency (the
stream session dispatches block-at-a-time and pre-compiles its shapes,
io/stream.py _warm_up), reads block until at least one whole frame or EOF,
writes block on TCP backpressure (never drop), a closed peer is EOF on the
source side and a clean stop on the sink side.
"""

from __future__ import annotations

import logging
import os
import socket
import struct
import time

import numpy as np

log = logging.getLogger("totton.sockets")

from totton_tpu_torch.io.devices import (
    AudioSink,
    AudioSource,
    SinkCapability,
    SinkClosedError,
)
from totton_tpu_torch.io.pcm import (
    PcmFormat,
    TpdfDitherer,
    deinterleave,
    float_to_pcm,
    interleave,
    pcm_to_float,
)

MAGIC = b"TOTN"
VERSION = 1
HEADER = struct.Struct("<4sBBBBI")  # magic, ver, fmt, channels, flags, rate
HEADER_BYTES = HEADER.size

#: wire format codes <-> sample formats (None = raw float32)
_FMT_CODE: dict[PcmFormat | None, int] = {
    None: 0,
    PcmFormat.S16_LE: 1,
    PcmFormat.S24_3LE: 2,
    PcmFormat.S32_LE: 3,
}
_CODE_FMT = {v: k for k, v in _FMT_CODE.items()}

#: default connect retry window (seconds) — the peer process may still be
#: starting up (its first JAX compile can take a while on a cold cache)
CONNECT_TIMEOUT_S = float(os.environ.get("TOTTON_SOCKET_CONNECT_TIMEOUT", 30))
#: default accept window for listening endpoints
ACCEPT_TIMEOUT_S = float(os.environ.get("TOTTON_SOCKET_ACCEPT_TIMEOUT", 300))


#: header flag bit: an EQ block (u32 LE length + UTF-8 Equalizer-APO
#: text) follows the header — per-stream EQ for totton-serve clients.
FLAG_EQ_BLOCK = 0x01


def pack_header(fmt: PcmFormat | None, channels: int, rate: int,
                flags: int = 0) -> bytes:
    if channels < 1 or channels > 255:
        raise ValueError(f"channels out of range: {channels}")
    return HEADER.pack(MAGIC, VERSION, _FMT_CODE[fmt], channels, flags, rate)


def header_flags(raw: bytes) -> int:
    """The header's flag byte (unpack_header keeps its 3-tuple shape for
    the many existing callers)."""
    return HEADER.unpack(raw)[4]


def unpack_header(raw: bytes) -> tuple[PcmFormat | None, int, int]:
    """-> (fmt or None for float32, channels, rate)."""
    magic, ver, code, channels, _flags, rate = HEADER.unpack(raw)
    if magic != MAGIC:
        raise ValueError(f"bad stream magic {magic!r} (want {MAGIC!r})")
    if ver != VERSION:
        raise ValueError(f"unsupported stream version {ver}")
    if code not in _CODE_FMT:
        raise ValueError(f"unknown wire format code {code}")
    if channels < 1:
        raise ValueError("zero-channel stream")
    return _CODE_FMT[code], channels, rate


class SocketSpec:
    """Parsed socket endpoint spec."""

    def __init__(self, spec: str) -> None:
        self.raw = spec
        if spec.startswith("tcp-listen://"):
            self.family, self.listen = socket.AF_INET, True
            hostport = spec[len("tcp-listen://"):]
        elif spec.startswith("tcp://"):
            self.family, self.listen = socket.AF_INET, False
            hostport = spec[len("tcp://"):]
        elif spec.startswith("unix-listen:"):
            self.family, self.listen = socket.AF_UNIX, True
            self.path = spec[len("unix-listen:"):]
            return
        elif spec.startswith("unix:"):
            self.family, self.listen = socket.AF_UNIX, False
            self.path = spec[len("unix:"):]
            return
        else:
            raise ValueError(f"not a socket spec: {spec}")
        if hostport.startswith("["):
            # Bracketed IPv6 literal: tcp://[::1]:9000.
            end = hostport.find("]")
            if end < 0 or not hostport[end + 1:].startswith(":"):
                raise ValueError(f"socket spec needs [v6-host]:port - {spec}")
            host, port = hostport[1:end], hostport[end + 2:]
        else:
            host, sep, port = hostport.rpartition(":")
            if not sep:
                raise ValueError(f"socket spec needs host:port - {spec}")
        if not port.isdigit():
            raise ValueError(f"socket spec needs host:port - {spec}")
        if ":" in host:
            self.family = socket.AF_INET6
        self.host = host or ("0.0.0.0" if self.listen else "127.0.0.1")
        self.port = int(port)

    @staticmethod
    def matches(spec: str) -> bool:
        return spec.startswith(("tcp://", "tcp-listen://", "unix:",
                                "unix-listen:"))


def _listen(spec: SocketSpec, backlog: int = 1) -> socket.socket:
    """Bound listening socket. backlog=1 suits the single-peer
    source/sink endpoints; multi-client servers (totton-serve) pass
    their concurrency so a connect burst isn't refused."""
    if spec.family == socket.AF_UNIX:
        try:
            os.unlink(spec.path)
        except FileNotFoundError:
            pass
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        srv.bind(spec.path)
    else:
        srv = socket.socket(spec.family, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((spec.host, spec.port))
    srv.listen(backlog)
    return srv


def _connect(spec: SocketSpec, timeout_s: float) -> socket.socket:
    """Connect with retries: the peer may still be binding/compiling."""
    deadline = time.monotonic() + timeout_s
    last: Exception | None = None
    while time.monotonic() < deadline:
        try:
            if spec.family == socket.AF_UNIX:
                sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                sock.connect(spec.path)
            else:
                sock = socket.create_connection((spec.host, spec.port),
                                                timeout=timeout_s)
            return sock
        except OSError as e:
            last = e
            time.sleep(0.1)
    raise OSError(f"cannot connect to {spec.raw} within {timeout_s}s: {last}")


def _open(spec: SocketSpec, timeout_s: float) -> socket.socket:
    if not spec.listen:
        sock = _connect(spec, timeout_s)
    else:
        srv = _listen(spec)
        srv.settimeout(ACCEPT_TIMEOUT_S)
        try:
            sock, _addr = srv.accept()
        finally:
            srv.close()
            if spec.family == socket.AF_UNIX:
                try:
                    os.unlink(spec.path)
                except FileNotFoundError:
                    pass
    _tune(sock, spec)
    return sock


def _tune(sock: socket.socket, spec: SocketSpec) -> None:
    if spec.family in (socket.AF_INET, socket.AF_INET6):
        # Audio frames are small and latency-sensitive.
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    sock.settimeout(None)


def _error_string(e: OSError) -> str:
    """Uniform transport-fault description (type + errno + message) used
    by source and sink fault accounting alike."""
    errno_ = getattr(e, "errno", None)
    return (f"{type(e).__name__}"
            + (f" (errno {errno_})" if errno_ else "")
            + (f": {e}" if str(e) else ""))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError(
                f"peer closed during header ({len(buf)}/{n} bytes)")
        buf += chunk
    return bytes(buf)


class SocketSource(AudioSource):
    """Framed PCM stream socket as a capture endpoint.

    The header fixes format/channels/rate, so the CLI needs no --rate for
    socket input. Live transport: low_latency=True makes the stream
    session pre-compile its dispatch shapes and dispatch block-at-a-time
    (io/stream.py), exactly like a stdin pipe. Backpressures via TCP flow
    control, never drops.

    Fault semantics (the network analog of the reference's ALSA XRUN
    recovery loop, src/alsa/alsa_common.cpp:269-336): an orderly FIN is
    EOF; a mid-stream RST / NIC error is a TRANSPORT ERROR — counted in
    ``transport_errors``, errno logged, recorded in ``last_error`` so the
    session can report it and the CLI can exit nonzero instead of folding
    the fault into a clean stop. ``reconnect_window_s`` (listen-mode only)
    opts into sender-restart recovery: after a disconnect the source waits
    up to that long for a NEW peer whose header matches the original
    format/channels/rate exactly, splices its samples into the stream
    (``reconnects`` counts successes), and only reports EOF when the
    window expires.
    """

    low_latency = True

    def __init__(self, spec: str,
                 connect_timeout_s: float = CONNECT_TIMEOUT_S,
                 reconnect_window_s: float = 0.0) -> None:
        self._spec = SocketSpec(spec)
        self._reconnect_s = float(reconnect_window_s)
        self.transport_errors = 0
        self.reconnects = 0
        self.last_error: str | None = None
        self._srv: socket.socket | None = None
        if self._reconnect_s > 0 and not self._spec.listen:
            raise ValueError(
                "reconnect_window_s needs a listen-mode source "
                f"(tcp-listen:// or unix-listen:), got {spec!r}")
        if self._reconnect_s > 0:
            # Keep the server socket open so a restarted sender can come
            # back; the single-shot path closes it after the first accept.
            self._srv = _listen(self._spec)
            self._srv.settimeout(ACCEPT_TIMEOUT_S)
            self._sock, _addr = self._srv.accept()
            _tune(self._sock, self._spec)
        else:
            self._sock = _open(self._spec, connect_timeout_s)
        self._fmt, self.channels, rate = unpack_header(
            _recv_exact(self._sock, HEADER_BYTES))
        self.sample_rate = rate or None
        self._frame_bytes = self.channels * (
            4 if self._fmt is None else self._fmt.bytes)
        self._buf = bytearray()
        self._eof = False

    def _note_error(self, e: OSError) -> None:
        self.transport_errors += 1
        self.last_error = _error_string(e)
        log.warning("socket source %s transport error: %s",
                    self._spec.raw, self.last_error)

    def _try_reconnect(self) -> bool:
        """Wait for a restarted sender (listen-mode, opt-in). A new peer
        must present an IDENTICAL header — a different format/channels/
        rate mid-stream would silently corrupt the signal chain."""
        if self._srv is None:
            return False
        # A disconnect can land mid-frame; drop the partial tail so the
        # splice stays frame-aligned (whole buffered frames are kept).
        self._buf = self._buf[:len(self._buf)
                              - len(self._buf) % self._frame_bytes]
        self._srv.settimeout(self._reconnect_s)
        try:
            peer, _addr = self._srv.accept()
        except (socket.timeout, OSError):
            log.warning("socket source %s: no sender within the %.1fs "
                        "reconnect window", self._spec.raw, self._reconnect_s)
            return False
        try:
            _tune(peer, self._spec)
            fmt, channels, rate = unpack_header(
                _recv_exact(peer, HEADER_BYTES))
        except (OSError, ValueError, ConnectionError) as e:
            peer.close()
            self._note_error(e if isinstance(e, OSError)
                             else OSError(str(e)))
            return False
        if (fmt, channels, rate or None) != (
                self._fmt, self.channels, self.sample_rate):
            peer.close()
            self.last_error = (
                f"reconnect header mismatch: got (fmt={fmt}, ch={channels}, "
                f"rate={rate}), stream is (fmt={self._fmt}, "
                f"ch={self.channels}, rate={self.sample_rate})")
            self.transport_errors += 1
            log.warning("socket source %s: %s", self._spec.raw,
                        self.last_error)
            return False
        try:
            self._sock.close()
        except OSError:
            pass
        self._sock = peer
        self.reconnects += 1
        log.info("socket source %s: sender reconnected (#%d)",
                 self._spec.raw, self.reconnects)
        return True

    def read_frames(self, n: int) -> np.ndarray:
        """Blocks until >= 1 whole frame is buffered (or EOF); returns at
        most n frames — whatever arrived, for low latency."""
        want = n * self._frame_bytes
        while not self._eof and len(self._buf) < self._frame_bytes:
            try:
                chunk = self._sock.recv(max(want - len(self._buf), 65536))
            except OSError as e:
                self._note_error(e)
                chunk = b""
            if not chunk:
                if self._try_reconnect():
                    continue
                self._eof = True
                break
            self._buf += chunk
        usable = min(len(self._buf), want)
        usable -= usable % self._frame_bytes
        if usable == 0:
            return np.zeros((self.channels, 0), dtype=np.float32)
        raw, self._buf = bytes(self._buf[:usable]), self._buf[usable:]
        if self._fmt is None:
            samples = np.frombuffer(raw, dtype="<f4").astype(np.float32)
        else:
            samples = pcm_to_float(raw, self._fmt)
        return deinterleave(samples, self.channels)

    def close(self) -> None:
        for s in (self._sock, self._srv):
            if s is None:
                continue
            try:
                s.close()
            except OSError:
                pass
        if self._srv is not None and self._spec.family == socket.AF_UNIX:
            try:
                os.unlink(self._spec.path)
            except FileNotFoundError:
                pass


class SocketSink(AudioSink):
    """Framed PCM stream socket as a playback endpoint.

    The header is written lazily on the first write_frames (channel count
    comes from the audio). sendall blocks on TCP backpressure — the
    session's output-ring semantics treat that as healthy flow control.
    """

    def __init__(self, spec: str, sample_rate: int,
                 fmt: PcmFormat | None = PcmFormat.S32_LE,
                 ditherer: TpdfDitherer | None = None,
                 connect_timeout_s: float = CONNECT_TIMEOUT_S) -> None:
        self._spec = SocketSpec(spec)
        self._sock = _open(self._spec, connect_timeout_s)
        self._rate = sample_rate
        self._fmt = fmt
        self._ditherer = ditherer
        self._header_sent = False
        self.capability = SinkCapability.unconstrained("socket")
        self.transport_errors = 0
        self.last_error: str | None = None

    def _sendall(self, raw: bytes) -> None:
        """The docstring contract 'a closed peer is a clean stop on the
        sink side': an orderly departure (BrokenPipe after the peer's FIN)
        surfaces as SinkClosedError, which stream sessions treat like
        source EOF (drain + exit cleanly). A connection RESET or other
        socket error is counted as a transport error first (errno logged)
        so stats and exit codes can distinguish a crash from a departure.
        """
        try:
            self._sock.sendall(raw)
        except BrokenPipeError as e:
            raise SinkClosedError(f"socket peer closed: {e}") from e
        except OSError as e:
            self.transport_errors += 1
            self.last_error = _error_string(e)
            log.warning("socket sink %s transport error: %s",
                        self._spec.raw, self.last_error)
            raise SinkClosedError(
                f"socket transport error: {self.last_error}") from e

    def write_frames(self, x: np.ndarray) -> None:
        x = np.atleast_2d(x)
        if not self._header_sent:
            self._sendall(pack_header(self._fmt, x.shape[0], self._rate))
            self._header_sent = True
        flat = interleave(x)
        if self._fmt is None:
            raw = flat.astype("<f4", copy=False).tobytes()
        else:
            raw = float_to_pcm(flat, self._fmt, self._ditherer)
        self._sendall(raw)

    def write_quantized(self, x: np.ndarray) -> None:
        if self._fmt is not PcmFormat.S16_LE:
            super().write_quantized(x)
            return
        x = np.atleast_2d(x)
        if not self._header_sent:
            self._sendall(pack_header(self._fmt, x.shape[0], self._rate))
            self._header_sent = True
        self._sendall(interleave(x).astype("<i2").tobytes())

    def close(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_WR)  # EOF for the peer
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
