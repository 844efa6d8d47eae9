"""The load generator: one process drives a share of a cell's streams.

Started by ``run.py`` as ``python3 -m portbench.loadgen``; it reads its plan
as one JSON line on standard input, connects its streams, prints ``READY``,
reads the schedule line (``start``, ``ws``, ``we``, ``end`` on the host's
monotonic clock, which every process shares), runs the traffic in one
selector loop on one thread, counts what arrives in the window [ws, we),
and at ``end`` (``we``, or later where a traced run profiles after the
window) ends every stream's input and reads each reply to its end. Its
result goes to standard output as one pickle; its CPU share over the
window goes to standard error.

One general generator reads every traffic file (``traffic/<name>.json``):

- ``"mode": "closed"`` (bulk): each stream sends its track in bursts of
  ``burst_s`` seconds as fast as the server takes them (TCP flow control
  is the loop), while it reads its reply;
- ``"mode": "paced"`` (live): each stream sends ``period_frames`` frames
  every period on its own schedule, from a seeded phase within
  ``phase_spread_blocks`` block periods; a period is due at its scheduled
  time whether or not the one before it could be sent.

A file may also set ``clients`` (a count, or one a configuration),
``processes`` (generator processes), ``loadgen_cores`` (the machine's last
cores, which they get to themselves), ``track_s`` (a stream's length range),
``warmup_s``, ``drain_s`` (the longest wait for a reply after the input
ends) and ``capture`` (the segments kept: ``frames`` long, one every
``every_s`` seconds of output, seeded).

Every schedule runs at the configuration's input rate
(``geometry["rate"]``, its ``serve_flags.rate``): the track length, the
phase spread, a period's length, a block's due time, a burst and the
capture spacing are seconds of audio at that rate. The samples sent are
``audio.py``'s at every rate, so at another rate than ``audio.RATE`` a
tone's stated Hz scale by rate / 44100; the serve plane's work does not
depend on the content.

What a stream received is counted by arrival time; seeded segments of it
(and its first and last frames) are kept for the reference to judge.
"""

from __future__ import annotations

import fcntl
import heapq
import json
import os
import pickle
import selectors
import socket
import struct
import sys
import termios
import time

import numpy as np

from portbench import audio, wire

RECV_BYTES = 1 << 20


def pace(traffic: dict, rate: int) -> tuple[int, float]:
    """(a closed-loop burst in frames, a paced period in seconds) at
    ``rate`` frames a second."""
    return (int(traffic.get("burst_s", 1.0) * rate),
            (traffic.get("period_frames", 0) or 1) / rate)


class Stream:
    """One client stream's socket, schedule and record."""

    def __init__(self, index: int, seed: int, plan: dict) -> None:
        geo, traffic = plan["geometry"], plan["traffic"]
        self.index, self.seed = index, seed
        self.fmt = plan["wire"]
        self.channels = geo["channels"]
        self.ratio, self.rate = geo["ratio"], geo["rate"]
        self.block_in, self.block_out = geo["block_in"], geo["block_size"]
        self.in_bytes = self.channels * wire.FORMATS[self.fmt][1]
        self.out_bytes = self.in_bytes  # the reply keeps the wire format
        rng = np.random.default_rng([seed, 2])
        self.track_frames = int(rng.uniform(*traffic.get(
            "track_s", (3600.0, 3600.0))) * self.rate)
        spread = traffic.get("phase_spread_blocks", 0.0) * self.block_in
        self.phase_s = float(rng.uniform(0.0, spread / self.rate))
        self.sock: socket.socket | None = None
        self.want = selectors.EVENT_READ  # the selector's interest
        self.error: str | None = None
        # send side
        self.pending = memoryview(b"")
        self.sent_bytes = 0
        # Encoded once, before the traffic starts (set-up, not load).
        self.encoded = {k: wire.encode(audio.chunk(seed, k, self.channels),
                                       self.fmt) for k in range(audio.LOOP)}
        self.input_closed = False
        self.stop_sending = False
        # paced schedule
        self.period = int(traffic.get("period_frames", 0))
        self.next_period = 0
        self.late_s: list[float] = []
        self.period_queue: list[tuple[int, float]] = []  # (end byte, due)
        # receive side
        self.recv_bytes = 0
        self.last_recv = 0.0
        self.window_bytes = 0
        self.done = False
        self.block_arrival: list[float] = []
        self.next_block_bytes = self.block_out * self.out_bytes
        # seeded capture of output segments
        cap = plan["capture"]
        self.seg_frames = int(cap["frames"])
        every = float(cap["every_s"]) * self.rate * self.ratio
        starts, a = [0], 0.0
        horizon = self.track_frames * self.ratio
        while a < horizon and len(starts) < 4096:
            a += max(rng.uniform(0.5, 1.5) * every, 2 * self.seg_frames)
            starts.append(int(a))
        self.captures = [(s, bytearray()) for s in starts]
        self.cap_i = 0  # captures before this one are whole
        self.tail = bytearray()

    # -- input ------------------------------------------------------------

    def span_bytes(self, a: int, b: int) -> bytes:
        """Wire bytes of frames [a, b), cut from the stream's encoded
        chunks (the track loops, ``audio.LOOP``)."""
        parts = []
        while a < b:
            k = (a // audio.CHUNK) % audio.LOOP
            c0 = a // audio.CHUNK * audio.CHUNK
            e = min(b, c0 + audio.CHUNK)
            parts.append(self.encoded[k][(a - c0) * self.in_bytes:
                                         (e - c0) * self.in_bytes])
            a = e
        return b"".join(parts)

    def next_burst(self, burst_frames: int) -> None:
        """Queue the next ``burst_frames`` of the track (closed loop)."""
        sent_frames = self.sent_bytes // self.in_bytes
        stop = min(sent_frames + burst_frames, self.track_frames)
        if stop <= sent_frames:
            self.stop_sending = True
            return
        self.pending = memoryview(self.span_bytes(sent_frames, stop))

    def send_pending(self, now: float, ws: float, we: float) -> None:
        while self.pending:
            try:
                n = self.sock.send(self.pending)
            except BlockingIOError:
                return
            self.pending = self.pending[n:]
            self.sent_bytes += n
            while self.period_queue and self.period_queue[0][0] <= \
                    self.sent_bytes:
                _end, due = self.period_queue.pop(0)
                if ws <= due < we:
                    self.late_s.append(now - due)

    def close_input(self) -> None:
        if not self.input_closed:
            self.input_closed = True
            try:
                self.sock.shutdown(socket.SHUT_WR)
            except OSError:
                pass

    # -- output -----------------------------------------------------------

    def on_bytes(self, data: memoryview, now: float, ws: float,
                 we: float) -> None:
        o, n = self.recv_bytes, len(data)
        self.recv_bytes += n
        self.last_recv = now
        if ws <= now < we:
            self.window_bytes += n
        while self.recv_bytes >= self.next_block_bytes:
            self.block_arrival.append(now)
            self.next_block_bytes += self.block_out * self.out_bytes
        seg = self.seg_frames * self.out_bytes
        while self.cap_i < len(self.captures):
            start, buf = self.captures[self.cap_i]
            want = start * self.out_bytes + len(buf)  # next byte it lacks
            if want >= o + n:
                break
            buf += data[want - o:min(start * self.out_bytes + seg, o + n) - o]
            if len(buf) < seg:
                break
            self.cap_i += 1
        keep = self.seg_frames * self.out_bytes
        self.tail += data[max(0, n - keep):]
        if len(self.tail) > keep:
            del self.tail[:len(self.tail) - keep]

    def result(self, t0_sched: float, ws: float, we: float) -> dict:
        fb = self.out_bytes
        segs = {}
        for start, buf in self.captures:
            whole = len(buf) // fb * fb
            if whole:
                segs[start] = wire.decode(bytes(buf[:whole]), self.fmt,
                                          self.channels)
        recv_frames = self.recv_bytes // fb
        tail = wire.decode(bytes(self.tail[len(self.tail) % fb:]),
                           self.fmt, self.channels)
        out = dict(index=self.index, seed=self.seed, error=self.error,
                   done=self.done, sent_frames=self.sent_bytes
                   // self.in_bytes, recv_frames=recv_frames,
                   recv_tail_bytes=self.recv_bytes % fb,
                   window_samples=self.window_bytes // (fb // self.channels),
                   segments=segs, tail=(recv_frames - len(tail), tail))
        if self.period:
            # Block b is due when the period that carries its last input
            # frame was due; blocks due in the window count, arrived or not.
            due, lat = [], []
            b = 0
            while True:
                last = (b + 1) * self.block_in - 1
                d = t0_sched + self.phase_s + (last // self.period) \
                    * self.period / self.rate
                if d >= we:
                    break
                if d >= ws:
                    due.append(d)
                    lat.append(self.block_arrival[b] - d
                               if b < len(self.block_arrival) else np.inf)
                b += 1
            out.update(block_due=np.asarray(due), block_lat_s=np.asarray(lat),
                       late_s=np.asarray(self.late_s))
        return out


def _block_percentile_ms(streams: list[dict], q: float) -> float | None:
    """The ``q``-th percentile of the latency of every block due in the
    window (``Stream.result``), in ms; a block that never came counts as
    1e3 s, later than any limit. None where no block was due."""
    lat = np.concatenate([s["block_lat_s"] for s in streams])
    if lat.size == 0:
        return None
    return float(np.percentile(np.where(np.isinf(lat), 1e3, lat), q) * 1e3)


def block_p95_ms(streams: list[dict]) -> float | None:
    """The 95th percentile of the window's block latency, in ms."""
    return _block_percentile_ms(streams, 95)


def block_p50_ms(streams: list[dict]) -> float | None:
    """The median of the window's block latency, in ms."""
    return _block_percentile_ms(streams, 50)


def socket_queues(sock: socket.socket) -> str:
    """Bytes waiting in a socket's receive and send queues."""
    out = []
    for name, req in (("unread", termios.FIONREAD),
                      ("unsent", termios.TIOCOUTQ)):
        try:
            buf = fcntl.ioctl(sock.fileno(), req, b"\0\0\0\0")
            out.append(f"{name} {struct.unpack('i', buf)[0]}")
        except OSError as e:
            out.append(f"{name} ? ({e})")
    return ", ".join(out)


def run(plan: dict, schedule_in) -> list[dict]:
    traffic = plan["traffic"]
    mode = traffic["mode"]
    if mode not in ("closed", "paced"):
        raise ValueError(f"unknown traffic mode {mode!r}")
    cores = plan.get("cores")
    if cores:
        os.sched_setaffinity(0, cores)
    streams = [Stream(i, s, plan) for i, s in zip(plan["indices"],
                                                  plan["seeds"])]
    geo = plan["geometry"]
    for st in streams:
        st.sock, _rate = wire.connect(plan["host"], plan["port"], st.fmt,
                                      st.channels, geo["rate"])
        st.sock.setblocking(False)
    print("READY", flush=True)
    sched = json.loads(schedule_in.readline())
    start, ws, we = sched["start"], sched["ws"], sched["we"]
    end = sched.get("end", we)  # input ends here; the window counts to we
    drain_until = end + float(plan.get("drain_s", 60.0))
    sel = selectors.DefaultSelector()
    for st in streams:
        sel.register(st.sock, selectors.EVENT_READ, st)
    burst, period_s = pace(traffic, geo["rate"])
    heap = [(start + st.phase_s, i) for i, st in enumerate(streams)]
    heapq.heapify(heap)
    rbuf = bytearray(RECV_BYTES)
    view = memoryview(rbuf)

    def feed(st: Stream, now: float) -> None:
        """Send what the stream has to send; refill a closed-loop stream's
        burst; end its input once it has stopped; keep its write interest
        only while bytes are pending."""
        while True:
            if st.pending:
                st.send_pending(now, ws, we)
            if st.pending or mode != "closed" or st.stop_sending:
                break
            st.next_burst(burst)
        if st.stop_sending and not st.pending:
            st.close_input()
        want = selectors.EVENT_READ | (selectors.EVENT_WRITE
                                       if st.pending else 0)
        if st.want != want:
            sel.modify(st.sock, want, st)
            st.want = want

    while time.monotonic() < start:
        time.sleep(min(0.01, max(0.0, start - time.monotonic())))
    cpu0 = os.times()
    wall0 = time.monotonic()
    cpu1 = None
    if mode == "closed":
        for st in streams:
            feed(st, wall0)
    stopped = False
    live = len(streams)
    while live:
        now = time.monotonic()
        if now >= drain_until:
            for st in streams:
                if not st.done:
                    st.error = st.error or (
                        f"reply not finished at the drain limit: sent "
                        f"{st.sent_bytes} bytes ({len(st.pending)} pending, "
                        f"input closed {st.input_closed}), received "
                        f"{st.recv_bytes}, last {now - st.last_recv:.1f} s "
                        f"before the limit; socket "
                        + (socket_queues(st.sock) if st.sock else "closed"))
            break
        if mode == "paced" and not stopped:
            while heap and heap[0][0] <= min(now, end):
                due, i = heapq.heappop(heap)
                st = streams[i]
                if st.error is None and due < end and st.sock is not None:
                    data = st.span_bytes(st.next_period * st.period,
                                         (st.next_period + 1) * st.period)
                    st.next_period += 1
                    st.period_queue.append((st.sent_bytes + len(st.pending)
                                            + len(data), due))
                    st.pending = memoryview(bytes(st.pending) + data)
                    feed(st, now)
                    heapq.heappush(heap, (due + period_s, i))
        if cpu1 is None and now >= we:
            cpu1 = (os.times(), now)
        if not stopped and now >= end:
            stopped = True
            for st in streams:
                if st.sock is None:
                    continue
                st.stop_sending = True
                if mode == "closed":
                    # A burst cut here still ends on a whole frame.
                    rem = st.sent_bytes % st.in_bytes
                    st.pending = st.pending[:(st.in_bytes - rem)
                                            % st.in_bytes]
                feed(st, now)
        timeout = 0.05
        if mode == "paced" and heap and not stopped:
            timeout = max(0.0, min(timeout, heap[0][0] - now))
        if not stopped:
            timeout = max(0.0, min(timeout, (we if cpu1 is None else end)
                                   - now))
        for key, mask in sel.select(timeout):
            st = key.data
            now = time.monotonic()
            if mask & selectors.EVENT_WRITE:
                feed(st, now)
            if mask & selectors.EVENT_READ:
                try:
                    n = st.sock.recv_into(rbuf)
                except BlockingIOError:
                    continue
                except OSError as e:
                    st.error, n = f"recv: {e}", 0
                if n:
                    st.on_bytes(view[:n], now, ws, we)
                    continue
                st.done = st.input_closed and st.error is None
                if not st.done and st.error is None:
                    st.error = ("server closed the stream before its "
                                "input ended")
                sel.unregister(st.sock)
                st.sock.close()
                st.sock = None
                live -= 1
    if cpu1 is None:
        cpu1 = (os.times(), time.monotonic())
    t1, w1 = cpu1
    used = (t1.user + t1.system) - (cpu0.user + cpu0.system)
    print(f"loadgen {plan['name']}: {len(streams)} streams, cpu share "
          f"{used / max(w1 - wall0, 1e-9):.3f} of one core over the window",
          file=sys.stderr, flush=True)
    for st in streams:
        if st.sock is not None:
            st.sock.close()
    return [st.result(start, ws, we) for st in streams]


def main() -> int:
    plan = json.loads(sys.stdin.readline())
    results = run(plan, sys.stdin)
    out = sys.stdout.buffer
    out.write(pickle.dumps(results, protocol=pickle.HIGHEST_PROTOCOL))
    out.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
