"""The serve plane's host spans over a window, and what they reduce to.

The program records its spans (``totton_tpu_torch.utils.profiling.Spans``,
``StreamServer.spans``: ``Spans.snapshot()``) on ``perf_counter_ns``,
CLOCK_MONOTONIC, the clock of a profiler window's bounds and of the
marker kernel it launches (``trace.py``). ``device_window`` maps a
window's device records onto that clock by the marker, so every span
lines up with the device's busy intervals. ``SpanWindow`` clips the spans
to a window and gives each name's wall, CPU and self time, the
dispatcher's innermost span at each instant, and the share of the device's
idle time that falls in each (``idle_by_span``).

A metric reader (``metrics/<name>.py``) reads ``ctx["spans"]``, a
snapshot, and ``ctx["trace"]``, the chosen window: ``bounds_ns`` (host),
``before`` and ``after`` (the counter snapshots at its ends, with the
block latency histogram under ``block_latency``), and where the device
was traced, ``busy_ns`` (host clock) and ``kernels``. A run without
spans (a program that has none) gives None, and so does every reader.
"""

from __future__ import annotations

import bisect

import numpy as np

#: the spans over which the dispatcher was ready to work (its own host
#: work), and the child of one of them that is a wait
HOST_WORK = ("serve.gather", "serve.enqueue", "serve.housekeeping",
             "serve.drain")
HOST_WAIT = "serve.drain_wait"
#: a frame kernel's records and the copy each step ends with, for the
#: stream-order reading of the quantize (trace.FRAME_KERNELS)
FRAME_KERNELS = ("fft_resident", "fft_stage")
DTOH = "Memcpy DtoH"
#: names of the runtime calls that launch a kernel
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel")
#: the most the marker's launch may trail its host time for the clock
#: offset to be trusted over it (``device_window``)
MARK_DELAY_NS = 50_000_000
NONE = "none"


def _union(intervals):
    merged: list[list[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _overlap(xs, ys):
    """Pairs of (overlap length, label) of two sorted lists of disjoint
    intervals, the second labelled: [(a, b)] and [(a, b, label)]."""
    out = []
    i = j = 0
    while i < len(xs) and j < len(ys):
        a = max(xs[i][0], ys[j][0])
        b = min(xs[i][1], ys[j][1])
        if b > a:
            out.append((b - a, ys[j][2]))
        if xs[i][1] <= ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def device_window(w: dict) -> dict | None:
    """A raw profiler window (``trace.take_windows``) on the host's clock:
    ``offset_ns`` (trace ns = host ns + offset), ``bounds_ns``, ``busy_ns``
    (the union of the kernel, copy and memset intervals, clipped to the
    window) and ``kernels``: (name, start, end, launch) for every device
    record in it, ``launch`` the host time of its runtime launch record
    (matched by correlation id) or None where the window kept none.

    The trace's clock is the profiler's wall clock (Unix ns). Where the
    window's first counter snapshot carries ``clock_offset_ns``
    (``time.time_ns() - time.perf_counter_ns()`` read back to back) and
    the marker agrees with it, that is the offset (``offset_from``
    "clock"): exact to a microsecond, where the marker's launch trails its
    host time by the Python dispatch of one op, and by a wait for the GIL
    on a busy host (``marker_delay_ns``). Else the marker's runtime launch
    record ("launch"), else the marker kernel's start, a few us later
    still ("kernel"). None where the
    marker's record is missing."""
    from torch.autograd import DeviceType

    events = w["prof"].profiler.kineto_results.events()
    device, launches = [], {}
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            device.append((e.name(), e.start_ns(),
                           e.start_ns() + e.duration_ns(), e.correlation_id()))
        elif e.name().startswith(LAUNCH_CALLS):
            launches[e.correlation_id()] = e.start_ns()
    marks = sorted(a for n, a, _b, _c in device if "FillFunctor" in n)
    others = sorted(a for n, a, _b, _c in device if "FillFunctor" not in n)
    if not marks or not others:
        return None
    lone_first = marks[0] < others[len(others) // 2]
    which = 0 if len(marks) == 2 or lone_first else 1
    mark_launch = next((launches[c] for n, a, _b, c in device
                        if a == marks[0] and "FillFunctor" in n
                        and c in launches), None)
    offset_from = "kernel" if mark_launch is None else "launch"
    offset = (marks[0] if mark_launch is None else mark_launch) \
        - int(round(w["marks"][which] * 1e9))
    clock = w.get("before", {}).get("clock_offset_ns")
    delay = None if clock is None else offset - clock
    if delay is not None and -MARK_DELAY_NS < delay < MARK_DELAY_NS:
        offset, offset_from = clock, "clock"
    lo = int(round(w["t0"] * 1e9))
    hi = int(round(w["t1"] * 1e9))
    kernels = []
    for n, a, b, c in device:
        a, b = a - offset, b - offset
        if "FillFunctor" in n or b <= lo or a >= hi:
            continue
        launch = launches.get(c)
        kernels.append((n, max(a, lo), min(b, hi),
                        None if launch is None else launch - offset))
    kernels.sort(key=lambda k: k[1])
    return dict(offset_ns=offset, offset_from=offset_from,
                marker_delay_ns=delay, bounds_ns=(lo, hi),
                busy_ns=_union([(a, b) for _n, a, b, _l in kernels]),
                kernels=kernels, launch_records=len(launches))


class SpanWindow:
    """A spans snapshot clipped to the window [lo, hi] (host ns)."""

    def __init__(self, snap: dict, lo: int, hi: int, steps: int,
                 blocks: float, busy=None, kernels=None) -> None:
        self.lo, self.hi = lo, hi
        self.steps, self.blocks = steps, blocks
        self.busy, self.kernels = busy, kernels
        self.name = np.asarray(snap["names"], dtype=object)[snap["name"]]
        t0 = np.clip(snap["t0"], lo, hi)
        t1 = np.clip(snap["t1"], lo, hi)
        full = snap["t1"] - snap["t0"]
        self.t0, self.t1 = t0, t1
        self.wall = t1 - t0
        # A span cut by the window keeps the share of its CPU time that
        # its wall time inside has.
        share = np.divide(self.wall, full, out=np.zeros(full.size),
                          where=full > 0)
        self.cpu = snap["cpu"] * share
        self.tid = snap["tid"]
        self.num, self.parent = snap["num"], snap["parent"]

    def total(self, name: str) -> float:
        """Summed wall ns of the spans named ``name`` inside the window."""
        return float(self.wall[self.name == name].sum())

    def cpu_total(self, name: str) -> float:
        return float(self.cpu[self.name == name].sum())

    def count(self, name: str) -> int:
        return int(((self.name == name) & (self.wall > 0)).sum())

    def self_time(self) -> dict[str, float]:
        """Each name's wall ns less the part its child spans cover."""
        inside = self.wall > 0
        by_num = dict(zip(self.num.tolist(), range(self.num.size)))
        child = np.zeros(self.num.size)
        for i in np.flatnonzero(inside & (self.parent >= 0)):
            p = by_num.get(int(self.parent[i]))
            if p is not None:
                child[p] += self.wall[i]
        out: dict[str, float] = {}
        for i in np.flatnonzero(inside):
            out[self.name[i]] = out.get(self.name[i], 0.0) \
                + float(self.wall[i] - child[i])
        return out

    def per_step_ms(self) -> dict[str, float]:
        """Each name's wall time a step in the window, ms."""
        if not self.steps:
            return {}
        return {n: self.total(n) / self.steps / 1e6
                for n in sorted(set(self.name.tolist()))}

    def dispatcher_segments(self) -> list[tuple[int, int, str]]:
        """The window cut where the dispatcher's innermost span changes:
        (start, end, name), ``NONE`` outside every span. The dispatcher is
        the thread that recorded serve.gather; its spans nest."""
        tids = self.tid[self.name == "serve.gather"]
        if tids.size == 0:
            return [(self.lo, self.hi, NONE)]
        values, counts = np.unique(tids, return_counts=True)
        tid = values[counts.argmax()]
        mine = np.flatnonzero((self.tid == tid) & (self.wall > 0))
        order = sorted(mine, key=lambda i: (self.t0[i], -self.t1[i]))
        out, stack, cur = [], [], self.lo

        def close_until(t):
            nonlocal cur
            while stack and stack[-1][0] <= t:
                end, label = stack.pop()
                if end > cur:
                    out.append((cur, end, label))
                    cur = end

        for i in order:
            a, b = int(self.t0[i]), int(self.t1[i])
            close_until(a)
            if a > cur:
                out.append((cur, a, stack[-1][1] if stack else NONE))
                cur = a
            stack.append((b, self.name[i]))
        close_until(self.hi)
        if cur < self.hi:
            out.append((cur, self.hi, NONE))
        return out

    def idle_intervals(self) -> list[tuple[int, int]] | None:
        """The window less the device's busy intervals; None where the
        device was not traced."""
        if self.busy is None:
            return None
        edges = [self.lo]
        for a, b in self.busy:
            edges += [max(a, self.lo), min(b, self.hi)]
        edges.append(self.hi)
        return [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]

    def idle_by_span(self) -> dict[str, float] | None:
        """The device's idle ns by the dispatcher's innermost span at the
        time (``NONE`` outside every span); None untraced."""
        idle = self.idle_intervals()
        if idle is None:
            return None
        out: dict[str, float] = {}
        for length, label in _overlap(idle, self.dispatcher_segments()):
            out[label] = out.get(label, 0.0) + length
        return out

    def quantize_ns_per_step(self, method: str | None = None
                             ) -> tuple[float, str, dict] | None:
        """The device time of the quantize's kernels a step, how they were
        found, and their count by name: ``correlation`` (kernels whose
        runtime launch record falls inside a serve.quantize span; the
        default where the window kept launch records) or ``stream order``
        (the kernels between a step's last frame-kernel record and its
        DtoH copy). None where the device was not traced or nothing
        quantized."""
        if self.kernels is None:
            return None
        spans = sorted((int(self.t0[i]), int(self.t1[i]))
                       for i in np.flatnonzero((self.name == "serve.quantize")
                                               & (self.wall > 0)))
        if not spans:
            return None
        if method is None:
            method = ("correlation" if any(k[3] is not None
                                           for k in self.kernels)
                      else "stream order")
        total, found = 0.0, {}
        if method == "correlation":
            starts = [a for a, _b in spans]
            for name, a, b, launch in self.kernels:
                if launch is None:
                    continue
                j = bisect.bisect_right(starts, launch) - 1
                if j >= 0 and launch <= spans[j][1]:
                    total += b - a
                    found[name] = found.get(name, 0) + 1
            return total / len(spans), method, found
        steps, after_frame, pending, names = 0, False, 0.0, []
        for name, a, b, _launch in self.kernels:
            if any(k in name for k in FRAME_KERNELS):
                after_frame, pending, names = True, 0.0, []
            elif name.startswith(DTOH):
                if after_frame:
                    total += pending
                    steps += 1
                    for n in names:
                        found[n] = found.get(n, 0) + 1
                after_frame = False
            elif after_frame and not name.startswith(("Memcpy", "Memset")):
                pending += b - a
                names.append(name)
        if not steps:
            return None
        return total / steps, method, found


def window_of(ctx: dict) -> SpanWindow | None:
    """The SpanWindow of a run's chosen window, made once and kept in
    ``ctx``; None without spans or a window."""
    if "_span_window" in ctx:
        return ctx["_span_window"]
    snap, t = ctx.get("spans"), ctx.get("trace")
    win = None
    if snap is not None and t is not None and "bounds_ns" in t:
        lo, hi = t["bounds_ns"]
        c = ctx["config"]
        blocks = (t["after"]["frames_out"] - t["before"]["frames_out"]) \
            / c["block_size"]
        win = SpanWindow(snap, lo, hi, t["after"]["steps"]
                         - t["before"]["steps"], blocks,
                         t.get("busy_ns"), t.get("kernels"))
    ctx["_span_window"] = win
    return win


def latency_delta(ctx: dict) -> list[int] | None:
    """The block latency histogram's counts over the window, or None
    where the snapshots carry none."""
    t = ctx.get("trace")
    if t is None or "block_latency" not in t.get("before", {}):
        return None
    a, b = t["before"]["block_latency"], t["after"]["block_latency"]
    if not a or len(a) != len(b):
        return None
    return [y - x for x, y in zip(a, b)]
