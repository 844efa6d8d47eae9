"""Per-block timing, host spans and device tracing: a copy of
``totton_tpu/utils/profiling.py``.

``BlockTimer`` is a cheap wall-clock accumulator with percentile summaries
that wraps each device dispatch in the stream sessions. ``trace_context``
wraps ``torch.profiler`` where the reference wraps ``jax.profiler.trace``.
``Spans`` records named host intervals of the serve plane's threads
(``serve.StreamServer.spans``) and writes them as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import threading
import time

import numpy as np

log = logging.getLogger(__name__)

#: Added to the file name of a trace whose CUDA window kept kernel
#: launches but no kernel record (``check_kernel_records``).
NO_KERNEL_SUFFIX = "_no_kernel_records"


class BlockTimer:
    """Accumulates per-dispatch wall-clock timings."""

    def __init__(self, capacity: int = 4096) -> None:
        self._times = np.zeros(capacity, dtype=np.float64)
        self._n = 0

    @contextlib.contextmanager
    def measure(self):
        t0 = time.monotonic()
        yield
        dt = time.monotonic() - t0
        if self._n < len(self._times):
            self._times[self._n] = dt
        else:  # ring: overwrite oldest
            self._times[self._n % len(self._times)] = dt
        self._n += 1

    @property
    def count(self) -> int:
        return self._n

    def summary(self) -> dict:
        n = min(self._n, len(self._times))
        if n == 0:
            return {"count": 0}
        t = self._times[:n] * 1e3
        return {
            "count": self._n,
            "mean_ms": float(np.mean(t)),
            "p50_ms": float(np.percentile(t, 50)),
            "p95_ms": float(np.percentile(t, 95)),
            "p99_ms": float(np.percentile(t, 99)),
            "max_ms": float(np.max(t)),
        }


@contextlib.contextmanager
def trace_context(trace_dir: str | None = None):
    """torch.profiler wrapper; no-op when no directory is configured.

    Enable via argument or the TOTTON_TRACE_DIR environment variable. It
    records CPU activity, plus CUDA activity (kernel launches and their
    device time) where CUDA is present, and writes one Chrome trace
    (``trace_<pid>_<ns>.json``) into the directory; open it in Perfetto
    or chrome://tracing. A trace that kept launches but no kernel record
    is marked (``check_kernel_records``).
    """
    trace_dir = trace_dir or os.environ.get("TOTTON_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir,
                        f"trace_{os.getpid()}_{time.monotonic_ns()}.json")
    prof.export_chrome_trace(path)
    if ProfilerActivity.CUDA in activities:
        check_kernel_records(path)


def check_kernel_records(path: str) -> str:
    """Count a Chrome trace's kernel launches (CUDA runtime or driver
    events named ``*LaunchKernel*``) and kernel records (category
    ``kernel``). A trace that kept launches but no kernel record says so:
    a top-level ``"tottonKernelRecords"`` entry with both counts, the
    file renamed with ``NO_KERNEL_SUFFIX``, and a logged warning.
    torch.profiler drops device records whose timestamps fall outside its
    window; late in a process (on an H100 with torch 2.11.0+cu128, after
    about two minutes) the device timestamps of some windows land beyond
    any margin around it, and the window keeps every launch and no
    kernel. Returns the trace's path, renamed or not."""
    with open(path) as f:
        trace = json.load(f)
    events = trace.get("traceEvents", [])
    launches = sum(1 for ev in events
                   if ev.get("cat") in ("cuda_runtime", "cuda_driver")
                   and "LaunchKernel" in str(ev.get("name", "")))
    kernels = sum(1 for ev in events if ev.get("cat") == "kernel")
    if launches == 0 or kernels > 0:
        return path
    trace["tottonKernelRecords"] = {
        "launches": launches, "kernel_records": 0,
        "note": "the profiler kept the launches but no kernel record: "
                "device times are missing from this trace"}
    root, ext = os.path.splitext(path)
    marked = root + NO_KERNEL_SUFFIX + ext
    with open(marked, "w") as f:
        json.dump(trace, f)
    os.remove(path)
    log.warning("trace %s kept %d kernel launches but no kernel record; "
                "written as %s", path, launches, marked)
    return marked


class Spans:
    """Named host intervals (spans) from any thread, kept in a ring of
    preallocated arrays whose capacity is fixed at construction.

    A record holds the span's name (an id into ``names``), its start and
    end from ``time.perf_counter_ns()``, the thread CPU time used inside
    it (a ``time.thread_time_ns()`` delta), the number of the record that
    encloses it on the same thread (its parent, -1 for none), the
    thread's id, and two integers of the caller's: ``key`` (the serve
    plane's step number, or a reader's or writer's slot index) and
    ``gen`` (the slot's generation; -1 where there is none). Records are
    numbered in the order they open. Where the thread CPU clock is coarse
    (under gVisor it steps by 10 ms), a span's ``cpu`` is a sample, true
    only summed over many spans.

    Clock: ``perf_counter_ns`` reads CLOCK_MONOTONIC on Linux, the clock
    of ``time.perf_counter()`` and ``time.monotonic()``. The benchmark's
    profiler windows (``portbench/trace.py``) launch a marker kernel at a
    ``perf_counter`` time, so one offset maps every span onto the device
    trace.

    Off by default; ``start()`` and ``stop()`` switch it at run time. A
    site tests ``on`` and opens nothing while it is false, so it reads no
    clock and allocates nothing::

        tok = spans.open("serve.gather", step) if spans.on else -1
        ...
        spans.close(tok)

    Where more records open than the ring holds, the oldest are
    overwritten and counted in ``dropped``, never lost silently.

    Marks (``mark``) are one-off named intervals kept apart from the ring:
    the server's start phases (``serve.setup.*``). They are recorded
    whether or not ``on`` is set, until ``end_marks()``; ``start()``
    keeps them, and ``snapshot()`` and ``write_chrome`` give them beside
    the records.
    """

    def __init__(self, capacity: int = 1 << 18) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1: {capacity}")
        self.on = False
        self.capacity = capacity
        #: interned names; a record's name is an index into this list
        self.names: list[str] = []
        self._ids: dict[str, int] = {}
        self._lock = threading.Lock()
        # next() on itertools.count is atomic under the GIL: each record
        # gets its own number, and so its own ring slot, from any thread.
        self._seq = itertools.count()
        self._first = 0
        self._num = np.full(capacity, -1, np.int64)
        self._name = np.zeros(capacity, np.int32)
        self._t0 = np.zeros(capacity, np.int64)
        self._t1 = np.zeros(capacity, np.int64)
        self._cpu = np.zeros(capacity, np.int64)
        self._parent = np.zeros(capacity, np.int64)
        self._key = np.zeros(capacity, np.int64)
        self._gen = np.zeros(capacity, np.int64)
        self._tid = np.zeros(capacity, np.int64)
        # A site writes through memoryviews of the arrays: a third of the
        # cost of numpy's own item assignment.
        self._w = {k: memoryview(getattr(self, "_" + k))
                   for k in ("num", "name", "t0", "t1", "cpu", "parent",
                             "key", "gen", "tid")}
        #: whether ``mark`` records (until ``end_marks()``)
        self.marking = True
        self._marks: list[tuple] = []

    def start(self) -> None:
        """Record from now on; records from before are forgotten."""
        self._first = next(self._seq) + 1
        self.on = True

    def stop(self) -> None:
        """Open no more spans (those open now still close)."""
        self.on = False

    def _intern(self, name: str) -> int:
        i = self._ids.get(name)
        if i is None:
            with self._lock:
                i = self._ids.get(name)
                if i is None:
                    i = len(self.names)
                    self.names.append(name)
                    self._ids[name] = i
        return i

    def open(self, name: str, key: int = -1, gen: int = -1,
             parent: int = -1) -> int:
        """Open a span on this thread; returns its record number, which
        ``close`` takes."""
        n = next(self._seq)
        s = n % self.capacity
        w = self._w
        w["num"][s] = n
        w["name"][s] = self._intern(name)
        w["parent"][s] = parent
        w["key"][s] = key
        w["gen"][s] = gen
        w["tid"][s] = threading.get_ident()
        w["t1"][s] = 0
        # The CPU interval lies inside the wall interval: cpu <= wall.
        w["t0"][s] = time.perf_counter_ns()
        w["cpu"][s] = time.thread_time_ns()
        return n

    def close(self, n: int) -> None:
        """Close record ``n``; nothing for a negative ``n`` (a site that
        opened nothing) or a record the ring has overwritten."""
        if n < 0:
            return
        cpu = time.thread_time_ns()
        t1 = time.perf_counter_ns()
        s = n % self.capacity
        w = self._w
        if w["num"][s] == n:
            w["t1"][s] = t1
            w["cpu"][s] = cpu - w["cpu"][s]

    def add(self, name: str, t0: int, t1: int, cpu: int, key: int = -1,
            gen: int = -1, parent: int = -1) -> int:
        """Record a closed span whose interval (``perf_counter_ns``) and
        thread CPU time the caller measured itself."""
        n = next(self._seq)
        s = n % self.capacity
        w = self._w
        w["num"][s] = n
        w["name"][s] = self._intern(name)
        w["parent"][s] = parent
        w["key"][s] = key
        w["gen"][s] = gen
        w["tid"][s] = threading.get_ident()
        w["t0"][s] = t0
        w["t1"][s] = t1
        w["cpu"][s] = cpu
        return n

    @staticmethod
    def clock() -> tuple[int, int]:
        """Now, as ``mark`` takes it: (``perf_counter_ns``, this
        thread's ``thread_time_ns``)."""
        return time.perf_counter_ns(), time.thread_time_ns()

    def mark(self, name: str, since: tuple[int, int],
             until: tuple[int, int] | None = None, key: int = -1,
             gen: int = -1) -> tuple[int, int]:
        """Record the mark ``name`` from ``since`` to ``until`` (``clock()``
        readings; now where None) with the thread CPU time between them.
        Returns ``until``, so that a chain of marks meets end to end.
        Records nothing after ``end_marks()``."""
        if until is None:
            until = self.clock()
        if self.marking:
            self._marks.append((name, since[0], until[0],
                                until[1] - since[1], key, gen,
                                threading.get_ident()))
        return until

    def end_marks(self) -> None:
        """Record no more marks (the server's start has returned)."""
        self.marking = False

    @property
    def dropped(self) -> int:
        """Records opened since ``start()`` that the ring overwrote."""
        mine = self._num[self._num >= self._first]
        if mine.size == 0:
            return 0
        return int(mine.max() - self._first + 1 - mine.size)

    def snapshot(self) -> dict:
        """The closed records since ``start()``, in the order they
        opened: ``names`` and one array each of ``num``, ``name``, ``t0``,
        ``t1`` (ns), ``cpu`` (ns), ``parent``, ``key``, ``gen`` and
        ``tid``; ``dropped`` and ``open`` (records not closed yet); and
        ``marks``, a list of dicts (``name``, ``t0``, ``t1``, ``cpu``,
        ``key``, ``gen``, ``tid``) ordered by start, an enclosing mark
        before what it holds."""
        mine = np.flatnonzero(self._num >= self._first)
        mine = mine[np.argsort(self._num[mine], kind="stable")]
        closed = mine[self._t1[mine] > 0]
        out = {k: getattr(self, "_" + k)[closed].copy()
               for k in ("num", "name", "t0", "t1", "cpu", "parent", "key",
                         "gen", "tid")}
        out.update(names=list(self.names), dropped=self.dropped,
                   open=int(mine.size - closed.size),
                   marks=[dict(zip(("name", "t0", "t1", "cpu", "key", "gen",
                                    "tid"), m))
                          for m in sorted(self._marks,
                                          key=lambda m: (m[1], -m[2]))])
        return out

    def write_chrome(self, path: str) -> str:
        """Write the snapshot as a Chrome trace (``"X"`` events, in
        microseconds of ``perf_counter``) that Perfetto and
        chrome://tracing open; each event's args carry its key,
        generation, record number, parent and thread CPU time. The marks
        follow the records, in category ``mark``. Returns ``path``."""
        snap = self.snapshot()
        pid = os.getpid()
        events = [
            {"ph": "X", "name": snap["names"][int(snap["name"][i])],
             "ts": int(snap["t0"][i]) / 1e3,
             "dur": int(snap["t1"][i] - snap["t0"][i]) / 1e3,
             "pid": pid, "tid": int(snap["tid"][i]),
             "args": {"key": int(snap["key"][i]), "gen": int(snap["gen"][i]),
                      "num": int(snap["num"][i]),
                      "parent": int(snap["parent"][i]),
                      "cpu_us": int(snap["cpu"][i]) / 1e3}}
            for i in range(snap["num"].size)]
        events += [
            {"ph": "X", "cat": "mark", "name": m["name"],
             "ts": m["t0"] / 1e3, "dur": (m["t1"] - m["t0"]) / 1e3,
             "pid": pid, "tid": m["tid"],
             "args": {"key": m["key"], "gen": m["gen"],
                      "cpu_us": m["cpu"] / 1e3}}
            for m in snap["marks"]]
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                       "tottonSpans": {"clock": "perf_counter_ns",
                                       "dropped": snap["dropped"],
                                       "open": snap["open"],
                                       "marks": len(snap["marks"])}}, f)
        return path
