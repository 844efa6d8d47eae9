"""Per-block timing and device tracing: a copy of
``totton_tpu/utils/profiling.py``.

``BlockTimer`` is a cheap wall-clock accumulator with percentile summaries
that wraps each device dispatch in the stream sessions. ``trace_context``
wraps ``torch.profiler`` where the reference wraps ``jax.profiler.trace``.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
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
