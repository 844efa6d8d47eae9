"""Per-block timing and device tracing: a copy of
``totton_tpu/utils/profiling.py``.

``BlockTimer`` is a cheap wall-clock accumulator with percentile summaries
that wraps each device dispatch in the stream sessions. ``trace_context``
wraps ``torch.profiler`` where the reference wraps ``jax.profiler.trace``.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np


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
    or chrome://tracing.
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
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"trace_{os.getpid()}_{time.monotonic_ns()}.json"))
