"""Per-block timing: a copy of ``totton_tpu/utils/profiling.py`` with
``BlockTimer`` only.

``BlockTimer`` is a cheap wall-clock accumulator with percentile summaries
that wraps each device dispatch in the stream sessions. The reference's
``trace_context`` wraps ``jax.profiler.trace``; its torch counterpart
(``torch.profiler``) is not ported yet, so it is left out here.
"""

from __future__ import annotations

import contextlib
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
