"""Shared utilities: copies of the JAX package's ``utils/intmath.py``
and ``utils/profiling.py`` (``trace_context`` wraps ``torch.profiler``).
"""

from totton_tpu_torch.utils.profiling import BlockTimer, trace_context

__all__ = ["BlockTimer", "trace_context"]
