"""Small integer helpers shared by the dispatch-shape quantizers (the
stream sessions, fade prefixes, and the serving dispatcher all quantize
block counts to powers of two so the jit shape universe stays
logarithmic)."""

from __future__ import annotations


def pow2_floor(n: int) -> int:
    """Largest power of two <= n (n >= 1)."""
    if n < 1:
        raise ValueError(f"pow2_floor needs n >= 1, got {n}")
    return 1 << (n.bit_length() - 1)


def pow2_ceil(n: int) -> int:
    """Smallest power of two >= n (n >= 0; 0 -> 1)."""
    return 1 << max(n - 1, 0).bit_length()
