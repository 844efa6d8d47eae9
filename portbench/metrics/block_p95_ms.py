"""block_p95_ms: the 95th percentile of the latency of every block due in
the window of a live cell, from when the period carrying its last input
frame was due to the arrival of its last output frame. A per-layer metric:
its runs spread too widely for an end-to-end bound."""

from portbench.loadgen import block_p95_ms


def read(ctx):
    return block_p95_ms(ctx["streams"]) if ctx["paced"] else None
