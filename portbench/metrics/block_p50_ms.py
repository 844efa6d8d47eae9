"""block_p50_ms: the median latency of every block due in the window of a
live cell, from when the period carrying its last input frame was due to
the arrival of its last output frame (a block that never came counts as
1e3 s): what a live listener waits, set by the serve plane's host work a
step. A per-layer metric: its runs spread too widely for an end-to-end
bound (14-42% of the median within a set of six)."""

from portbench.loadgen import block_p50_ms


def read(ctx):
    return block_p50_ms(ctx["streams"]) if ctx["paced"] else None
