"""serve.server_block_p95_ms: the 95th percentile of the server's own
block latency over the window, input-ready (the block's last input
sample pushed) to output-queued (handed to the stream's writer), from the
delta of the server-wide histogram (``ServeStats.block_latency``, 2%
buckets) between the window's counter snapshots."""

from portbench import spans


def read(ctx):
    counts = spans.latency_delta(ctx)
    if counts is None or sum(counts) == 0:
        return None
    from totton_tpu_torch.serve import LATENCY_EDGES_MS, latency_quantile

    top = max(i for i, c in enumerate(counts) if c)
    cap = (LATENCY_EDGES_MS[top] if top < len(LATENCY_EDGES_MS)
           else float("inf"))
    return latency_quantile(counts, 0.95, cap)
