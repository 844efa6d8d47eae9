"""loadgen.late_p95_ms: the 95th percentile, over every period due in the
window, of the time its last byte was handed to the socket minus the time
it was due: how late the load generator ran. Paced traffic only."""

import numpy as np


def read(ctx):
    if not ctx["paced"]:
        return None
    late = np.concatenate([s["late_s"] for s in ctx["streams"]])
    if late.size == 0:
        return None
    return float(np.percentile(late, 95) * 1e3)
