"""serve.dispatcher_offcpu_share: one minus the dispatcher thread's CPU
time over its wall time across its own host work in the window
(``serve.gather``, ``serve.enqueue``, ``serve.housekeeping`` and
``serve.drain`` less ``serve.drain_wait``): the share of the time it was
ready to work but not running, waiting for the GIL or a core."""

from portbench import spans


def read(ctx):
    w = spans.window_of(ctx)
    if w is None:
        return None
    wall = sum(w.total(n) for n in spans.HOST_WORK) - w.total(spans.HOST_WAIT)
    cpu = sum(w.cpu_total(n) for n in spans.HOST_WORK) \
        - w.cpu_total(spans.HOST_WAIT)
    if wall <= 0:
        return None
    return (1.0 - cpu / wall) * 100.0
