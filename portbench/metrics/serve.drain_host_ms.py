"""serve.drain_host_ms: the dispatcher's ``serve.drain`` time less its
``serve.drain_wait`` (the wait on the step's download), a step in the
window: the host's own work of a drain (slicing each slot's rows, the
fade mix, queueing to the writers, the latency accounting)."""

from portbench import spans


def read(ctx):
    w = spans.window_of(ctx)
    if w is None or not w.steps:
        return None
    return (w.total("serve.drain") - w.total(spans.HOST_WAIT)) \
        / w.steps / 1e6
