"""serve.input_wait_share: the share of the window the dispatcher spent
in ``serve.wait_input``, waiting for a slot to become ready."""

from portbench import spans


def read(ctx):
    w = spans.window_of(ctx)
    if w is None or w.hi <= w.lo or not w.count("serve.gather"):
        return None
    return w.total("serve.wait_input") / (w.hi - w.lo) * 100.0
