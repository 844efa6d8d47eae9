"""serve.gather_ms: the dispatcher's ``serve.gather`` time a step in the
window (its spans clipped to the window, over the window's ``steps``
delta): building each step from the ready slots, idle gathers
included."""

from portbench import spans


def read(ctx):
    w = spans.window_of(ctx)
    if w is None or not w.steps:
        return None
    return w.total("serve.gather") / w.steps / 1e6
