"""serve.enqueue_ms: the dispatcher's ``serve.enqueue`` time a step in the
window: the host side of a device step, from the first upload to the
last download queued (its children: ``serve.upload``, ``serve.launch``,
``serve.quantize``, ``serve.download``)."""

from portbench import spans


def read(ctx):
    w = spans.window_of(ctx)
    if w is None or not w.steps:
        return None
    return w.total("serve.enqueue") / w.steps / 1e6
