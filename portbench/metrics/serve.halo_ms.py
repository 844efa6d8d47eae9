"""serve.halo_ms: the host's time a step, in the window, to carry each
served row's overlap-save history (the halo: (taps - 1) / ratio input
frames a row): the dispatcher's ``serve.gather_halo`` (the tails array,
each served slot's tail into it, the tail join and cut) and
``serve.upload_halo`` (the tails' pinned copy and host-to-device enqueue),
over the window's ``steps`` delta. None where the program records no
halo span."""

from portbench import spans


def read(ctx):
    w = spans.window_of(ctx)
    if w is None or not w.steps or not w.count("serve.gather_halo"):
        return None
    return (w.total("serve.gather_halo") + w.total("serve.upload_halo")) \
        / w.steps / 1e6
