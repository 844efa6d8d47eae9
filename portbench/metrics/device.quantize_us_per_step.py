"""device.quantize_us_per_step: the device time of the on-device s16
quantize a step (``ops/device_pcm.quantize_s16``): the kernels whose
runtime launch record falls inside a ``serve.quantize`` span, matched by
correlation id, or where the window kept no launch records the kernels
between a step's last frame-kernel record and its DtoH copy (the
method is in the run's span info)."""

from portbench import spans


def read(ctx):
    w = spans.window_of(ctx)
    if w is None:
        return None
    got = w.quantize_ns_per_step()
    if got is None:
        return None
    return got[0] / 1e3
