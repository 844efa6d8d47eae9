"""fused_frames.forward_roofline: the frame kernel's forward transform's
share of its bound in the profiler window: the least time of the served
frames' forwards (``forward.py``: an m-point real FFT, bound by its bytes
at the 80k bank; zero padding is no work) over the summed time of the
forward launches' records (F1 and F2 at 4x, F at 16x). None where the
window kept no forward record, as on the resident plan."""

from portbench.forward import forward_kernel_s, forward_least_seconds
from portbench.geometry import served_frames


def read(ctx):
    t = ctx["trace"]
    if t is None or "kernels" not in t:
        return None
    spent = forward_kernel_s(t["kernels"])
    if spent <= 0:
        return None
    c = ctx["config"]
    frames, _dispatches = served_frames(t["before"], t["after"],
                                        c["block_size"],
                                        c["serve_flags"]["channels"])
    if frames <= 0:
        return None
    least, _side = forward_least_seconds(c["fft_size"] // c["ratio"], frames)
    return least / spent * 100.0
