"""devstep_roofline: the least time of the frames the serve plane served
in the profiler window (``geometry.py``: their nominal FFT work at the fp32
peak, or their least bytes at the HBM rate, output in the type it leaves
the card in; zero padding is no work) over the summed time of every kernel
in the window: the device step's share of its bound."""

from portbench.geometry import least_seconds, served_frames


def read(ctx):
    t = ctx["trace"]
    if t is None or t["kernel_s"] <= 0:
        return None
    c = ctx["config"]
    frames, dispatches = served_frames(t["before"], t["after"],
                                       c["block_size"],
                                       c["serve_flags"]["channels"])
    if frames <= 0:
        return None
    out_bytes = 2 if c["serve_flags"]["device_pcm"] else 4
    least, _side = least_seconds(c["fft_size"], c["ratio"], c["block_size"],
                                 frames, dispatches, out_bytes)
    return least / t["kernel_s"] * 100.0
