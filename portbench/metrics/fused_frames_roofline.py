"""fused_frames_roofline: the frame kernel's share of its bound in the
profiler window: the least time of the frames served (``geometry.py``,
float32 out, as the kernel writes it; zero padding is no work) over the
summed time of the frame kernel's records (``fft_resident``, or the
``fft_stage`` launches)."""

from portbench.geometry import least_seconds, served_frames


def read(ctx):
    t = ctx["trace"]
    if t is None or t["frame_kernel_s"] <= 0:
        return None
    c = ctx["config"]
    frames, dispatches = served_frames(t["before"], t["after"],
                                       c["block_size"],
                                       c["serve_flags"]["channels"])
    if frames <= 0:
        return None
    least, _side = least_seconds(c["fft_size"], c["ratio"], c["block_size"],
                                 frames, dispatches, 4)
    return least / t["frame_kernel_s"] * 100.0
