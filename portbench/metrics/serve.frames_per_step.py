"""serve.frames_per_step: frames the serve plane served a step in the
window (the blocks delivered, ``ServeStats.frames_out`` over the block,
each channel a frame, over the ``steps`` delta; the zero-padded rows and
blocks of a step's shape are not counted)."""

from portbench.geometry import served_frames


def read(ctx):
    w, c = ctx["window"], ctx["config"]
    frames, steps = served_frames(dict(frames_out=0, steps=0), w,
                                  c["block_size"],
                                  c["serve_flags"]["channels"])
    if not steps:
        return None
    return frames / steps
