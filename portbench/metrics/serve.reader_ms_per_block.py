"""serve.reader_ms_per_block: the readers' ``serve.read`` time in the
window (each recv's decode, EQ, preamp and push, the wait inside recv
left out) over the blocks served in it (``frames_out`` delta over the
block; in a steady window as many as the input blocks completed)."""

from portbench import spans


def read(ctx):
    w = spans.window_of(ctx)
    if w is None or w.blocks <= 0:
        return None
    return w.total("serve.read") / w.blocks / 1e6
