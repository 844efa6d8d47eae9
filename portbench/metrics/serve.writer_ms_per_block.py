"""serve.writer_ms_per_block: the writers' ``serve.write`` time in the
window (each queued item's interleave, PCM conversion and ``sendall``,
the child ``serve.send``) over the blocks served in it (``frames_out``
delta over the block)."""

from portbench import spans


def read(ctx):
    w = spans.window_of(ctx)
    if w is None or w.blocks <= 0:
        return None
    return w.total("serve.write") / w.blocks / 1e6
