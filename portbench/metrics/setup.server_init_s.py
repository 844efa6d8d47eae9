"""setup.server_init_s: the import's end to the ``StreamServer``
constructor's return: the filter's resolve and load, the CUDA context,
the fold, the kernel plan, the slots (``serve.setup.init``), s. One of
the five start phases (``portbench/startmarks.py``) that sum to
``setup_s``; None where the program marks no start."""

from portbench import startmarks


def read(ctx):
    return startmarks.phase(ctx, "server_init")
