"""setup.server_start_s: the constructor's return to
``StreamServer.start()``'s return: every step shape run once and the
kernels' first load (``serve.setup.start``), s. One of the five start
phases (``portbench/startmarks.py``) that sum to ``setup_s``; None where
the program marks no start."""

from portbench import startmarks


def read(ctx):
    return startmarks.phase(ctx, "server_start")
