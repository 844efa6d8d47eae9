"""setup.after_start_s: ``start()``'s return to the window: a traced run's
profiler warm-up, the load generators' start and the traffic's warm-up,
s. One of the five start phases (``portbench/startmarks.py``) that sum
to ``setup_s``; None where the program marks no start."""

from portbench import startmarks


def read(ctx):
    return startmarks.phase(ctx, "after_start")
