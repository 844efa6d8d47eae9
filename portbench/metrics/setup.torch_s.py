"""setup.torch_s: process start to the package's first line: the
interpreter, numpy, torch and the harness's own imports, s. One of the
five start phases (``portbench/startmarks.py``) that sum to ``setup_s``;
None where the program marks no start."""

from portbench import startmarks


def read(ctx):
    return startmarks.phase(ctx, "torch")
