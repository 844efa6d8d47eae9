"""setup.import_s: the package's import, from its first line to the end of
``serve.py``'s (``serve.setup.import``), s. One of the five start phases
(``portbench/startmarks.py``) that sum to ``setup_s``; None where the
program marks no start."""

from portbench import startmarks


def read(ctx):
    return startmarks.phase(ctx, "import")
