"""Shared utilities: copies of the JAX package's ``utils/intmath.py`` and
``utils/profiling.py`` (``BlockTimer`` only). This ``__init__`` imports
nothing."""
