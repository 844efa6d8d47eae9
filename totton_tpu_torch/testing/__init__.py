"""Test-audio tooling: copies of the JAX package's ``testing/signals.py``
and ``testing/validate_output.py``. This ``__init__`` imports nothing."""
