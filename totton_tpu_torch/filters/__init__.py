"""Filter artifacts for the port: copies of the JAX package's
``filters/sidecar.py`` (the .bin + .json sidecar loader) and
``filters/hrtf.py`` (crossfeed sets). The design and validation toolkit is
not copied; filters are designed offline with the JAX package's
``totton-generate-filters``. This ``__init__`` imports nothing."""
