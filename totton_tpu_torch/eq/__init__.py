"""Parametric EQ for the port: Equalizer-APO parsing and RBJ biquads.

``apo`` and ``biquad`` are copies of the JAX package's framework-free
modules (``totton_tpu/eq/__init__.py`` imports the jax cascade, so the port
cannot import them from there without loading jax). The port bakes the
EQ's response into the filter spectrum
(``totton_tpu_torch.control.wiring.resolve_eq_response``); it has no
time-domain cascade.
"""
