"""Parametric EQ for the port: Equalizer-APO parsing and RBJ biquads.

``apo`` and ``biquad`` are copies of the JAX package's framework-free
modules (``totton_tpu/eq/__init__.py`` imports the jax cascade, so the port
cannot import them from there without loading jax). The port bakes the
EQ's response into the filter spectrum; it has no time-domain cascade.
"""

from __future__ import annotations

from pathlib import Path


def resolve_eq_response(eq_profile_path: str | None,
                        config_path: str | None,
                        fft_size: int, output_rate: int):
    """EQ baked into the filter spectrum, as
    ``totton_tpu.control.wiring.resolve_eq_response`` (same rule, the
    port's parser): an explicit profile path wins; otherwise config.json's
    eqEnabled/eqProfilePath, re-read on every RELOAD. Returns (response
    array | None, description | None); raises OSError/ValueError on an
    unreadable or invalid profile."""
    eq_path = eq_profile_path
    if not eq_path and config_path:
        from totton_tpu.web.services.config import load_config

        settings = load_config(Path(config_path))
        if settings.eq_enabled and settings.eq_profile_path:
            eq_path = settings.eq_profile_path
    if not eq_path:
        return None, None
    from totton_tpu_torch.eq.apo import parse_eq_file
    from totton_tpu_torch.eq.biquad import profile_response_for_fft

    profile = parse_eq_file(eq_path)
    return profile_response_for_fft(profile, fft_size, output_rate), (
        f"{eq_path} ({profile.active_band_count} active bands, "
        f"preamp {profile.preamp_db} dB)")
