"""Shared control-plane wiring helpers for the stream and serve CLIs.

Both CLIs wire the same reference command surface
(src/zmq/zmq_server_main.cpp:150-221) to a live engine, and fleet
correctness depends on a few rules staying byte-identical between them:
phase-token normalization, config.json as the durable phase/EQ truth
(re-read on every RELOAD), and the startup-phase precedence. Those
rules live here once; the per-CLI callbacks (which genuinely differ —
multi-host schedule_swap, dither targeting, serve's shared-spectrum
swap) stay in their CLIs.
"""

from __future__ import annotations

from pathlib import Path


def normalize_phase(phase: str | None) -> str | None:
    """'min'/'minimum' -> 'minimum'; 'linear' -> 'linear'; else None."""
    if phase in ("min", "minimum"):
        return "minimum"
    if phase == "linear":
        return "linear"
    return None


def read_config_phase(config_path: str | None) -> str | None:
    """config.json's filter.phaseType, normalized (None when absent)."""
    if not config_path:
        return None
    from totton_tpu_torch.web.services.config import load_config

    settings = load_config(Path(config_path))
    if settings.filter is None:
        return None
    return normalize_phase(settings.filter.phase_type)


def resolve_startup_phase(explicit: str | None,
                          config_path: str | None) -> str:
    """Startup phase precedence: explicit --phase > config.json
    filter.phaseType > minimum. Without the config read, a persisted
    PHASE_TYPE_SET would silently revert on restart (the reference
    flaw the persistence exists to fix)."""
    return (normalize_phase(explicit) or read_config_phase(config_path)
            or "minimum")


def persist_phase(phase: str, config_path: str | None,
                  is_leader: bool) -> None:
    """Persist a PHASE_TYPE_SET into config.json so RELOAD/restart keeps
    it. Only the leader writes: followers replaying a published event
    may share the file and must not race the write."""
    if not config_path or not is_leader:
        return
    from totton_tpu_torch.web.services.config import save_config_updates

    save_config_updates({"filter": {"phaseType": phase}},
                        Path(config_path))


def resolve_eq_response(eq_profile_path: str | None,
                        config_path: str | None,
                        fft_size: int, output_rate: int):
    """EQ baked into the filter spectrum: an explicit --eq-profile wins;
    otherwise config.json's eqEnabled/eqProfilePath (the path the
    reference web UI writes on apply/activate, SURVEY.md §3.4) — called
    again on every RELOAD so web-driven EQ swaps reach the live engine.
    Returns (response array | None, description | None); raises
    OSError/ValueError on an unreadable/invalid profile (callers decide
    whether that is fatal)."""
    eq_path = eq_profile_path
    if not eq_path and config_path:
        from totton_tpu_torch.web.services.config import load_config

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
