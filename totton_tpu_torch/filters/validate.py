"""Filter validation: frequency-response and minimum-phase property checks.

Mirrors the checks the reference records into the sidecar's
``validation_results`` block (generate_filter.py:369-417): passband ripple,
stopband attenuation, peak position / energy-concentration minimum-phase
tests, plus DC-gain facts. All in float64 on host.
"""

from __future__ import annotations

import math

import numpy as np


def _amplitude_response(h: np.ndarray, n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """(freqs_normalized, |H|) on an r2c grid of n_fft points (fs = 1.0)."""
    mag = np.abs(np.fft.rfft(np.asarray(h, dtype=np.float64), n_fft))
    freqs = np.fft.rfftfreq(n_fft, d=1.0)
    return freqs, mag


def validate_filter(
    h: np.ndarray,
    sample_rate_output: float,
    passband_end_hz: float,
    stopband_start_hz: float,
    target_stopband_attenuation_db: float = 140.0,
    target_dc_gain: float | None = None,
    phase: str = "minimum",
    n_fft: int | None = None,
) -> dict:
    """Measure the filter against its spec. Returns a validation report dict
    shaped like the reference sidecar's ``validation_results``."""
    h = np.asarray(h, dtype=np.float64)
    n = len(h)
    if n_fft is None:
        n_fft = 2 ** int(math.ceil(math.log2(8 * n)))
    freqs, mag = _amplitude_response(h, n_fft)
    freqs_hz = freqs * sample_rate_output

    dc_gain = float(np.sum(h))
    # Normalize magnitudes by the passband level so ripple/attenuation are
    # relative to the working gain (the taps carry DC gain = ratio * 0.99).
    passband = mag[freqs_hz <= passband_end_hz]
    pass_ref = float(np.max(passband)) if passband.size else 1.0
    eps = np.finfo(np.float64).tiny

    ripple_db = 0.0
    if passband.size:
        ripple_db = float(
            20.0 * np.log10(np.max(passband) / max(np.min(passband), eps))
        )

    stopband = mag[freqs_hz >= stopband_start_hz]
    atten_db = float("inf")
    if stopband.size:
        atten_db = float(-20.0 * np.log10(max(np.max(stopband), eps) / pass_ref))

    # Minimum-phase heuristics (reference: generate_filter.py:369-417):
    # energy peak within the first 1% of taps, and the first half of the
    # impulse response carries >10x the energy of the second half.
    peak_position = int(np.argmax(np.abs(h)))
    peak_threshold = max(1, n // 100)
    first_half_energy = float(np.sum(h[: n // 2] ** 2))
    second_half_energy = float(np.sum(h[n // 2 :] ** 2))
    energy_ratio = first_half_energy / max(second_half_energy, eps)
    is_minimum_phase = peak_position < peak_threshold and energy_ratio > 10.0

    # Linear phase <=> even symmetry about the center tap.
    is_symmetric = bool(np.allclose(h, h[::-1], rtol=0, atol=1e-12 * np.max(np.abs(h))))

    report = {
        "passband_ripple_db": ripple_db,
        "stopband_attenuation_db": atten_db,
        "peak_position": peak_position,
        "peak_threshold_samples": peak_threshold,
        "energy_ratio_first_to_second_half": energy_ratio,
        "meets_stopband_spec": atten_db >= target_stopband_attenuation_db,
        "is_minimum_phase": is_minimum_phase,
        "is_symmetric": is_symmetric,
        "actual_taps": n,
        "dc_gain": dc_gain,
    }
    if target_dc_gain is not None:
        report["input_band_peak"] = float(np.max(passband)) if passband.size else dc_gain
        report["input_band_peak_normalized"] = (
            report["input_band_peak"] / target_dc_gain
        )
    if phase == "minimum" and not is_minimum_phase:
        report["warning"] = "filter failed minimum-phase heuristics"
    return report
