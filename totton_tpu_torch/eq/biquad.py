"""RBJ audio-EQ-cookbook biquads and cascaded frequency responses.

Full cookbook implementation (peaking, shelves, LP/HP/BP, notch, all-pass;
Robert Bristow-Johnson's "Cookbook formulae for audio EQ biquad filter
coefficients"). The reference implements PK/LS/HS only and bypasses the rest
with a warning (src/audio/eq_to_fir.cpp:25-67); this is a superset with
identical math for the shared types.

All response math is float64 on host — responses are baked into the filter
spectrum once, never evaluated in the streaming hot path.

The port's copy of ``totton_tpu.eq.biquad``: the JAX package's ``eq`` package
imports its jax cascade (``eq/iir.py``) on import, so the port carries
these framework-free modules itself. ``tests/test_torch_copies.py``
holds the copy to the reference.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from totton_tpu_torch.eq.apo import GAIN_TYPES, EqBand, EqProfile, FilterType

_DEFAULT_PASS_Q = 1.0 / math.sqrt(2.0)


@dataclasses.dataclass(frozen=True)
class BiquadCoeffs:
    """Normalized (a0 == 1) biquad: H(z) = (b0 + b1 z^-1 + b2 z^-2) /
    (1 + a1 z^-1 + a2 z^-2)."""

    b0: float = 1.0
    b1: float = 0.0
    b2: float = 0.0
    a1: float = 0.0
    a2: float = 0.0

    @property
    def is_identity(self) -> bool:
        return self == BiquadCoeffs()


def _shelf_q(band: EqBand) -> float:
    """Effective Q for shelf variants. Plain LS/HS and LSC/HSC use the
    band's Q (default 1.0 -> maximally steep without overshoot at S=1);
    fixed-slope variants pin the slope."""
    if band.type in (FilterType.LS_6DB, FilterType.HS_6DB):
        # 6 dB/oct: gentle slope, S = 0.5
        return _slope_to_q(band, 0.5)
    if band.type in (FilterType.LS_12DB, FilterType.HS_12DB):
        # 12 dB/oct: S = 1.0
        return _slope_to_q(band, 1.0)
    return band.q


def _slope_to_q(band: EqBand, slope: float) -> float:
    a = 10.0 ** (band.gain / 40.0)
    inv_q2 = (a + 1.0 / a) * (1.0 / slope - 1.0) + 2.0
    return 1.0 / math.sqrt(max(inv_q2, 1e-12))


def biquad_coeffs(band: EqBand, sample_rate: float) -> BiquadCoeffs:
    """Coefficients for one band at the given sample rate.

    Returns identity (bypass) when the band is disabled, when a gain-type
    band has zero gain, or when Fc is at/above Nyquist.
    """
    if not band.enabled:
        return BiquadCoeffs()
    if band.type in GAIN_TYPES and band.gain == 0.0:
        return BiquadCoeffs()
    if band.frequency <= 0.0 or band.frequency >= sample_rate / 2.0:
        return BiquadCoeffs()

    a = 10.0 ** (band.gain / 40.0)
    w0 = 2.0 * math.pi * band.frequency / sample_rate
    cos_w0 = math.cos(w0)
    sin_w0 = math.sin(w0)

    t = band.type
    # APO's plain LP/HP are Butterworth; Q applies only to LPQ/HPQ.
    q = _DEFAULT_PASS_Q if t in (FilterType.LP, FilterType.HP) else band.q
    alpha = sin_w0 / (2.0 * max(q, 1e-12))

    if t in (FilterType.PK, FilterType.MODAL, FilterType.PEQ):
        b0 = 1.0 + alpha * a
        b1 = -2.0 * cos_w0
        b2 = 1.0 - alpha * a
        a0 = 1.0 + alpha / a
        a1 = -2.0 * cos_w0
        a2 = 1.0 - alpha / a
    elif t in (FilterType.LP, FilterType.LPQ):
        b1 = 1.0 - cos_w0
        b0 = b2 = b1 / 2.0
        a0 = 1.0 + alpha
        a1 = -2.0 * cos_w0
        a2 = 1.0 - alpha
    elif t in (FilterType.HP, FilterType.HPQ):
        b1 = -(1.0 + cos_w0)
        b0 = b2 = (1.0 + cos_w0) / 2.0
        a0 = 1.0 + alpha
        a1 = -2.0 * cos_w0
        a2 = 1.0 - alpha
    elif t is FilterType.BP:
        # Constant 0 dB peak gain variant.
        b0 = alpha
        b1 = 0.0
        b2 = -alpha
        a0 = 1.0 + alpha
        a1 = -2.0 * cos_w0
        a2 = 1.0 - alpha
    elif t is FilterType.NO:
        b0 = 1.0
        b1 = -2.0 * cos_w0
        b2 = 1.0
        a0 = 1.0 + alpha
        a1 = -2.0 * cos_w0
        a2 = 1.0 - alpha
    elif t is FilterType.AP:
        b0 = 1.0 - alpha
        b1 = -2.0 * cos_w0
        b2 = 1.0 + alpha
        a0 = 1.0 + alpha
        a1 = -2.0 * cos_w0
        a2 = 1.0 - alpha
    elif t in (FilterType.LS, FilterType.LSC, FilterType.LSQ,
               FilterType.LS_6DB, FilterType.LS_12DB):
        q_eff = _shelf_q(band) if t in (FilterType.LS_6DB, FilterType.LS_12DB) else band.q
        alpha = sin_w0 / (2.0 * max(q_eff, 1e-12))
        sqrt_a = math.sqrt(a)
        two_sqrt_a_alpha = 2.0 * sqrt_a * alpha
        b0 = a * ((a + 1.0) - (a - 1.0) * cos_w0 + two_sqrt_a_alpha)
        b1 = 2.0 * a * ((a - 1.0) - (a + 1.0) * cos_w0)
        b2 = a * ((a + 1.0) - (a - 1.0) * cos_w0 - two_sqrt_a_alpha)
        a0 = (a + 1.0) + (a - 1.0) * cos_w0 + two_sqrt_a_alpha
        a1 = -2.0 * ((a - 1.0) + (a + 1.0) * cos_w0)
        a2 = (a + 1.0) + (a - 1.0) * cos_w0 - two_sqrt_a_alpha
    elif t in (FilterType.HS, FilterType.HSC, FilterType.HSQ,
               FilterType.HS_6DB, FilterType.HS_12DB):
        q_eff = _shelf_q(band) if t in (FilterType.HS_6DB, FilterType.HS_12DB) else band.q
        alpha = sin_w0 / (2.0 * max(q_eff, 1e-12))
        sqrt_a = math.sqrt(a)
        two_sqrt_a_alpha = 2.0 * sqrt_a * alpha
        b0 = a * ((a + 1.0) + (a - 1.0) * cos_w0 + two_sqrt_a_alpha)
        b1 = -2.0 * a * ((a - 1.0) + (a + 1.0) * cos_w0)
        b2 = a * ((a + 1.0) + (a - 1.0) * cos_w0 - two_sqrt_a_alpha)
        a0 = (a + 1.0) - (a - 1.0) * cos_w0 + two_sqrt_a_alpha
        a1 = 2.0 * ((a - 1.0) - (a + 1.0) * cos_w0)
        a2 = (a + 1.0) - (a - 1.0) * cos_w0 - two_sqrt_a_alpha
    else:  # pragma: no cover — all enum members handled above
        return BiquadCoeffs()

    return BiquadCoeffs(b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0)


def biquad_response(
    coeffs: BiquadCoeffs, frequencies_hz: np.ndarray, sample_rate: float
) -> np.ndarray:
    """Complex H(e^{jw}) over a frequency grid (float64/complex128)."""
    f = np.abs(np.asarray(frequencies_hz, dtype=np.float64))
    z = np.exp(-2j * np.pi * f / sample_rate)
    z2 = z * z
    num = coeffs.b0 + coeffs.b1 * z + coeffs.b2 * z2
    den = 1.0 + coeffs.a1 * z + coeffs.a2 * z2
    return num / den


def profile_response(
    profile: EqProfile, frequencies_hz: np.ndarray, sample_rate: float
) -> np.ndarray:
    """Cascaded complex response of preamp x all enabled bands."""
    response = np.full(
        len(np.atleast_1d(frequencies_hz)),
        10.0 ** (profile.preamp_db / 20.0),
        dtype=np.complex128,
    )
    for band in profile.bands:
        if not band.enabled:
            continue
        c = biquad_coeffs(band, sample_rate)
        if c.is_identity:
            continue
        response *= biquad_response(c, frequencies_hz, sample_rate)
    return response


def rfft_bin_frequencies(
    num_bins: int, full_fft_size: int, sample_rate: float
) -> np.ndarray:
    """Frequencies (Hz) of the first num_bins r2c FFT bins
    (reference: eq_to_fir.cpp:132-143)."""
    return np.arange(num_bins, dtype=np.float64) * (sample_rate / full_fft_size)


def profile_response_for_fft(
    profile: EqProfile, fft_size: int, output_sample_rate: float
) -> np.ndarray:
    """Complex EQ response on the overlap-save rfft grid (fft_size//2+1 bins),
    ready to bake into the filter spectrum."""
    freqs = rfft_bin_frequencies(fft_size // 2 + 1, fft_size, output_sample_rate)
    return profile_response(profile, freqs, output_sample_rate)


def profile_magnitude_for_fft(
    profile: EqProfile, fft_size: int, output_sample_rate: float
) -> np.ndarray:
    """Magnitude-only variant with >1.0 peak normalization (clipping guard),
    matching the reference's computeEqMagnitudeForFft
    (eq_to_fir.cpp:153-177)."""
    mag = np.abs(profile_response_for_fft(profile, fft_size, output_sample_rate))
    peak = float(np.max(mag)) if mag.size else 0.0
    if peak > 1.0:
        mag = mag / peak
    return mag
