"""Parametric EQ subsystem on torch.

Equalizer-APO-format parsing and RBJ audio-EQ-cookbook biquads (``apo``
and ``biquad``, copies of the JAX package's framework-free modules), and
the two application paths:

- **Spectral bake-in** (primary): the EQ's complex response on the
  overlap-save rfft grid is multiplied into the filter spectrum once at
  (re)load (``totton_tpu_torch.control.wiring.resolve_eq_response``).
- **Time-domain cascade** (alternate, ``iir``): cascaded TDF2 biquads with
  carried state, for EQ without a convolution filter in the chain; on a
  card the hand-written kernel ``csrc/biquad_cascade.cu``.
"""

from totton_tpu_torch.eq.apo import (
    EqBand,
    EqProfile,
    FilterType,
    parse_eq_file,
    parse_eq_string,
)
from totton_tpu_torch.eq.biquad import (
    BiquadCoeffs,
    biquad_coeffs,
    biquad_response,
    profile_response,
    profile_magnitude_for_fft,
    profile_response_for_fft,
    rfft_bin_frequencies,
)
from totton_tpu_torch.eq.iir import biquad_cascade, make_cascade_step

__all__ = [
    "EqBand",
    "EqProfile",
    "FilterType",
    "parse_eq_file",
    "parse_eq_string",
    "BiquadCoeffs",
    "biquad_coeffs",
    "biquad_response",
    "profile_response",
    "profile_magnitude_for_fft",
    "profile_response_for_fft",
    "rfft_bin_frequencies",
    "biquad_cascade",
    "make_cascade_step",
]
