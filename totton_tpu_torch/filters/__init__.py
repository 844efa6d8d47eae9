"""Offline FIR filter design toolkit: copies of the JAX package's
``filters/{design,validate,generate,plots,sidecar,hrtf}.py`` (Kaiser
lowpass design, minimum-phase conversion, validation, the .bin + .json
sidecar format and crossfeed sets).
"""

from totton_tpu_torch.filters.design import (
    FilterSpec,
    MULTI_RATE_SPECS,
    aligned_tap_count,
    design_kaiser_lowpass,
    design_filter,
    minimum_phase_homomorphic,
    normalize_dc_gain,
)
from totton_tpu_torch.filters.sidecar import (
    FilterSidecar,
    LoadedFilter,
    load_filter,
    save_filter,
    overlap_save_geometry,
)
from totton_tpu_torch.filters.validate import validate_filter

__all__ = [
    "FilterSpec",
    "MULTI_RATE_SPECS",
    "aligned_tap_count",
    "design_kaiser_lowpass",
    "design_filter",
    "minimum_phase_homomorphic",
    "normalize_dc_gain",
    "FilterSidecar",
    "LoadedFilter",
    "load_filter",
    "save_filter",
    "overlap_save_geometry",
    "validate_filter",
]
