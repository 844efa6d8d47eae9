"""Filter coefficient artifact format: raw float32 .bin + .json sidecar.

Byte- and schema-compatible with the reference format (docs/filter_format.md,
src/vulkan/vulkan_streaming_upsampler.cpp:606-724), so filters generated by
either toolkit load in either engine:

  - ``coefficients_bin``: path (relative to the sidecar) of a float32 LE file.
  - ``taps``: number of coefficients; bin size must equal taps * 4 bytes.
  - ``fft_size``: power of two, >= taps.
  - ``block_size``: fft_size - (taps - 1)  (overlap-save invariant).
  - ``upsample_factor``: integer ratio; block_size % upsample_factor == 0.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import math
import os

import numpy as np


def overlap_save_geometry(taps: int, fft_size: int | None = None) -> tuple[int, int]:
    """Derive (fft_size, block_size) for overlap-save with ``taps`` coefficients.

    Default fft_size = 2^ceil(log2(taps)) (reference: generate_filter.py:207-217).
    A larger power of two may be passed to trade latency for throughput; the
    invariant fft_size - block_size == taps - 1 always holds.
    """
    if fft_size is None:
        fft_size = 2 ** int(math.ceil(math.log2(taps)))
    if fft_size & (fft_size - 1):
        raise ValueError(f"fft_size must be a power of two, got {fft_size}")
    if fft_size < taps:
        raise ValueError(f"fft_size ({fft_size}) must be >= taps ({taps})")
    block_size = fft_size - (taps - 1)
    return fft_size, block_size


@dataclasses.dataclass(frozen=True)
class FilterSidecar:
    """Parsed and validated .json sidecar."""

    coefficients_bin: str
    taps: int
    fft_size: int
    block_size: int
    upsample_factor: int
    sample_rate_input: int | None = None
    sample_rate_output: int | None = None
    extra: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.taps < 1:
            raise ValueError(f"taps must be >= 1: {self.taps}")
        if self.fft_size & (self.fft_size - 1) or self.fft_size == 0:
            raise ValueError(f"fft_size must be a power of two: {self.fft_size}")
        if self.taps > self.fft_size:
            raise ValueError(
                f"taps ({self.taps}) must be <= fft_size ({self.fft_size})"
            )
        if self.block_size >= self.fft_size:
            raise ValueError(
                f"block_size ({self.block_size}) must be < fft_size ({self.fft_size})"
            )
        if self.fft_size - self.block_size != self.taps - 1:
            raise ValueError(
                "overlap-save invariant violated: fft_size - block_size "
                f"({self.fft_size - self.block_size}) != taps - 1 ({self.taps - 1})"
            )
        if self.upsample_factor < 1:
            raise ValueError(f"upsample_factor must be >= 1: {self.upsample_factor}")
        if self.block_size % self.upsample_factor != 0:
            raise ValueError(
                f"block_size ({self.block_size}) not divisible by "
                f"upsample_factor ({self.upsample_factor})"
            )

    @property
    def overlap(self) -> int:
        """Overlap-save history length in output-rate samples (= taps - 1)."""
        return self.taps - 1

    @property
    def block_input_frames(self) -> int:
        """Input-rate samples consumed per block."""
        return self.block_size // self.upsample_factor

    @classmethod
    def from_json(cls, payload: dict) -> "FilterSidecar":
        known = {
            "coefficients_bin",
            "taps",
            "fft_size",
            "block_size",
            "upsample_factor",
            "sample_rate_input",
            "sample_rate_output",
        }
        missing = {"coefficients_bin", "taps", "fft_size", "block_size"} - payload.keys()
        if missing:
            raise ValueError(f"sidecar missing required keys: {sorted(missing)}")
        return cls(
            coefficients_bin=str(payload["coefficients_bin"]),
            taps=int(payload["taps"]),
            fft_size=int(payload["fft_size"]),
            block_size=int(payload["block_size"]),
            upsample_factor=int(payload.get("upsample_factor", 1)),
            sample_rate_input=payload.get("sample_rate_input"),
            sample_rate_output=payload.get("sample_rate_output"),
            extra={k: v for k, v in payload.items() if k not in known},
        )


@dataclasses.dataclass(frozen=True)
class LoadedFilter:
    """Coefficients plus validated sidecar, ready for the engine."""

    taps: np.ndarray  # float32 [n_taps]
    sidecar: FilterSidecar
    json_path: str | None = None

    @property
    def ratio(self) -> int:
        return self.sidecar.upsample_factor


def load_filter(json_path: str | os.PathLike) -> LoadedFilter:
    """Load and validate a .json sidecar + its .bin coefficient file.

    Mirrors the C++ loader's checks (vulkan_streaming_upsampler.cpp:606-724):
    sidecar invariants plus bin size == taps * 4 bytes.
    """
    json_path = os.fspath(json_path)
    with open(json_path, "r") as f:
        payload = json.load(f)
    sidecar = FilterSidecar.from_json(payload)
    bin_path = sidecar.coefficients_bin
    if not os.path.isabs(bin_path):
        bin_path = os.path.join(os.path.dirname(json_path), bin_path)
    size = os.path.getsize(bin_path)
    expected = sidecar.taps * 4
    if size != expected:
        raise ValueError(
            f"coefficient bin size mismatch: {bin_path} has {size} bytes, "
            f"expected taps*4 = {expected}"
        )
    taps = np.fromfile(bin_path, dtype="<f4")
    return LoadedFilter(taps=taps, sidecar=sidecar, json_path=json_path)


def save_filter(
    h: np.ndarray,
    out_dir: str | os.PathLike,
    basename: str,
    upsample_factor: int,
    metadata: dict | None = None,
    fft_size: int | None = None,
) -> str:
    """Export taps as float32 .bin + .json sidecar. Returns the json path."""
    out_dir = os.fspath(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    h32 = np.asarray(h, dtype="<f4")
    taps = len(h32)
    fft_size, block_size = overlap_save_geometry(taps, fft_size)
    if block_size % upsample_factor != 0:
        raise ValueError(
            f"derived block_size {block_size} not divisible by ratio "
            f"{upsample_factor}; pad taps with aligned_tap_count first"
        )
    bin_name = f"{basename}.bin"
    h32.tofile(os.path.join(out_dir, bin_name))
    payload = dict(metadata or {})
    payload.update(
        {
            "generation_date": datetime.datetime.now().isoformat(),
            "taps": taps,
            "fft_size": fft_size,
            "block_size": block_size,
            "coefficients_bin": bin_name,
            "upsample_factor": upsample_factor,
        }
    )
    json_path = os.path.join(out_dir, f"{basename}.json")
    with open(json_path, "w") as f:
        json.dump(payload, f, indent=1)
    return json_path
