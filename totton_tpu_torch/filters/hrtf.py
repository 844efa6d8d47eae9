"""HRTF crossfeed filter generator.

Parity with the reference's scripts/filters/generate_hrtf.py: builds
4-channel crossfeed filter sets (LL, LR, RL, RR) for headphone
speaker-simulation at +-30 degree virtual speakers:

- direct paths (LL, RR) are unity impulses (fully dry);
- cross paths (LR, RL) are contralateral HRIRs, resampled to the 705.6k /
  768k output rates with polyphase resampling and gain compensation,
  exponential tail taper, a high-frequency shelf tilt (keeps pinna
  character, ~-18 dB floor above ~2.5 kHz), -80 dB trim, and DC-gain
  normalization to -10 dB relative to the direct path;
- exported channel-major float32 .bin + .json sidecar, one set per head
  size (XS..XL) per rate family.

HRIR sources are pluggable:
- ``SofaHrirSource``: reads a HUTUBS-style SOFA (HDF5) file via h5py,
  picking the measurement nearest azimuth 330/30, elevation 0.
- ``SphericalHeadHrirSource``: analytic spherical-head model (Woodworth
  ITD + first-order head-shadow lowpass + distance-free pinna-less
  response) so filter sets can be generated without measurement data.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from pathlib import Path

import numpy as np
from scipy import signal as _signal

# Tuning constants (reference: generate_hrtf.py:59-107).
TRIM_THRESHOLD_DB = -80.0
CONTRALATERAL_TAIL_START_MS = 0.8
CONTRALATERAL_TAIL_DECAY_MS = 5.5
CROSSFEED_HF_CUTOFF_HZ = 2500.0
CROSSFEED_HF_MIN_GAIN_DB = -18.0
CROSSFEED_HF_SLOPE = 2.0
CROSSFEED_TARGET_DC_GAIN_DB = -10.0
TARGET_AZIMUTH_LEFT = 330.0  # HUTUBS convention: -30 deg == 330 deg
TARGET_AZIMUTH_RIGHT = 30.0
TARGET_ELEVATION = 0.0

RATE_CONFIGS = {
    "44k": {"input_rate": 44100, "output_rate": 705600, "ratio": 16},
    "48k": {"input_rate": 48000, "output_rate": 768000, "ratio": 16},
}

#: Head sizes -> spherical-head radius (m). The reference maps sizes to
#: HUTUBS subjects (pp77/pp6/pp20/pp32/pp53); the synthetic source maps
#: them to anthropometric radii instead.
HEAD_SIZES = {
    "XS": 0.0775,
    "S": 0.0825,
    "M": 0.0875,
    "L": 0.0925,
    "XL": 0.0975,
}


@dataclasses.dataclass
class HrirPair:
    """Contralateral HRIRs for the two virtual speakers.

    lr: left-speaker -> right-ear impulse response;
    rl: right-speaker -> left-ear impulse response; at ``sample_rate``.
    """

    lr: np.ndarray
    rl: np.ndarray
    sample_rate: int
    meta: dict = dataclasses.field(default_factory=dict)


class SphericalHeadHrirSource:
    """Analytic contralateral HRIR: Woodworth ITD delay + head-shadow
    lowpass (one-pole at f_c ~ c / (2*pi*a)) for a given head radius."""

    SPEED_OF_SOUND = 343.0

    def __init__(self, head_radius_m: float, sample_rate: int = 44100,
                 n_taps: int = 512) -> None:
        self.radius = head_radius_m
        self.sample_rate = sample_rate
        self.n_taps = n_taps

    def load(self) -> HrirPair:
        a = self.radius
        fs = self.sample_rate
        az = math.radians(30.0)
        # Woodworth contralateral ITD for a source at azimuth theta:
        # t = a/c * (theta + sin(theta)).
        itd = a / self.SPEED_OF_SOUND * (az + math.sin(az))
        delay = itd * fs
        # Head-shadow: first-order lowpass, corner from the sphere radius.
        fc = self.SPEED_OF_SOUND / (2 * math.pi * a)
        b, afilt = _signal.butter(1, min(fc, 0.45 * fs), fs=fs, btype="low")
        # Fractional-delay impulse via a windowed-sinc.
        n = np.arange(self.n_taps)
        frac_delay = np.sinc(n - delay) * np.hamming(self.n_taps)
        h = _signal.lfilter(b, afilt, frac_delay)
        # Contralateral level drop (shadowing) ~ -3 dB broadband.
        h *= 10.0 ** (-3.0 / 20.0)
        pair = HrirPair(
            lr=h.copy(), rl=h.copy(), sample_rate=fs,
            meta={"source": "spherical_head", "head_radius_m": a,
                  "itd_us": itd * 1e6},
        )
        return pair


class SofaHrirSource:
    """HUTUBS-style SOFA (HDF5) reader via h5py.

    Standard SOFA variables: Data.IR [M, R, N], SourcePosition [M, 3]
    (azimuth deg, elevation deg, distance), Data.SamplingRate.
    """

    def __init__(self, sofa_path: str | os.PathLike) -> None:
        self.path = Path(sofa_path)

    @staticmethod
    def _angular_distance(a: float, b: float) -> float:
        d = abs(a - b) % 360.0
        return min(d, 360.0 - d)

    def _nearest(self, positions: np.ndarray, azimuth: float,
                 elevation: float) -> int:
        az = np.array([self._angular_distance(p, azimuth)
                       for p in positions[:, 0]])
        el = np.abs(positions[:, 1] - elevation)
        return int(np.argmin(np.sqrt(az**2 + el**2)))

    def load(self) -> HrirPair:
        import h5py

        with h5py.File(self.path, "r") as f:
            ir = np.asarray(f["Data.IR"])  # [M, R, N]
            positions = np.asarray(f["SourcePosition"])
            rate = int(np.asarray(f["Data.SamplingRate"]).ravel()[0])
        idx_left = self._nearest(positions, TARGET_AZIMUTH_LEFT,
                                 TARGET_ELEVATION)
        idx_right = self._nearest(positions, TARGET_AZIMUTH_RIGHT,
                                  TARGET_ELEVATION)
        # Receiver 0 = left ear, 1 = right ear (SOFA convention).
        return HrirPair(
            lr=ir[idx_left, 1].astype(np.float64),   # left spk -> right ear
            rl=ir[idx_right, 0].astype(np.float64),  # right spk -> left ear
            sample_rate=rate,
            meta={
                "source": "sofa",
                "file": str(self.path),
                "position_left": positions[idx_left].tolist(),
                "position_right": positions[idx_right].tolist(),
            },
        )


# ----------------------------------------------------------- processing


def resample_hrir(h: np.ndarray, orig_rate: int, target_rate: int) -> np.ndarray:
    """Polyphase resample with amplitude compensation (impulse responses
    scale with the rate ratio; reference: generate_hrtf.py:334-363)."""
    if orig_rate == target_rate:
        return np.asarray(h, dtype=np.float64)
    g = math.gcd(target_rate, orig_rate)
    up, down = target_rate // g, orig_rate // g
    out = _signal.resample_poly(np.asarray(h, dtype=np.float64), up, down)
    # resample_poly preserves waveform amplitude; an impulse *response* must
    # preserve its frequency response instead, so rescale per-sample
    # amplitude by down/up to keep the DC gain (sum) constant.
    return out * (down / up)


def apply_exponential_tail_taper(
    h: np.ndarray, sample_rate: int,
    start_ms: float = CONTRALATERAL_TAIL_START_MS,
    decay_ms: float = CONTRALATERAL_TAIL_DECAY_MS,
) -> np.ndarray:
    """Exponential decay envelope after the first start_ms past the peak —
    suppresses late reflections while keeping the head-shadow onset."""
    h = np.asarray(h, dtype=np.float64).copy()
    peak = int(np.argmax(np.abs(h)))
    start = peak + int(start_ms * 1e-3 * sample_rate)
    if start >= len(h):
        return h
    t = np.arange(len(h) - start) / sample_rate
    h[start:] *= np.exp(-t / (decay_ms * 1e-3))
    return h


def apply_high_frequency_tilt(
    h: np.ndarray, sample_rate: int,
    cutoff_hz: float = CROSSFEED_HF_CUTOFF_HZ,
    min_gain_db: float = CROSSFEED_HF_MIN_GAIN_DB,
    slope: float = CROSSFEED_HF_SLOPE,
) -> np.ndarray:
    """Frequency-domain shelf: unity below cutoff, sloping to min_gain_db —
    a soft roll-off that keeps some pinna character (reference:
    generate_hrtf.py:174-196)."""
    n = len(h)
    n_fft = 1 << max(1, (2 * n - 1).bit_length())
    spectrum = np.fft.rfft(h, n_fft)
    freqs = np.fft.rfftfreq(n_fft, d=1.0 / sample_rate)
    min_gain = 10.0 ** (min_gain_db / 20.0)
    with np.errstate(divide="ignore"):
        octaves = np.log2(np.maximum(freqs, 1e-9) / cutoff_hz)
    gain = np.where(
        freqs <= cutoff_hz,
        1.0,
        np.maximum(min_gain, 10.0 ** (-slope * 3.0 * octaves / 20.0)),
    )
    out = np.fft.irfft(spectrum * gain, n_fft)[:n]
    return out


def trim_hrir(h: np.ndarray, threshold_db: float = TRIM_THRESHOLD_DB,
              pad: int = 16) -> np.ndarray:
    """Cut the tail below threshold_db relative to the peak (+pad)."""
    h = np.asarray(h, dtype=np.float64)
    peak = float(np.max(np.abs(h)))
    if peak == 0.0:
        return h
    above = np.flatnonzero(np.abs(h) >= peak * 10.0 ** (threshold_db / 20.0))
    if above.size == 0:
        return h
    end = min(len(h), int(above[-1]) + 1 + pad)
    return h[:end]


def make_direct_impulse(length: int) -> np.ndarray:
    out = np.zeros(length, dtype=np.float64)
    out[0] = 1.0
    return out


def normalize_cross_dc_gain(
    h: np.ndarray, target_db: float = CROSSFEED_TARGET_DC_GAIN_DB
) -> tuple[np.ndarray, float]:
    """Scale so DC gain == 10^(target_db/20) (cross level vs direct=1.0).
    DC (not peak) normalization keeps bass crossfeed stable across filter
    lengths (reference rationale: generate_hrtf.py:102-107)."""
    dc = float(np.sum(h))
    if dc == 0.0:
        return h, 0.0
    target = 10.0 ** (target_db / 20.0)
    scale = target / dc
    return h * scale, scale


def generate_crossfeed_set(
    pair: HrirPair,
    output_rate: int,
) -> tuple[np.ndarray, dict]:
    """Process one HRIR pair into the 4-channel set at the output rate.

    Returns ([4, n_taps] float64 channel-major LL, LR, RL, RR, report).
    """
    report: dict = {"output_rate": output_rate, **pair.meta}
    channels = []
    cross = []
    for name, h in (("lr", pair.lr), ("rl", pair.rl)):
        r = resample_hrir(h, pair.sample_rate, output_rate)
        r = apply_exponential_tail_taper(r, output_rate)
        r = apply_high_frequency_tilt(r, output_rate)
        r = trim_hrir(r)
        r, scale = normalize_cross_dc_gain(r)
        report[f"{name}_taps"] = len(r)
        report[f"{name}_dc_gain_db"] = 20.0 * math.log10(abs(np.sum(r)))
        cross.append(r)

    n = max(len(c) for c in cross)
    lr = np.pad(cross[0], (0, n - len(cross[0])))
    rl = np.pad(cross[1], (0, n - len(cross[1])))
    direct = make_direct_impulse(n)
    out = np.stack([direct, lr, rl, direct])  # LL, LR, RL, RR
    report["n_taps"] = n
    return out, report


def export_crossfeed_set(
    channels: np.ndarray,
    report: dict,
    out_dir: str | os.PathLike,
    basename: str,
) -> str:
    """Channel-major float32 .bin + .json sidecar. Returns the json path."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    data = np.ascontiguousarray(channels, dtype="<f4")
    bin_name = f"{basename}.bin"
    data.tofile(out_dir / bin_name)
    payload = {
        "coefficients_bin": bin_name,
        "channels": ["LL", "LR", "RL", "RR"],
        "n_channels": 4,
        "taps_per_channel": int(data.shape[1]),
        "layout": "channel_major",
        "source_azimuth_left": -30.0,
        "source_azimuth_right": TARGET_AZIMUTH_RIGHT,
        "source_elevation": TARGET_ELEVATION,
        "processing": {
            "tail_taper_start_ms": CONTRALATERAL_TAIL_START_MS,
            "tail_taper_decay_ms": CONTRALATERAL_TAIL_DECAY_MS,
            "hf_cutoff_hz": CROSSFEED_HF_CUTOFF_HZ,
            "hf_min_gain_db": CROSSFEED_HF_MIN_GAIN_DB,
            "trim_threshold_db": TRIM_THRESHOLD_DB,
            "crossfeed_target_dc_gain_db": CROSSFEED_TARGET_DC_GAIN_DB,
        },
        **report,
    }
    json_path = out_dir / f"{basename}.json"
    json_path.write_text(json.dumps(payload, indent=1))
    return str(json_path)


def generate_all(
    out_dir: str | os.PathLike,
    sizes: list[str] | None = None,
    families: list[str] | None = None,
    sofa_dir: str | os.PathLike | None = None,
) -> list[str]:
    """Generate crossfeed sets for head sizes x rate families.

    Uses SOFA measurements from sofa_dir when present (one file per size:
    <size>.sofa), else the spherical-head model.
    """
    sizes = sizes or list(HEAD_SIZES)
    families = families or list(RATE_CONFIGS)
    paths = []
    for size in sizes:
        sofa_path = Path(sofa_dir) / f"{size}.sofa" if sofa_dir else None
        for fam in families:
            rate = RATE_CONFIGS[fam]["output_rate"]
            if sofa_path is not None and sofa_path.exists():
                source = SofaHrirSource(sofa_path)
            else:
                source = SphericalHeadHrirSource(HEAD_SIZES[size])
            channels, report = generate_crossfeed_set(source.load(), rate)
            report["head_size"] = size
            basename = f"crossfeed_{fam}_{size.lower()}"
            paths.append(
                export_crossfeed_set(channels, report, out_dir, basename)
            )
    return paths


def main(argv: list[str] | None = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--output-dir", default="data/crossfeed/hrtf")
    p.add_argument("--sofa-dir", default=None,
                   help="directory of <size>.sofa files (else synthetic)")
    p.add_argument("--size", choices=sorted(HEAD_SIZES), default=None,
                   type=lambda s: s.upper())
    p.add_argument("--family", choices=sorted(RATE_CONFIGS), default=None)
    args = p.parse_args(argv)
    paths = generate_all(
        args.output_dir,
        sizes=[args.size] if args.size else None,
        families=[args.family] if args.family else None,
        sofa_dir=args.sofa_dir,
    )
    for path in paths:
        print(path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
