"""Filter visualization: validation plots and min-vs-linear phase comparison.

Parity with the reference's FilterPlotter (generate_filter.py:241-366) and
generate_phase_comparison_plots.py: impulse response, frequency response,
passband detail, and a 4-panel minimum-vs-linear comparison
(impulse / magnitude / phase / pre-ringing detail). Headless matplotlib
(Agg); every function returns the written paths.
"""

from __future__ import annotations

import math
import os
from pathlib import Path

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


def _response(h: np.ndarray, sample_rate: float, n_fft: int | None = None):
    h = np.asarray(h, dtype=np.float64)
    if n_fft is None:
        n_fft = 2 ** int(math.ceil(math.log2(max(8 * len(h), 1024))))
    spec = np.fft.rfft(h, n_fft)
    freqs = np.fft.rfftfreq(n_fft, d=1.0 / sample_rate)
    return freqs, spec


def plot_filter(
    h: np.ndarray,
    sample_rate: float,
    passband_end_hz: float,
    stopband_start_hz: float,
    out_dir: str | os.PathLike,
    basename: str,
) -> list[str]:
    """Three validation PNGs: impulse, full response, passband detail."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    h = np.asarray(h, dtype=np.float64)
    freqs, spec = _response(h, sample_rate)
    mag_db = 20 * np.log10(np.maximum(np.abs(spec), 1e-300))
    mag_db -= mag_db.max()
    paths = []

    fig, ax = plt.subplots(figsize=(10, 4))
    ax.plot(np.arange(len(h)) / sample_rate * 1e3, h, lw=0.6)
    ax.set_xlabel("time [ms]")
    ax.set_ylabel("amplitude")
    ax.set_title(f"{basename}: impulse response ({len(h)} taps)")
    p = out_dir / f"{basename}_impulse.png"
    fig.savefig(p, dpi=110, bbox_inches="tight")
    plt.close(fig)
    paths.append(str(p))

    fig, ax = plt.subplots(figsize=(10, 4))
    ax.semilogx(freqs[1:], mag_db[1:], lw=0.7)
    ax.axvline(passband_end_hz, color="g", ls="--", lw=0.8, label="passband end")
    ax.axvline(stopband_start_hz, color="r", ls="--", lw=0.8, label="stopband start")
    ax.set_ylim(-220, 5)
    ax.set_xlabel("frequency [Hz]")
    ax.set_ylabel("magnitude [dB]")
    ax.set_title(f"{basename}: frequency response")
    ax.legend()
    ax.grid(True, which="both", alpha=0.3)
    p = out_dir / f"{basename}_response.png"
    fig.savefig(p, dpi=110, bbox_inches="tight")
    plt.close(fig)
    paths.append(str(p))

    fig, ax = plt.subplots(figsize=(10, 4))
    band = freqs <= passband_end_hz * 1.2
    ax.plot(freqs[band], mag_db[band], lw=0.7)
    ax.set_xlabel("frequency [Hz]")
    ax.set_ylabel("magnitude [dB]")
    ax.set_title(f"{basename}: passband detail")
    ax.grid(True, alpha=0.3)
    p = out_dir / f"{basename}_passband.png"
    fig.savefig(p, dpi=110, bbox_inches="tight")
    plt.close(fig)
    paths.append(str(p))
    return paths


def plot_phase_comparison(
    h_min: np.ndarray,
    h_linear: np.ndarray,
    sample_rate: float,
    out_dir: str | os.PathLike,
    basename: str = "phase_comparison",
) -> str:
    """4-panel minimum-vs-linear comparison: impulse, magnitude, phase,
    pre-ringing zoom (the reference's headline plot)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    h_min = np.asarray(h_min, dtype=np.float64)
    h_linear = np.asarray(h_linear, dtype=np.float64)

    fig, axes = plt.subplots(2, 2, figsize=(13, 8))

    ax = axes[0, 0]
    t_ms = np.arange(max(len(h_min), len(h_linear))) / sample_rate * 1e3
    ax.plot(t_ms[: len(h_linear)], h_linear, label="linear", lw=0.6, alpha=0.8)
    ax.plot(t_ms[: len(h_min)], h_min, label="minimum", lw=0.6, alpha=0.8)
    ax.set_title("impulse response")
    ax.set_xlabel("time [ms]")
    ax.legend()

    ax = axes[0, 1]
    for h, label in ((h_linear, "linear"), (h_min, "minimum")):
        freqs, spec = _response(h, sample_rate)
        mag = 20 * np.log10(np.maximum(np.abs(spec), 1e-300))
        ax.semilogx(freqs[1:], mag[1:] - mag.max(), label=label, lw=0.7)
    ax.set_ylim(-220, 5)
    ax.set_title("magnitude response")
    ax.set_xlabel("frequency [Hz]")
    ax.legend()
    ax.grid(True, which="both", alpha=0.3)

    ax = axes[1, 0]
    for h, label in ((h_linear, "linear"), (h_min, "minimum")):
        freqs, spec = _response(h, sample_rate)
        band = (freqs > 10) & (freqs < sample_rate / 2 * 0.45)
        phase = np.unwrap(np.angle(spec[band]))
        ax.semilogx(freqs[band], phase, label=label, lw=0.7)
    ax.set_title("unwrapped phase")
    ax.set_xlabel("frequency [Hz]")
    ax.set_ylabel("phase [rad]")
    ax.legend()
    ax.grid(True, which="both", alpha=0.3)

    ax = axes[1, 1]
    # Pre-ringing: energy before the main peak.
    for h, label in ((h_linear, "linear"), (h_min, "minimum")):
        peak = int(np.argmax(np.abs(h)))
        start = max(0, peak - int(0.002 * sample_rate))
        seg = h[start : peak + int(0.002 * sample_rate)]
        t = (np.arange(len(seg)) + start - peak) / sample_rate * 1e3
        ax.plot(t, 20 * np.log10(np.maximum(np.abs(seg), 1e-12)),
                label=label, lw=0.7)
    ax.set_title("pre/post-ringing around the peak")
    ax.set_xlabel("time relative to peak [ms]")
    ax.set_ylabel("level [dB]")
    ax.legend()
    ax.grid(True, alpha=0.3)

    fig.suptitle(basename)
    fig.tight_layout()
    p = out_dir / f"{basename}.png"
    fig.savefig(p, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return str(p)


def main(argv: list[str] | None = None) -> int:
    """CLI: render the comparison for one multi-rate config.

    python -m totton_tpu_torch.filters.plots --config 44k_2x --taps 4000 --out plots/
    """
    import argparse

    from totton_tpu_torch.filters.design import (
        MULTI_RATE_SPECS,
        FilterSpec,
        design_filter,
    )

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", choices=sorted(MULTI_RATE_SPECS),
                   default="44k_2x")
    p.add_argument("--taps", type=int, default=4000)
    p.add_argument("--out", default="plots")
    args = p.parse_args(argv)

    spec_min = FilterSpec.from_multi_rate(args.config, n_taps=args.taps)
    spec_lin = FilterSpec.from_multi_rate(args.config, n_taps=args.taps,
                                          phase="linear")
    h_min, _ = design_filter(spec_min)
    h_lin, _ = design_filter(spec_lin)
    paths = plot_filter(
        h_min, spec_min.output_rate, spec_min.passband_end_hz,
        spec_min.stopband_start_hz, args.out, spec_min.basename(args.taps),
    )
    paths.append(plot_phase_comparison(
        h_min, h_lin, spec_min.output_rate, args.out,
        f"phase_comparison_{args.config}_{args.taps}",
    ))
    for path in paths:
        print(path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
