"""Audio-quality output validation.

Parity with the reference's validator (scripts/test/validate_output.py):
cross-correlation alignment, Pearson correlation >= 0.7, spectral cosine
similarity >= 0.8, |RMS difference| <= 6 dB — signal metrics rather than
bit-exactness. Usable as a library or CLI:

  python -m totton_tpu.testing.validate_output ref.wav out.wav [--ratio R]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

CORRELATION_THRESHOLD = 0.7
SPECTRAL_SIMILARITY_THRESHOLD = 0.8
RMS_DIFF_DB_THRESHOLD = 6.0


def _mono(x: np.ndarray) -> np.ndarray:
    x = np.atleast_2d(np.asarray(x, dtype=np.float64))
    return x.mean(axis=0)


def align_by_xcorr(ref: np.ndarray, out: np.ndarray, max_lag: int | None = None) -> int:
    """Lag (samples) that best aligns out to ref, via FFT cross-correlation."""
    n = min(len(ref), len(out))
    a, b = ref[:n], out[:n]
    size = 1 << int(np.ceil(np.log2(2 * n - 1)))
    corr = np.fft.irfft(np.fft.rfft(b, size) * np.conj(np.fft.rfft(a, size)), size)
    corr = np.concatenate([corr[-(n - 1) :], corr[:n]])
    lags = np.arange(-(n - 1), n)
    if max_lag is not None:
        mask = np.abs(lags) <= max_lag
        corr, lags = corr[mask], lags[mask]
    return int(lags[np.argmax(corr)])


def validate_audio(
    reference: np.ndarray,
    output: np.ndarray,
    output_ratio: int = 1,
) -> dict:
    """Compare output against reference (reference possibly at a lower rate:
    output is decimated by output_ratio before comparison).

    Returns a report dict with pass/fail per metric and overall.
    """
    ref = _mono(reference)
    out = _mono(output)
    if output_ratio > 1:
        out = out[::output_ratio]

    lag = align_by_xcorr(ref, out, max_lag=len(ref) // 4)
    if lag > 0:
        out_aligned = out[lag:]
        ref_aligned = ref[: len(out_aligned)]
    else:
        ref_aligned = ref[-lag:]
        out_aligned = out[: len(ref_aligned)]
    n = min(len(ref_aligned), len(out_aligned))
    ref_aligned, out_aligned = ref_aligned[:n], out_aligned[:n]
    if n < 16:
        return {"passed": False, "error": "signals too short after alignment"}

    denom = np.std(ref_aligned) * np.std(out_aligned)
    correlation = (
        float(np.mean((ref_aligned - ref_aligned.mean())
                      * (out_aligned - out_aligned.mean())) / denom)
        if denom > 0
        else 0.0
    )

    spec_ref = np.abs(np.fft.rfft(ref_aligned))
    spec_out = np.abs(np.fft.rfft(out_aligned))
    norm = np.linalg.norm(spec_ref) * np.linalg.norm(spec_out)
    spectral_similarity = (
        float(np.dot(spec_ref, spec_out) / norm) if norm > 0 else 0.0
    )

    rms_ref = np.sqrt(np.mean(ref_aligned**2))
    rms_out = np.sqrt(np.mean(out_aligned**2))
    rms_diff_db = (
        abs(20 * np.log10(max(rms_out, 1e-12) / max(rms_ref, 1e-12)))
    )

    checks = {
        "correlation": bool(correlation >= CORRELATION_THRESHOLD),
        "spectral_similarity": bool(
            spectral_similarity >= SPECTRAL_SIMILARITY_THRESHOLD
        ),
        "rms_diff_db": bool(rms_diff_db <= RMS_DIFF_DB_THRESHOLD),
    }
    return {
        "lag": int(lag),
        "correlation": float(correlation),
        "spectral_similarity": float(spectral_similarity),
        "rms_diff_db": float(rms_diff_db),
        "checks": checks,
        "passed": all(checks.values()),
    }


def main(argv: list[str] | None = None) -> int:
    from totton_tpu_torch.io.wav import read_wav

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("reference")
    p.add_argument("output")
    p.add_argument("--ratio", type=int, default=1,
                   help="output rate / reference rate")
    args = p.parse_args(argv)
    ref, _ = read_wav(args.reference)
    out, _ = read_wav(args.output)
    report = validate_audio(ref, out, args.ratio)
    print(json.dumps(report, indent=1))
    return 0 if report["passed"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
