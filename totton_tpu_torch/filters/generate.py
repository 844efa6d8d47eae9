"""Filter generation CLI.

TPU-framework equivalent of the reference's
``python -m scripts.filters.generate_minimum_phase --generate-all`` /
``generate_linear_phase`` entry points (generate_minimum_phase.py:245-325):
designs one or all of the eight multi-rate configs, validates, and exports
.bin + .json sidecars.

Usage:
  python -m totton_tpu_torch.filters.generate --generate-all --taps 80000 \
      --kaiser-beta 25 --stopband-attenuation 140 --output-dir data/coefficients
  python -m totton_tpu_torch.filters.generate --config 44k_16x --taps 80000
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os

import numpy as np

from totton_tpu_torch.filters.design import (
    MULTI_RATE_SPECS,
    FilterSpec,
    calculate_safe_gain,
    design_filter,
)
from totton_tpu_torch.filters.sidecar import save_filter
from totton_tpu_torch.filters.validate import validate_filter


def generate_one(
    key: str,
    n_taps: int,
    kaiser_beta: float,
    stopband_attenuation_db: float,
    phase: str,
    out_dir: str,
    fft_size: int | None = None,
) -> dict:
    """Design, validate and export one config. Returns summary facts."""
    spec = FilterSpec.from_multi_rate(
        key,
        n_taps=n_taps,
        kaiser_beta=kaiser_beta,
        stopband_attenuation_db=stopband_attenuation_db,
        phase=phase,
    )
    h, report = design_filter(spec)
    validation = validate_filter(
        h,
        sample_rate_output=spec.output_rate,
        passband_end_hz=spec.passband_end_hz,
        stopband_start_hz=spec.stopband_start_hz,
        target_stopband_attenuation_db=spec.stopband_attenuation_db,
        target_dc_gain=spec.target_dc_gain,
        phase=spec.phase,
    )
    metadata = dict(report)
    metadata["validation_results"] = validation
    basename = spec.basename(n_taps_label=n_taps)
    json_path = save_filter(
        h,
        out_dir,
        basename,
        upsample_factor=spec.upsample_ratio,
        metadata={
            **metadata,
            "sample_rate_input": spec.input_rate,
            "sample_rate_output": spec.output_rate,
            "output_basename": basename,
        },
        fft_size=fft_size,
    )
    return {
        "config": key,
        "json_path": json_path,
        "taps": len(h),
        "stopband_attenuation_db": validation["stopband_attenuation_db"],
        "passband_ripple_db": validation["passband_ripple_db"],
        "meets_stopband_spec": validation["meets_stopband_spec"],
        "max_coefficient_amplitude": float(np.max(np.abs(h))),
    }


def _worker(args: tuple) -> dict:
    return generate_one(*args)


def generate_all(
    n_taps: int,
    kaiser_beta: float,
    stopband_attenuation_db: float,
    phase: str,
    out_dir: str,
    parallel: bool = True,
    fft_size: int | None = None,
) -> list[dict]:
    jobs = [
        (key, n_taps, kaiser_beta, stopband_attenuation_db, phase, out_dir, fft_size)
        for key in MULTI_RATE_SPECS
    ]
    if parallel:
        with concurrent.futures.ProcessPoolExecutor() as pool:
            results = list(pool.map(_worker, jobs))
    else:
        results = [_worker(j) for j in jobs]
    return results


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--generate-all", action="store_true", help="all 8 multi-rate configs")
    p.add_argument("--config", choices=sorted(MULTI_RATE_SPECS), help="one config")
    p.add_argument("--taps", type=int, default=80000)
    p.add_argument("--kaiser-beta", type=float, default=25.0)
    p.add_argument("--stopband-attenuation", type=float, default=140.0)
    p.add_argument("--phase", choices=["minimum", "linear"], default="minimum")
    p.add_argument("--output-dir", default="data/coefficients")
    p.add_argument("--fft-size", type=int, default=None,
                   help="override overlap-save FFT size (power of two >= taps)")
    p.add_argument("--no-parallel", action="store_true")
    args = p.parse_args(argv)

    if not args.generate_all and not args.config:
        p.error("pass --generate-all or --config KEY")

    if args.generate_all:
        results = generate_all(
            args.taps,
            args.kaiser_beta,
            args.stopband_attenuation,
            args.phase,
            args.output_dir,
            parallel=not args.no_parallel,
            fft_size=args.fft_size,
        )
    else:
        results = [
            generate_one(
                args.config,
                args.taps,
                args.kaiser_beta,
                args.stopband_attenuation,
                args.phase,
                args.output_dir,
                fft_size=args.fft_size,
            )
        ]

    from totton_tpu_torch.filters.sidecar import load_filter

    filter_sets = {
        r["config"]: load_filter(r["json_path"]).taps for r in results
    }
    safe_gain = calculate_safe_gain(filter_sets)
    summary = {"filters": results, "safe_gain": safe_gain}
    summary_path = os.path.join(args.output_dir, "generation_summary.json")
    with open(summary_path, "w") as f:
        json.dump(summary, f, indent=1)
    for r in results:
        status = "OK " if r["meets_stopband_spec"] else "FAIL"
        print(
            f"[{status}] {r['config']}: taps={r['taps']} "
            f"stopband={r['stopband_attenuation_db']:.1f} dB "
            f"ripple={r['passband_ripple_db']:.2e} dB -> {r['json_path']}"
        )
    print(f"safe gain: {safe_gain['recommended_max_gain_db']:.2f} dB")
    return 0 if all(r["meets_stopband_spec"] for r in results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
