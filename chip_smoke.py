#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: python3 chip_smoke.py

Builds the port's CUDA frame kernel from this checkout's sources, checks it
against its plain torch version (at every frame count the main path gives
it) and against a float64 oracle, drives the port's main path
(``totton-stream-torch`` file mode, 16x / 80001 taps, stereo s16, the
bundled filter) through the kernel, times kernel and plain version and
each of the kernel's four launches, and prints one JSON line per kernel and
a final status line:

  {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": N}}

Exits non-zero, printing no result, without CUDA or outside the repository.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# The JAX package's __init__ would import jax under TOTTON_PLATFORM and
# create a compile-cache directory under $HOME; the port needs neither.
os.environ.pop("TOTTON_PLATFORM", None)
os.environ["TOTTON_COMPILE_CACHE"] = "0"
sys.path.insert(0, HERE)

FILTER_DIR = os.path.join(HERE, "data", "coefficients")
MAIN_FILTER = "filter_44k_16x_80000_min_phase"
PARITY_FILTERS = (MAIN_FILTER, "filter_44k_2x_80000_min_phase",
                  "filter_44k_16x_8000_min_phase")
REL_TOL = 1e-5       # kernel vs plain on the card (fp32, other sum order)
SNR_GATE_DB = 125.0  # vs the float64 oracle (bench.py's gate)
# Frame counts the main path hands the kernel besides its full 512-block
# stereo dispatch (1024 frames, checked in phase 6): the ragged 32/8/1-block
# tail dispatches (64, 16, 2), one off every tile edge (18), a round 128.
PARITY_FRAMES = (2, 16, 18, 64, 128)
LAUNCH_NAMES = {"FwdStage1Store": "F1", "FwdStage2Store": "F2",
                "InvStage1Store": "I1", "OutStore": "I2"}


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def kernel_vs_plain(frames, bundle, cfg) -> tuple[float, float]:
    """(rel, max abs) of the kernel's output against the plain version's on
    the same frames; raises if they disagree or the kernel's is not
    finite."""
    import torch

    from totton_tpu_torch.ops import fused_frames as ff
    from totton_tpu_torch.ops import overlap_save as osv

    y = ff.fused_upsample_frames(frames, bundle, cfg)
    ref = osv.upsample_frames(frames, bundle, cfg)
    err = (y - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    if not (rel < REL_TOL and torch.isfinite(y).all().item()):
        raise AssertionError(f"kernel disagrees with plain on "
                             f"{frames.shape[0]} frames: rel {rel:.3e}")
    return rel, err


def launch_times_ms(fn, reps: int = 3) -> dict[str, float] | None:
    """Device ms per launch of each of the kernel's four GEMMs (F1, F2, I1,
    I2) from torch.profiler, averaged over ``reps`` calls of fn(); None
    where the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if "cgemm" not in ev.key:
            continue
        us = max(getattr(ev, a, 0) or 0 for a in (
            "device_time_total", "self_device_time_total",
            "cuda_time_total", "self_cuda_time_total"))
        for store, label in LAUNCH_NAMES.items():
            if store in ev.key and us > 0:
                out[label] = us / 1e3 / ev.count
    return out if len(out) == len(LAUNCH_NAMES) else None


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_time_ms(fn, warmup: int = 2, reps: int = 5) -> float:
    """Median of ``reps`` CUDA-event timings of fn() after ``warmup``."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def main() -> int:
    try:
        import numpy as np
        import torch

        from totton_tpu.filters.sidecar import load_filter
        from totton_tpu_torch.ops import _build
        from totton_tpu_torch.ops import fused_frames as ff
        from totton_tpu_torch.ops import overlap_save as osv
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run it from the "
              "repository root", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA GPU", file=sys.stderr)
        return 1

    # 1. The card and the toolchain.
    card = card_line()
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    phase("env", f"card {card} | torch {torch.__version__} CUDA "
          f"{torch.version.cuda} | {nvcc[-1]}")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 must be off on the signal path")
    dev = torch.device("cuda")

    # 2. Build the kernel from the checkout's sources.
    t0 = time.monotonic()
    _build.load("fused_frames")
    phase("build", f"fused_frames built and loaded in "
          f"{time.monotonic() - t0:.2f} s")

    def engine_state(name):
        lf = load_filter(os.path.join(FILTER_DIR, name + ".json"))
        cfg = osv.OverlapSaveConfig.from_sidecar(lf.sidecar)
        spec = osv.filter_spectrum(lf.taps, cfg.fft_size, device=dev)
        return lf, cfg, osv.fold_bundle(spec, cfg)

    # 3. Kernel vs plain on the card at the main path's ragged frame counts.
    rng = np.random.default_rng(0)
    main_err = 0.0
    for name in PARITY_FILTERS:
        _, cfg, bundle = engine_state(name)
        rels = []
        for n in PARITY_FRAMES:
            frames = torch.from_numpy(
                (rng.normal(size=(n, cfg.frame_in)) * 0.3).astype(np.float32)
            ).to(dev)
            rel, err = kernel_vs_plain(frames, bundle, cfg)
            rels.append(f"{n}: {rel:.3e}")
            if name == MAIN_FILTER:
                main_err = max(main_err, err)
        phase("parity", f"{name}: kernel vs plain rel by frame count "
              f"{{{', '.join(rels)}}} (limit rel {REL_TOL:g})")

    # 4. Kernel vs the float64 oracle at 16x/80k, 32 blocks.
    lf, cfg, bundle = engine_state(MAIN_FILTER)
    snr_blocks = 32
    xs = (rng.normal(size=(1, cfg.halo_in + snr_blocks * cfg.block_in))
          * 0.3).astype(np.float32)
    xs_dev = torch.from_numpy(xs).to(dev)
    up = np.zeros(xs.shape[1] * cfg.ratio)
    up[::cfg.ratio] = xs[0]
    n_fft = 1 << int(np.ceil(np.log2(len(up) + cfg.taps - 1)))
    ref = np.fft.irfft(np.fft.rfft(up, n_fft)
                       * np.fft.rfft(lf.taps.astype(np.float64), n_fft),
                       n_fft)[: len(up)]
    ref = ref[cfg.halo_in * cfg.ratio:]

    def snr(y):
        y = y.cpu().numpy()[0].astype(np.float64)
        return 10 * np.log10(np.sum(ref ** 2) / np.sum((y - ref) ** 2))

    snr_db = snr(ff.fused_upsample_blocks(xs_dev, bundle, cfg))
    plain_db = snr(osv.upsample_blocks(xs_dev, bundle, cfg))
    phase("snr", f"16x/80k vs float64 oracle, {snr_blocks} blocks: kernel "
          f"{snr_db:.2f} dB, plain {plain_db:.2f} dB (gate > "
          f"{SNR_GATE_DB:g})")
    if not snr_db > SNR_GATE_DB:
        raise AssertionError(f"SNR {snr_db:.2f} dB below the gate")

    # 5. The main path: totton-stream-torch, file mode, 16x/80k stereo s16.
    from totton_tpu.io.wav import read_wav, write_wav
    from totton_tpu.testing.signals import sine
    from totton_tpu.testing.validate_output import validate_audio
    from totton_tpu_torch.cli import stream as stream_cli

    work = os.path.join(HERE, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        fs = 44100
        x = sine(1000.0, 40.0, fs, amplitude=0.5, channels=2)
        in_path = os.path.join(work, "in.wav")
        out_path = os.path.join(work, "out.wav")
        stats_path = os.path.join(work, "stats.json")
        write_wav(in_path, x, fs)
        ff.LAUNCHES = 0
        t0 = time.monotonic()
        rc = stream_cli.main([
            "--in", in_path, "--out", out_path, "--ratio", "16",
            "--filter-dir", FILTER_DIR, "--format", "s16",
            "--device", "cuda", "--stats-path", stats_path])
        wall = time.monotonic() - t0
        launches = ff.LAUNCHES
        if rc != 0:
            raise AssertionError(f"totton-stream-torch exited {rc}")
        with open(stats_path) as f:
            stats = json.load(f)
        y, rate = read_wav(out_path)
        report = validate_audio(x, y, output_ratio=16)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    phase("main", f"{x.shape[1] / fs:.0f} s stereo 44.1k -> {rate} Hz s16: "
          f"{stats['blocks_processed']} blocks, fused_frames launches "
          f"{launches}, realtime factor {stats['realtime_factor']:.1f}x "
          f"(session), wall {wall:.2f} s, validate_audio "
          f"{json.dumps(report, default=float)}")
    if not (report["passed"] and y.shape == (2, x.shape[1] * 16)
            and rate == fs * 16 and np.isfinite(y).all()):
        raise AssertionError("main-path output failed validation")
    if launches < 1:
        raise AssertionError("the main path never launched fused_frames")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    # 6. Kernel vs plain, compared and timed, one 16x/80k stereo dispatch.
    timings = {}
    saved = ff.LAUNCHES
    for blocks in (512, 1024):
        frames = torch.from_numpy(
            (rng.normal(size=(2 * blocks, cfg.frame_in)) * 0.3)
            .astype(np.float32)).to(dev)
        rel, err = kernel_vs_plain(frames, bundle, cfg)
        main_err = max(main_err, err)
        k_ms = cuda_time_ms(lambda: ff.fused_upsample_frames(frames, bundle, cfg))
        p_ms = cuda_time_ms(lambda: osv.upsample_frames(frames, bundle, cfg))
        out_samples = 2 * blocks * cfg.block_size
        timings[blocks] = (k_ms, p_ms)
        phase("time", f"{blocks} blocks stereo 16x/80k: kernel vs plain rel "
              f"{rel:.3e}; kernel {k_ms:.3f} ms "
              f"({out_samples / k_ms / 1e6:.3f} G samples/s), plain "
              f"{p_ms:.3f} ms ({out_samples / p_ms / 1e6:.3f} G samples/s) "
              f"on {card}")
        del frames
    torch.cuda.empty_cache()

    # 7. Device time of each of the kernel's four launches, 512 blocks.
    n = 2 * 512
    frames = torch.from_numpy(
        (rng.normal(size=(n, cfg.frame_in)) * 0.3).astype(np.float32)).to(dev)
    try:
        per_launch = launch_times_ms(
            lambda: ff.fused_upsample_frames(frames, bundle, cfg))
        why = "the profiler recorded no device time"
    except RuntimeError as e:  # the profiler, not the kernel, failed
        per_launch, why = None, f"profiler error: {e}"
    ff.LAUNCHES = saved
    del frames
    if per_launch is None:
        phase("launches", f"per-launch device time: not measured ({why})")
    else:
        flops = ff.flops_per_launch(cfg)
        parts = [f"{k} {per_launch[k]:.3f} ms "
                 f"({flops[k] * n / per_launch[k] / 1e9:.1f} TFLOP/s)"
                 for k in ("F1", "F2", "I1", "I2")]
        total = sum(per_launch.values())
        phase("launches", f"512 blocks stereo 16x/80k, torch.profiler: "
              f"{', '.join(parts)}; sum {total:.3f} ms "
              f"({ff.flops_per_frame(cfg) * n / total / 1e9:.1f} TFLOP/s) "
              f"on {card}")

    print(json.dumps({"kernels": [{
        "name": "fused_frames",
        "route": "cuda",
        "source": "totton_tpu_torch/csrc/fused_frames.cu",
        "replaces": "totton_tpu/experimental/pallas_kernels.py:284",
        "launches": launches,
        "max_abs_err": main_err,
        "ms": timings[512][0],
        "plain_ms": timings[512][1],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
