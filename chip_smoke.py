#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: python3 chip_smoke.py

Builds the port's CUDA frame kernel from this checkout's sources, checks it
against its plain torch version (at every frame count the main path gives
it, at every geometry the CLIs serve: 2x, 4x, 8x and 16x on its
three-launch plan (the 80k bank) and its resident one-launch plan (the 8k
bank), and ratio 1) and against a float64 oracle (the eight served
geometries), checks the classic odd-overlap program on the card, drives
the port's main path (``totton-stream-torch`` file mode, 16x / 80001 taps,
stereo s16, the bundled filter) through the kernel, and the CLI at 4x, 8x
and 8x low latency from 48 kHz (against the same command on the CPU),
times the kernel against its plain version and the same function composed
of ``torch.fft`` calls (cuFFT, the yardstick ``library_ms``) with a cold
L2 at the eight served geometries and ratio 1, computes the kernel's bound
from its work, times each of its launches (and fails if a dispatch
launches other than its plan's count), serves concurrent client streams
through the port's ``StreamServer`` (16x/80k f32 with a live filter swap;
the 16x/8k bank with device PCM and s16 clients) against the offline
kernel output, drives the serve plane's control surface and fault paths
(``totton-serve-torch`` with its control endpoint and a RELOAD to linear
phase under eight concurrent streams, a fleet leader and follower on the
one card, and tests/test_serve_chaos.py's client mix against an
in-process server), runs the kernel's ratio-1 branch through the CLI's EQ-only
mode (against the same command on the CPU), the threaded session, the
crossfeed chain (against a float64 2x2 convolution) and the live path (a
real-time socket sender, ``--threaded``, the in-process control endpoint
driven by a ``DaemonClient``), the sharded engine (``parallel/``: 1x1,
1x2 and 2x1 meshes over the one card against the plain engine, two gloo
processes on it through ``parallel.dryrun``, the CLI on a mesh, the serve
plane on a mesh) and ``trace_context`` around one dispatch. The web
plane (``totton-web-torch`` in its own process, with an OPRA fixture
database) steers the live stream over HTTP beside the ``DaemonClient``;
one of the low-latency serve streams goes through ``totton-serve-client-
torch``. The time-domain EQ cascade's kernel (``csrc/biquad_cascade.cu``,
built in parallel with the frame kernel) is checked against its plain
version and a float64 ``sosfilt``, streamed in chunks, timed, and swept
over 1, 10, 32 and 40 bands. The deployment layer runs as a service host
runs it (phase ``deploy``): the image's prebuild into an empty build
directory, then ``deploy/torch/entrypoint.sh`` in its stream, all and
serve modes, bare, each CLI in its own process on the card. Phase ``ci``
runs what the port's CI workflow cannot on a CPU runner: the cuda-marked
tests (``tests/test_torch_cuda.py``, in a pytest subprocess without the
conftest), ``scripts/torch/e2e_local_file_test.sh`` on the card against
the same script on the CPU, and the port's wheel, built offline and
installed into a venv, whose kernels build from the wheel's own sources
into a fresh cache and whose CLI runs on the card. It prints one JSON
line with both kernels and a final status line:

  {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": N}}

Exits non-zero, printing no result, without CUDA or outside the repository.
Imports nothing of JAX and nothing of the JAX package (``totton_tpu``).

``python3 chip_smoke.py --frames ROOT`` times only the frame kernel of the
checkout at ROOT (see ``frames_main``): run it on a parent commit and on
this tree in turns to compare the two on one card.
"""

from __future__ import annotations

import functools
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

FILTER_DIR = os.path.join(HERE, "data", "coefficients")
# Every geometry the CLIs serve (--ratio 2, 4, 8, 16 at --latency normal,
# the 80k bank, and low, the 8k bank), as the bank's 44.1k min-phase
# filter, keyed as the kernels line keys its readings: three-launch plans
# (the fused forward at 16x and 8x, the four-step forward at 4x and 2x),
# then resident ones (2x/8k is the resident plan's largest frame). The 48k
# family and the linear-phase filters add no geometry
# (tests/test_torch_chip_geometries.py).
SERVED = {f"{r}x_{k}k": f"filter_44k_{r}x_{k}000_min_phase"
          for k in (80, 8) for r in (16, 8, 4, 2)}
PARITY_FILTERS = tuple(SERVED.values())
MAIN_FILTER = SERVED["16x_80k"]
# The low-latency bank's 16x filter: the frame kernel's resident plan.
LOW_FILTER = SERVED["16x_8k"]
# The CLI in file mode at the served ratios the main path does not run
# (input rate, --ratio, --latency): 4x and 8x from 44.1 kHz on the 80k
# bank, 8x from 48 kHz on the 8k bank (the 48k family, by auto lookup).
CLI_RATIOS = ((44100, 4, "normal"), (44100, 8, "normal"), (48000, 8, "low"))
REL_TOL = 1e-5       # kernel vs plain on the card (fp32, other sum order)
SNR_GATE_DB = 125.0  # vs the float64 oracle (bench.py's gate)
SNR_BLOCKS = 32      # blocks of one channel against the oracle
# The classic odd-overlap program (even taps at ratio 1): its geometry
# and blocks against a float64 convolution.
CLASSIC_GEOMETRY = (1024, 4096, 1)
CLASSIC_BLOCKS = 32
# Frame counts the main path hands the kernel besides its full 512-block
# stereo dispatch (1024 frames, checked in phase 6): the ragged 32/8/1-block
# tail dispatches (64, 16, 2), one off every tile edge (18), a round 128,
# and the serve steps' rows x blocks (8 stereo slots at 2 and 16 blocks:
# 32, 256; 16 slots at 16 blocks: 512).
PARITY_FRAMES = (2, 16, 18, 32, 64, 128, 256, 512)
# Batch invariance: one stereo dispatch of SPLIT_BLOCKS blocks against the
# same frames dispatched in runs of SPLIT_RUNS frames in turn; each frame
# must get the same bits (max |diff| 0).
SPLIT_BLOCKS = 512
SPLIT_RUNS = (1, 3, 7, 64)
SPLIT_SEED = 11
RATE = 44100
SERVE_FADE = 4096    # output frames of the live swap's crossfade
# The frame kernel's device functions: fft_resident<M, H>, the resident
# plan's one launch (R), and fft_stage<N, INV, Load, Store>, the
# three-launch plan's, named by its store functor: the fused forward (F)
# or its two four-step launches (F1, F2), then I1 and I2.
FRAME_KERNELS = ("fft_resident", "fft_stage")
LAUNCH_NAMES = {"fft_resident": "R", "SpecStore": "F",
                "FwdStage1Store": "F1", "FwdStage2Store": "F2",
                "InvStage1Store": "I1", "OutStore": "I2"}
PROFILE_TRIES = 5  # profiler windows a reading takes until one keeps them all
PROFILE_REPS = 3   # dispatches a profiler window holds
# The card's peaks (NVIDIA's data sheet, H100 SXM at 700 W): fp32 on the
# CUDA cores and HBM3; bound_ms is the larger of the two times.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
L2_FLUSH_BYTES = 128 * 2**20  # more than the 50 MB L2
KERNELS = ("fused_frames", "biquad_cascade")
# The time-domain EQ cascade (phase iir): a 10-band APO profile of PK, LS
# and HS bands at 44.1 kHz, stereo; kernel vs plain at one 4096-sample
# chunk, the float64 oracle on IIR_SECONDS of noise.
IIR_PROFILE = """Preamp: -6 dB
Filter 1: ON PK Fc 31 Hz Gain 2.5 dB Q 1.2
Filter 2: ON LS Fc 105 Hz Gain 4 dB Q 0.7
Filter 3: ON PK Fc 220 Hz Gain -1.5 dB Q 1.4
Filter 4: ON PK Fc 500 Hz Gain 1 dB Q 2.0
Filter 5: ON PK Fc 1000 Hz Gain 3 dB Q 1.0
Filter 6: ON PK Fc 2200 Hz Gain -2 dB Q 3.0
Filter 7: ON PK Fc 4000 Hz Gain 2 dB Q 2.5
Filter 8: ON PK Fc 6500 Hz Gain -3 dB Q 4.0
Filter 9: ON HS Fc 8000 Hz Gain -2 dB Q 0.7
Filter 10: ON PK Fc 12000 Hz Gain 1.5 dB Q 1.0
"""
IIR_CHUNK = 4096
IIR_SECONDS = 20.0
# The band sweep (phase iir (f)): IIR_PROFILE's ten bands and thirty peaks
# more; each case takes the first S bands (S = 1, 10, 32: one launch each;
# 40: two). Cases above IIR_PLAIN_FULL_BANDS hold the kernel against the
# plain version on the chunk's first IIR_PLAIN_SHORT samples (the plain
# version runs ~13 small launches a band a sample, 0.18 ms a band a sample
# on an H100: 32 bands at 4096 samples would take ~24 s, at 64 samples
# 0.4 s).
IIR_SWEEP = (1, 10, 32, 40)
IIR_PROFILE_40 = IIR_PROFILE + "".join(
    f"Filter {11 + i}: ON PK Fc {300 + 500 * i} Hz Gain "
    f"{1 if i % 2 else -1} dB Q 2\n" for i in range(30))
IIR_PLAIN_FULL_BANDS = 10
IIR_PLAIN_SHORT = 64
# The float64 oracle's tolerance: the reference suite's
# (tests/test_eq.py::TestTimeDomainCascade, assert_allclose).
IIR_ORACLE_RTOL, IIR_ORACLE_ATOL = 1e-3, 2e-4
# Dependent-issue latency of an FP32 FMA, FMUL or FADD on NVIDIA's SMs
# since Volta (microbenchmarks: Jia et al., "Dissecting the NVIDIA Volta
# GPU Architecture via Microbenchmarking", 2018), in SM cycles.
FP32_LATENCY_CYCLES = 4
# An OPRA database for the web plane (shaped like tests/test_opra.py's
# fixture): nothing is downloaded.
OPRA_FIXTURE = "\n".join(json.dumps(e) for e in [
    {"type": "vendor", "id": "v1", "data": {"name": "Sennheiser"}},
    {"type": "product", "id": "p1", "data": {
        "name": "HD650", "vendor_id": "v1", "type": "headphone"}},
    {"type": "eq", "id": "e1", "data": {
        "product_id": "p1", "author": "oratory1990", "name": "HD650 EQ",
        "parameters": {"gain_db": -6.4, "bands": [
            {"type": "peak_dip", "frequency": 200, "gain_db": -2.0,
             "q": 0.6},
            {"type": "low_shelf", "frequency": 105, "gain_db": 4.0,
             "q": 0.7},
            {"type": "high_pass", "frequency": 20, "slope": 12}]}}},
])


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


def split_runs(n: int) -> list[tuple[int, int]]:
    """[lo, hi) runs of SPLIT_RUNS frames in turn covering n frames."""
    runs, lo = [], 0
    while lo < n:
        hi = min(n, lo + SPLIT_RUNS[len(runs) % len(SPLIT_RUNS)])
        runs.append((lo, hi))
        lo = hi
    return runs


def split_diff(program, frames) -> float:
    """Max |diff| between program(frames) on [C, N, ...] frames in one
    dispatch and the same frames dispatched as ``split_runs(N)`` along
    axis 1, concatenated."""
    import torch

    whole = program(frames)
    parts = torch.cat([program(frames[:, lo:hi])
                       for lo, hi in split_runs(frames.shape[1])], dim=1)
    return (parts - whole).abs().max().item()


def split_frames(frame_in: int, device):
    """SPLIT_BLOCKS seeded stereo frames [2, SPLIT_BLOCKS, frame_in] from a
    generator of their own (SPLIT_SEED), so that the split checks leave
    the phases' generators as they were."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SPLIT_SEED)
    return torch.from_numpy((rng.normal(size=(2, SPLIT_BLOCKS, frame_in))
                             * 0.3).astype(np.float32)).to(device)


def kernel_split_diff(bundle, cfg) -> float:
    """split_diff of the frame kernel on split_frames (each run one launch
    of [2 * run, frame_in] frames, as ``fused_upsample_blocks`` hands them
    over)."""
    from totton_tpu_torch.ops import fused_frames as ff

    def kernel(f):
        y = ff.fused_upsample_frames(f.reshape(-1, cfg.frame_in).contiguous(),
                                     bundle, cfg)
        return y.reshape(f.shape[0], f.shape[1], -1)

    return split_diff(kernel, split_frames(cfg.frame_in,
                                           bundle.weights.device))


def launch_times_ms(fn, reps: int = 3):
    """(device ms per launch of each of the frame kernel's launches the
    profiler saw, by label (LAUNCH_NAMES: R, or F, I1, I2, ...), the
    records each label kept) from torch.profiler over ``reps`` calls of
    fn(), each after an L2 flush; (None, None) where the profiler records
    no device time. The window ends with one more flush, so the last
    frame launch is not the window's last device record (Kineto drops
    late records, C13)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush_l2()
            fn()
        flush_l2()
        torch.cuda.synchronize()
    out, counts = {}, {}
    for ev in prof.key_averages():
        if not any(k in ev.key for k in FRAME_KERNELS):
            continue
        us = max(getattr(ev, a, 0) or 0 for a in (
            "device_time_total", "self_device_time_total",
            "cuda_time_total", "self_cuda_time_total"))
        for store, label in LAUNCH_NAMES.items():
            if store in ev.key and us > 0:
                out[label] = us / 1e3 / ev.count
                counts[label] = counts.get(label, 0) + ev.count
    if not out:
        return None, None
    return out, counts


def kernel_bound_ms(cfg, n_frames: int):
    """({"operations": ms, "bytes": ms}, the side that sets the bound) for
    one dispatch of ``n_frames``: the FLOPs the function needs at the fp32
    peak, the bytes each input read and each output written once at the
    HBM rate."""
    from totton_tpu_torch.ops import fused_frames as ff

    bound = {"operations": (ff.flops_per_frame(cfg) * n_frames
                            / PEAK_FP32_FLOPS * 1e3),
             "bytes": ff.bound_bytes(cfg, n_frames) / PEAK_BYTES_S * 1e3}
    return bound, max(bound, key=bound.get)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def card_max_sm_mhz() -> float:
    """The card's highest SM clock (MHz), as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0])


def build_kernels() -> dict[str, float]:
    """Every kernel of the port built from this checkout's sources, one
    nvcc each, all started together; then loaded. Returns each build's
    seconds."""
    import concurrent.futures

    from totton_tpu_torch.ops import _build

    def timed(name):
        t0 = time.monotonic()
        _build.build(name)
        return time.monotonic() - t0

    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        seconds = dict(zip(KERNELS, pool.map(timed, KERNELS)))
    for name in KERNELS:
        _build.load(name)
    return seconds


@functools.lru_cache(maxsize=1)
def _flush_buffer():
    import torch

    return torch.empty(L2_FLUSH_BYTES // 4, device="cuda")


def flush_l2() -> None:
    """Overwrite more than the card's L2, so the next launch meets a cold
    cache as the main path's dispatches do."""
    _flush_buffer().zero_()


def cuda_time_ms(fn, warmup: int = 2, reps: int = 5) -> float:
    """Median of ``reps`` CUDA-event timings of fn() after ``warmup``, the
    L2 flushed before each (outside the timed span)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush_l2()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def launch_ms(fn, reps: int = 20, batches: int = 3) -> float:
    """Device ms per call of fn(): the median over ``batches`` of CUDA
    events around ``reps`` calls back to back, so the host's enqueue of
    one call overlaps the device's run of the one before (what a short
    kernel's one-call event span cannot show)."""
    import torch

    fn()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[len(times) // 2]


def graph_ms(fn, reps: int = 5) -> float:
    """Device ms of one fn(), without the host's launch pace: fn captured
    once in a CUDA graph, then the median of ``reps`` replays between
    CUDA events, each after an L2 flush."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_time_ms(graph.replay, warmup=1, reps=reps)


def library_frames(frames, hspec, cfg):
    """The yardstick: the classic overlap-save program on cuFFT through
    ``torch.fft`` (rfft of each frame, periodic extension to the
    zero-stuffed length, x H, irfft of fft_size points, the overlap
    discarded). Timed beside the kernel; the port never calls it."""
    import torch

    x = torch.fft.rfft(frames, dim=-1)
    if cfg.ratio > 1:
        full = torch.cat([x, x[..., 1:-1].flip(-1).conj()], -1)
        x = torch.cat([full.repeat(1, cfg.ratio // 2), x[..., :1]], -1)
    return torch.fft.irfft(x * hspec, n=cfg.fft_size)[..., cfg.overlap:]


def frame_reading(label, cfg, bundle, hspec, rng, blocks=512) -> dict:
    """One stereo dispatch of ``blocks`` blocks (2 x blocks frames) of
    ``cfg`` on the card: kernel vs plain (rel) and the torch.fft
    composition vs plain; the three timed in turns (kernel, plain,
    library, library, plain, kernel; the lower of each one's two medians
    of 5), the L2 flushed before every run; the wrapper's host time to
    enqueue the kernel (the median of 21 calls on an idle card); the
    bound; each launch's device ms and the launches a dispatch
    (torch.profiler), which must equal the plan's (``flops_per_launch``)
    or the run fails.
    Leaves fused_frames.LAUNCHES as it found it."""
    import numpy as np
    import torch

    from totton_tpu_torch.ops import fused_frames as ff
    from totton_tpu_torch.ops import overlap_save as osv

    n = 2 * blocks
    saved = ff.LAUNCHES
    frames = torch.from_numpy((rng.normal(size=(n, cfg.frame_in)) * 0.3)
                              .astype(np.float32)).to("cuda")
    rel, err = kernel_vs_plain(frames, bundle, cfg)
    ref = osv.upsample_frames(frames, bundle, cfg)
    lib_rel = ((library_frames(frames, hspec, cfg) - ref).abs().max()
               / ref.abs().max()).item()
    del ref
    fns = {"kernel": lambda: ff.fused_upsample_frames(frames, bundle, cfg),
           "plain": lambda: osv.upsample_frames(frames, bundle, cfg),
           "library": lambda: library_frames(frames, hspec, cfg)}
    runs = {k: [] for k in fns}
    for k in ("kernel", "plain", "library", "library", "plain", "kernel"):
        runs[k].append(cuda_time_ms(fns[k], reps=5))
    ms = {k: min(v) for k, v in runs.items()}
    host = []
    for _ in range(21):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fns["kernel"]()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    bound, bound_by = kernel_bound_ms(cfg, n)
    labels = list(ff.flops_per_launch(cfg))
    per_launch = per_dispatch = None
    windows, dropped = 0, []
    why = f"the profiler recorded no device time in {PROFILE_TRIES} windows"
    try:
        # Kineto drops a window's device records now and then, all of them
        # or the late ones (C13): a window that did not keep every launch
        # of every dispatch is taken again. A launch the plan does not
        # have, or more launches than it has, fails the run.
        for windows in range(1, PROFILE_TRIES + 1):
            seen, counts = launch_times_ms(fns["kernel"], reps=PROFILE_REPS)
            if seen is None:
                continue
            if (set(counts) - set(labels)
                    or max(counts.values()) > PROFILE_REPS):
                raise AssertionError(
                    f"{label}: the profiler saw {counts} kernel launches in "
                    f"{PROFILE_REPS} dispatches; the plan has {labels} once "
                    f"each")
            if all(counts.get(x) == PROFILE_REPS for x in labels):
                per_launch, per_dispatch = seen, len(labels)
                break
            dropped.append(counts)
        if per_dispatch is None and dropped:
            why = (f"the profiler dropped device records in every one of "
                   f"{PROFILE_TRIES} windows (kept {dropped} of "
                   f"{PROFILE_REPS} dispatches)")
    except RuntimeError as e:  # the profiler, not the kernel, failed
        why = f"profiler error: {e}"
    ff.LAUNCHES = saved
    del frames
    return dict(label=label, cfg=cfg, blocks=blocks, rel=rel, err=err,
                lib_rel=lib_rel, ms=ms, host_ms=sorted(host)[10], medians={
                    k: [round(v, 4) for v in r] for k, r in runs.items()},
                bound=bound, bound_by=bound_by, labels=labels,
                per_launch=per_launch, per_dispatch=per_dispatch, why=why,
                windows=windows)


def reading_line(r: dict, card: str) -> str:
    """A frame_reading as one phase line."""
    from totton_tpu_torch.ops import fused_frames as ff

    cfg, n = r["cfg"], 2 * r["blocks"]
    k, p, lib = r["ms"]["kernel"], r["ms"]["plain"], r["ms"]["library"]
    b = r["bound"][r["bound_by"]]
    if r["per_launch"] is None:
        launches = f"launches a dispatch and per launch: not measured " \
                   f"({r['why']})"
    else:
        by = ff.bytes_per_launch(cfg)
        launches = (f"{r['per_dispatch']:g} launch"
                    f"{'es' if r['per_dispatch'] != 1 else ''} a dispatch "
                    f"(plan {len(r['labels'])}): " + ", ".join(
                        f"{x} {r['per_launch'][x]:.4f} ms "
                        f"({by[x] * n / r['per_launch'][x] / 1e6:.0f} GB/s)"
                        for x in r["labels"])
                    + f" (profiler window {r['windows']} of {PROFILE_TRIES})")
    return (f"{r['blocks']} blocks stereo {r['label']}, cold L2: kernel vs "
            f"plain rel {r['rel']:.3e}, torch.fft composition vs plain rel "
            f"{r['lib_rel']:.3e}; kernel {k:.4f} ms "
            f"({n * cfg.block_size / k / 1e6:.3f} G samples/s; the wrapper's "
            f"host time to enqueue it {r['host_ms']:.4f} ms), plain "
            f"{p:.3f} ms, torch.fft composition {lib:.4f} ms (the lower of "
            f"two medians of 5; medians {json.dumps(r['medians'])}); bound "
            f"{b:.4f} ms ({r['bound_by']}; operations "
            f"{r['bound']['operations']:.4f}, bytes "
            f"{r['bound']['bytes']:.4f}): kernel at {b / k:.1%} of it, "
            f"torch.fft at {b / lib:.1%}; {launches} on {card}")


def reading_entry(r: dict) -> dict:
    """A frame_reading's numbers for the kernels line."""
    return {"ms": r["ms"]["kernel"], "plain_ms": r["ms"]["plain"],
            "library_ms": r["ms"]["library"],
            "bound_ms": r["bound"][r["bound_by"]], "bound_by": r["bound_by"],
            "launches_per_dispatch": r["per_dispatch"],
            "max_abs_err": r["err"]}


def engine_state(name, dev):
    """(filter, cfg, folded bundle, torch.fft spectrum) of the bundled
    filter ``name`` on ``dev``."""
    import numpy as np
    import torch

    from totton_tpu_torch.filters.sidecar import load_filter
    from totton_tpu_torch.ops import overlap_save as osv

    lf = load_filter(os.path.join(FILTER_DIR, name + ".json"))
    cfg = osv.OverlapSaveConfig.from_sidecar(lf.sidecar)
    spec = osv.filter_spectrum(lf.taps, cfg.fft_size, device=dev)
    bundle = osv.fold_bundle(spec, cfg)
    hspec = torch.fft.rfft(torch.from_numpy(lf.taps.astype(np.float64))
                           .to(dev), n=cfg.fft_size).to(torch.complex64)
    return lf, cfg, bundle, hspec


def snr_db(lf, cfg, bundle, rng, blocks=SNR_BLOCKS) -> tuple[float, float]:
    """(kernel, plain) SNR in dB of ``blocks`` blocks of one seeded
    channel through ``lf`` on the card, against the float64 oracle: the
    zero-stuffed input convolved with the taps by a float64 FFT."""
    import numpy as np
    import torch

    from totton_tpu_torch.ops import fused_frames as ff
    from totton_tpu_torch.ops import overlap_save as osv

    xs = (rng.normal(size=(1, cfg.halo_in + blocks * cfg.block_in))
          * 0.3).astype(np.float32)
    xs_dev = torch.from_numpy(xs).to("cuda")
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

    return (snr(ff.fused_upsample_blocks(xs_dev, bundle, cfg)),
            snr(osv.upsample_blocks(xs_dev, bundle, cfg)))


def classic_phase(card, rng, device="cuda", blocks=CLASSIC_BLOCKS) -> None:
    """The classic odd-overlap program (``overlap_save.
    _upsample_frames_classic``: even taps at ratio 1, no kernel; its DFTs
    are matmuls) on ``device`` at CLASSIC_GEOMETRY: rel against the same
    program on the CPU, and the SNR of both against a float64
    convolution; then SPLIT_BLOCKS stereo blocks on ``device`` in one
    dispatch against runs of SPLIT_RUNS (split_diff) and that dispatch's
    time. Fails on a wrong shape, a non-finite output or a split max
    |diff| other than 0: an SNR below the gate is a finding, printed as
    such."""
    import numpy as np
    import torch

    from totton_tpu_torch.ops import overlap_save as osv

    taps, fft, ratio = CLASSIC_GEOMETRY
    cfg = osv.OverlapSaveConfig(taps, fft, fft - taps + 1, ratio)
    h = rng.normal(size=taps) * np.exp(-np.arange(taps) / (taps / 8))
    x = (rng.normal(size=(1, cfg.halo_in + blocks * cfg.block_in))
         * 0.3).astype(np.float32)
    ys, bundles = {}, {}
    for dev in (device, "cpu"):
        bundle = osv.fold_bundle(osv.filter_spectrum(h, fft, device=dev), cfg)
        if not bundle.classic:
            raise AssertionError("an odd overlap must fold the classic bundle")
        bundles[dev] = bundle
        ys[dev] = osv.upsample_blocks(torch.from_numpy(x).to(dev), bundle,
                                      cfg).cpu().numpy()[0].astype(np.float64)
    ref = np.convolve(x[0].astype(np.float64), h)[cfg.halo_in:
                                                  cfg.halo_in
                                                  + blocks * cfg.block_size]
    y = ys[device]
    if not (y.shape == ref.shape and np.isfinite(y).all()):
        raise AssertionError(f"classic program on {device}: shape "
                             f"{y.shape}, expected {ref.shape}")
    rel = float(np.abs(y - ys["cpu"]).max() / np.abs(ys["cpu"]).max())
    snrs = {d: 10 * np.log10(np.sum(ref ** 2) / np.sum((v - ref) ** 2))
            for d, v in ys.items()}
    gate = "passed" if min(snrs.values()) > SNR_GATE_DB else "MISSED"
    # Batch invariance on the device, and the time of one such dispatch.
    frames = split_frames(cfg.frame_in, device)

    def program(f):
        return osv.upsample_frames(f, bundles[device], cfg)

    split = split_diff(program, frames)
    ms = (cuda_time_ms(lambda: program(frames)) if device == "cuda"
          else float("nan"))
    phase("classic", f"odd overlap ({taps} taps, fft {fft}, ratio {ratio}; "
          f"the classic program, matmul DFTs, no kernel), {blocks} blocks of "
          f"one channel: {device} vs cpu rel {rel:.3e}; vs float64 "
          f"convolution {device} {snrs[device]:.2f} dB, cpu "
          f"{snrs['cpu']:.2f} dB (gate > {SNR_GATE_DB:g}: {gate}); "
          f"{SPLIT_BLOCKS} stereo blocks on {device} in runs of "
          f"{', '.join(map(str, SPLIT_RUNS))} vs one dispatch: max |diff| "
          f"{split:g} (limit 0), one dispatch {ms:.3f} ms on the device "
          f"(median of 5, L2 flushed) on {card}")
    if split != 0:
        raise AssertionError(f"classic program on {device}: a frame's output "
                             f"depends on its dispatch (max |diff| {split:g})")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_clients(port, signals, fmt=None, split=None, swap=None, cli=None):
    """Stream each [2, n] signal through its own ServeClient, all connected
    at once, each sent in 1 s bursts from a pump thread while its reply is
    read. A stream i in ``split`` (i -> input frames) holds after that many
    frames until ``swap()`` has run; swap() runs once every held stream has
    read its first part's output and every other stream has finished. A
    stream i in ``cli`` (i -> work directory; s16 only) goes through
    totton-serve-client-torch's main instead, WAV in and WAV out.
    Returns (outputs, wall seconds from connect to the last reply byte)."""
    import threading

    import numpy as np

    from totton_tpu_torch.io.serve_client import ServeClient

    split = split or {}
    cli = cli or {}
    outs = [None] * len(signals)
    errors = []
    gate = threading.Event()
    first = {i: threading.Event() for i in split}

    def stream(i, x):
        if i in cli:
            try:
                outs[i] = serve_client_cli(port, x, cli[i], i)
            except Exception as e:  # raised in the caller
                errors.append((i, e))
            return
        try:
            with ServeClient(f"tcp://127.0.0.1:{port}", x.shape[0], RATE,
                             fmt=fmt) as c:
                cut = split.get(i, x.shape[1])

                def pump():
                    for a, b in ((0, cut), (cut, x.shape[1])):
                        if a == cut and i in split:
                            gate.wait(timeout=300)
                        for j in range(a, b, RATE):
                            c.send(x[:, j:min(j + RATE, b)])
                    c.end_input()

                t = threading.Thread(target=pump)
                t.start()
                parts, got = [], 0
                while (y := c.read_frames()) is not None:
                    parts.append(y)
                    got += y.shape[1]
                    if i in first and got >= cut * c.ratio:
                        first[i].set()
                t.join(timeout=300)
                outs[i] = np.concatenate(parts, axis=1)
        except Exception as e:  # raised in the caller
            errors.append((i, e))
            for ev in first.values():
                ev.set()
            gate.set()

    threads = [threading.Thread(target=stream, args=(i, x))
               for i, x in enumerate(signals)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for i, t in enumerate(threads):
        if i not in split:
            t.join(timeout=300)
    for ev in first.values():
        ev.wait(timeout=300)
    if split and not errors:
        swap()
    gate.set()
    for t in threads:
        t.join(timeout=300)
    wall = time.monotonic() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"serve clients failed: {errors}")
    return outs, wall


def serve_client_cli(port, x, work, i):
    """[2, n] float32 through ``totton-serve-client-torch`` (its main, in
    this thread): x written as an s16 WAV, streamed with the s16 wire
    format, the reply written as an s16 WAV and read back."""
    from totton_tpu_torch.cli import serve_client
    from totton_tpu_torch.io.pcm import PcmFormat
    from totton_tpu_torch.io.wav import read_wav, write_wav

    src = os.path.join(work, f"client_{i}_in.wav")
    dst = os.path.join(work, f"client_{i}_out.wav")
    write_wav(src, x, RATE, PcmFormat.S16_LE)
    rc = serve_client.main(["--server", f"tcp://127.0.0.1:{port}", "--in",
                            src, "--out", dst, "--format", "s16",
                            "--wire-format", "s16", "--timeout", "300"])
    if rc != 0:
        raise AssertionError(f"totton-serve-client-torch exited {rc}")
    return read_wav(dst)[0]


def serve_figures(server, wall: float) -> str:
    """steps_by_shape, avg_step_drain_ms, aggregate output samples/s and
    each served slot's latency p50/p95 (ms), as one line."""
    j = server.stats.to_json(0, [])
    lat = [server._slot_status(s)["latency_ms"] for s in server.slots
           if s.lat_ms]
    lat_s = ", ".join(f"{d['p50']:.2f}/{d['p95']:.2f}" for d in lat)
    rate = j["frames_out"] * server.channels / wall
    return (f"steps_by_shape {json.dumps(j['steps_by_shape'])}, "
            f"avg_step_drain_ms {j['avg_step_drain_ms']}, aggregate "
            f"{rate / 1e6:.2f} M output samples/s over {wall:.2f} s, "
            f"latency p50/p95 ms by stream [{lat_s}]")


def step_costs_ms(server, shapes) -> list[str]:
    """Host ms of one whole serve step (pinned upload, the kernel, the
    pinned download and its event wait) at each (slots, blocks) shape,
    run three times in a row after emptying torch's device and pinned-host
    caches: the first time a shape occurs against the steady cost; and
    the step's peak device memory above what was allocated before it."""
    import numpy as np
    import torch

    from totton_tpu_torch.engine.upsampler import download, fetch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    host_empty = getattr(torch._C, "_host_emptyCache", None)
    if host_empty is not None:
        host_empty()
    cfg = server.config
    out = []
    for width, k in shapes:
        rows = width * server.channels
        times = []
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for _ in range(3):
            t0 = time.perf_counter()
            tj = server._to_device(np.zeros((rows, cfg.halo_in), np.float32))
            xj = server._to_device(
                np.zeros((rows, k * cfg.block_in), np.float32))
            fetch(download(server._step(tj, xj, server._bundle)[0]))
            times.append((time.perf_counter() - t0) * 1e3)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        out.append(f"{width}x{k}: " + "/".join(f"{t:.1f}" for t in times)
                   + f" ms, peak {peak:.0f} MiB")
    return out


def seeded_signal(seconds: float, seed: int):
    """[2, n] float32 at RATE: two tones and a little seeded noise."""
    import numpy as np

    r = np.random.default_rng(seed)
    t = np.arange(int(seconds * RATE)) / RATE
    f0 = 300.0 + 170.0 * seed
    tones = np.stack([0.4 * np.sin(2 * np.pi * f0 * t),
                      0.3 * np.sin(2 * np.pi * 1.5 * f0 * t)])
    return (tones + r.normal(size=tones.shape) * 0.02).astype(np.float32)


def rel_err(y, ref) -> float:
    import numpy as np

    if y.shape != ref.shape:
        raise AssertionError(f"reply shape {y.shape} != {ref.shape}")
    return float(np.abs(y - ref).max() / np.abs(ref).max())


def serve_phase(card, lf, lin, device, seconds=(2.0, 3.5, 5.0, 7.3),
                held_blocks=20):
    """Serve one f32 stream per entry of ``seconds`` at once on an 8-slot
    StreamServer, each sent in bursts (so steps take several blocks), and
    swap to ``lin`` by load_filter while streams 2 and 3 are live. Gates:
    streams 0-1 equal the offline upsample_signal (same kernel) and pass
    validate_audio; streams 2-3 equal the crossfade model; fused_frames
    launched; the server did not fail; no jax. Returns (launches, the
    stopped server)."""
    import numpy as np

    from totton_tpu_torch.testing.validate_output import validate_audio
    from totton_tpu_torch.engine.upsampler import upsample_signal
    from totton_tpu_torch.ops import fused_frames as ff
    from totton_tpu_torch.serve import StreamServer

    port = free_port()
    ff.LAUNCHES = 0
    server = StreamServer(lf, f"tcp-listen://127.0.0.1:{port}", RATE,
                          max_streams=8, channels=2,
                          swap_fade_frames=SERVE_FADE, device=device)
    t0 = time.monotonic()
    server.start()
    warm_s = time.monotonic() - t0
    cfg = server.config
    sigs = [seeded_signal(s, i) for i, s in enumerate(seconds)]
    held = held_blocks * cfg.block_in  # input frames before the swap

    def swap():
        server.load_filter(lin)
        deadline = time.monotonic() + 60
        while server.stats.spectrum_swaps < 1:
            if time.monotonic() > deadline:
                raise AssertionError("the live swap never applied")
            time.sleep(0.01)

    outs, wall = run_clients(port, sigs, split={2: held, 3: held}, swap=swap)
    server.stop()
    launches = ff.LAUNCHES
    figures = serve_figures(server, wall)
    if server.failed or (device == "cuda" and launches < 1):
        raise AssertionError(f"serve failed={server.failed}, fused_frames "
                             f"launches {launches}")
    rels = []
    for i, (x, y) in enumerate(zip(sigs, outs)):
        ref = upsample_signal(x, lf, device=device)
        if i < 2:
            report = validate_audio(x, y, output_ratio=cfg.ratio)
            if not report["passed"]:
                raise AssertionError(f"stream {i} failed validate_audio: "
                                     f"{report}")
        else:
            # The fade starts at this stream's first output sample after
            # the held part (tests/test_serve_control.py fade model).
            new = upsample_signal(x, lin, device=device)
            p = held * cfg.ratio
            n = min(SERVE_FADE, ref.shape[1] - p)
            ramp = np.arange(n, dtype=np.float32) / SERVE_FADE
            expect = new.copy()
            expect[:, :p] = ref[:, :p]
            expect[:, p:p + n] = (ref[:, p:p + n] * (1.0 - ramp)
                                  + new[:, p:p + n] * ramp)
            ref = expect
        rels.append(rel_err(y, ref))
    if not max(rels) < REL_TOL:
        raise AssertionError(f"serve replies off their references: {rels}")
    shapes = server.stats.steps_by_shape
    if not (len(shapes) >= 2
            and any(int(key.split("x")[1]) > 1 for key in shapes)):
        raise AssertionError(f"no multi-block step or one shape only: "
                             f"{shapes}")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    phase("serve", f"{lf.sidecar.taps} taps {cfg.ratio}x, 8 slots, "
          f"{len(sigs)} f32 streams ({'/'.join(f'{s:g}' for s in seconds)}"
          f" s), live swap to linear phase under streams 2-3: rel vs "
          f"offline kernel output (0-1) and fade model (2-3) "
          f"{', '.join(f'{r:.2e}' for r in rels)} (limit {REL_TOL:g}); "
          f"validate_audio passed (0-1); fused_frames launches {launches}; "
          f"start {warm_s:.2f} s; {figures} on {card}")
    return launches, server


def serve_low_phase(card, low, device, work, n_streams=12,
                    seconds=2.0) -> int:
    """Serve ``n_streams`` s16 streams at once on a 16-slot device-PCM
    StreamServer (both the 8- and the 16-slot widths run), the last
    through totton-serve-client-torch (WAV in, WAV out). Gates: every
    reply within one LSB of float_to_pcm(offline upsample_signal);
    fused_frames launched; the server did not fail; no jax. Returns the
    launches."""
    import numpy as np

    from totton_tpu_torch.io.pcm import (
        PcmFormat,
        deinterleave,
        float_to_pcm,
        interleave,
        pcm_to_float,
    )
    from totton_tpu_torch.engine.upsampler import upsample_signal
    from totton_tpu_torch.ops import fused_frames as ff
    from totton_tpu_torch.serve import StreamServer

    s16 = PcmFormat.S16_LE

    def s16_roundtrip(a):
        return deinterleave(pcm_to_float(float_to_pcm(interleave(a), s16),
                                         s16), a.shape[0])

    port = free_port()
    ff.LAUNCHES = 0
    server = StreamServer(low, f"tcp-listen://127.0.0.1:{port}", RATE,
                          max_streams=16, channels=2, device_pcm=True,
                          device=device)
    t0 = time.monotonic()
    server.start()
    warm_s = time.monotonic() - t0
    sigs = [seeded_signal(seconds, 10 + i) for i in range(n_streams)]
    via_cli = n_streams - 1
    outs, wall = run_clients(port, sigs, fmt=s16, cli={via_cli: work})
    server.stop()
    launches = ff.LAUNCHES
    figures = serve_figures(server, wall)
    if server.failed or (device == "cuda" and launches < 1):
        raise AssertionError(f"serve-low failed={server.failed}, "
                             f"fused_frames launches {launches}")
    lsbs = []
    for x, y in zip(sigs, outs):
        ref = s16_roundtrip(upsample_signal(s16_roundtrip(x), low,
                                            device=device))
        if y.shape != ref.shape:
            raise AssertionError(f"reply shape {y.shape} != {ref.shape}")
        lsbs.append(float(np.abs(y - ref).max()) * 32768)
    lsb = max(lsbs)
    if not lsb <= 1.0:
        raise AssertionError(f"serve-low off by {lsbs} LSB")
    if not any(key.startswith("16x") for key in server.stats.steps_by_shape):
        raise AssertionError("the 16-slot width never ran")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    phase("serve-low", f"{low.sidecar.taps} taps {server.config.ratio}x, "
          f"16 slots, device PCM, {n_streams} s16 streams of {seconds:g} "
          f"s (stream {via_cli} through totton-serve-client-torch, WAV in "
          f"and out: {lsbs[via_cli]:.0f} LSB): max {lsb:.0f} LSB vs "
          f"float_to_pcm(offline kernel output) (limit 1); fused_frames "
          f"launches {launches}; start "
          f"{warm_s:.2f} s; {figures} on {card}")
    return launches


# Phase serve-control: (a) totton-serve-torch with its control endpoint,
# SERVE_CONTROL_STREAMS concurrent f32 streams of SERVE_CONTROL_SECONDS
# (evenly spread) and a RELOAD to linear phase under all of them; (b) a
# fleet leader and follower on the one card, the follower's FLEET_SECONDS
# streams fading at the leader's flip; (c) tests/test_serve_chaos.py's
# client mix on CHAOS_SLOTS slots for CHAOS_SECONDS, in process, on the
# low-latency bank.
SERVE_CONTROL_STREAMS = 8
SERVE_CONTROL_SECONDS = (2.0, 4.0)
FLEET_SECONDS = (3.0, 2.5)
CHAOS_SECONDS = 10.0
CHAOS_SLOTS = 6
# tests/test_serve_chaos.py's mix: a seeded draw of 0-9 picks the
# behaviour of the next client.
CHAOS_MIX = (("normal",) * 4 + ("abort",) * 2 + ("silent", "wrong_rate")
             + ("flood",) * 2)
# The serve stats file is rewritten at most every 0.5 s (serve.py's
# dispatcher): STATS waits this long for a rewrite after the streams end.
STATS_REFRESH_WAIT_S = 5.0


def fade_point(y, old, new, block_size: int, fade: int):
    """(p, max |y - expect|) of the swap model nearest to ``y``: ``old`` up
    to output frame p, a ``fade``-frame linear ramp from old to ``new``,
    then new, with p searched over the multiples of ``block_size`` (the
    dispatch boundaries where a swap can land; tests/test_serve_control.py's
    model). Exact, and linear in the length: prefix and suffix maxima of
    each reference's error, the ramp computed at each p."""
    import numpy as np

    if not y.shape == old.shape == new.shape:
        raise AssertionError(f"shapes {y.shape}, {old.shape}, {new.shape}")
    n_out = y.shape[1]
    d_old = np.maximum.accumulate(np.abs(y - old).max(axis=0))
    d_new = np.maximum.accumulate(np.abs(y - new).max(axis=0)[::-1])[::-1]
    best_p, best_err = None, np.inf
    for p in range(0, n_out + 1, block_size):
        n = min(fade, n_out - p)
        ramp = np.arange(n, dtype=np.float32) / fade
        mix = old[:, p:p + n] * (1.0 - ramp) + new[:, p:p + n] * ramp
        err = max(float(d_old[p - 1]) if p else 0.0,
                  float(np.abs(y[:, p:p + n] - mix).max()) if n else 0.0,
                  float(d_new[p + n]) if p + n < n_out else 0.0)
        if err < best_err:
            best_p, best_err = p, err
    return best_p, best_err


def fade_rels(sigs, outs, lf_old, lf_new, device):
    """Each reply against the swap model on the offline kernel output of
    both filters: (rel of each, the block where each swap landed). Every
    reply is exact in length and the swap lands inside every stream."""
    import numpy as np

    from totton_tpu_torch.engine.upsampler import upsample_signal

    block = lf_old.sidecar.fft_size - lf_old.sidecar.taps + 1
    rels, blocks = [], []
    for i, (x, y) in enumerate(zip(sigs, outs)):
        if y.shape != (2, x.shape[1] * lf_old.ratio):
            raise AssertionError(f"stream {i}: reply {y.shape} for "
                                 f"{x.shape[1]} input frames")
        old = upsample_signal(x, lf_old, device=device)
        new = upsample_signal(x, lf_new, device=device)
        p, err = fade_point(y, old, new, block, SERVE_FADE)
        if not 0 < p < y.shape[1]:
            raise AssertionError(f"stream {i}: the swap landed at output "
                                 f"frame {p} of {y.shape[1]}")
        rels.append(err / float(np.abs(old).max()))
        blocks.append(p // block)
    if not max(rels) < REL_TOL:
        raise AssertionError(f"replies off the swap model: {rels}")
    return rels, blocks


def start_serve_cli(device, name, work, ratio, filter_dir, slots, extra):
    """``python -m totton_tpu_torch.cli.serve`` from this checkout on a free
    port, in its own session, its output in <work>/<name>.log. Returns
    (process, port, log path, start time)."""
    port = free_port()
    log_path = os.path.join(work, f"{name}.log")
    argv = [sys.executable, "-m", "totton_tpu_torch.cli.serve", "--device",
            device, "--listen", f"tcp-listen://127.0.0.1:{port}", "--rate",
            str(RATE), "--ratio", str(ratio), "--filter-dir", filter_dir,
            "--max-streams", str(slots), "--swap-fade", str(SERVE_FADE),
            "--duration", "900", *extra]
    with open(log_path, "w") as log:
        proc = subprocess.Popen(argv, stdout=log, stderr=subprocess.STDOUT,
                                cwd=HERE, start_new_session=True)
    return proc, port, log_path, time.monotonic()


def watch_serving(procs) -> dict:
    """Start a thread that notes, for each server of ``procs`` (name ->
    start_serve_cli's tuple), the seconds from its start until its log
    says it serves; returns the dict it fills."""
    import threading

    ready = {}

    def watch():
        deadline = time.monotonic() + 300
        while len(ready) < len(procs) and time.monotonic() < deadline:
            for name, (proc, _, log_path, t0) in procs.items():
                if name not in ready and (
                        "Serving on" in entry_launches(log_path)[1]):
                    ready[name] = time.monotonic() - t0
            time.sleep(0.05)

    threading.Thread(target=watch, daemon=True).start()
    return ready


def wait_serving(ready, name, proc, log_path, t0, timeout=300.0) -> float:
    """Seconds from the server's start until it served (watch_serving)."""
    while name not in ready:
        if proc.poll() is not None or time.monotonic() - t0 > timeout:
            raise AssertionError(f"{name} never listened: "
                                 + entry_launches(log_path)[1][-3000:])
        time.sleep(0.05)
    return ready[name]


def timed(replies, name, call):
    """``call()`` with its reply ms kept under ``name``; the reply must be
    ok."""
    t0 = time.perf_counter()
    r = call()
    replies[name] = (time.perf_counter() - t0) * 1e3
    if not r.ok:
        raise AssertionError(f"{name} failed: {r}")
    return r


def chaos_attach(s, rate=RATE) -> bool:
    """Send a stream header; True once the server's reply header came
    back (False: refused, all slots busy)."""
    from totton_tpu_torch.io.sockets import HEADER_BYTES, pack_header

    s.sendall(pack_header(None, 2, rate))
    hdr = b""
    while len(hdr) < HEADER_BYTES:
        got = s.recv(HEADER_BYTES - len(hdr))
        if not got:
            return False
        hdr += got
    return True


def chaos_roundtrip(port, x):
    """[2, n] f32 through one raw serve connection (PCM from a pump thread,
    then a half-close); the reply, or None if the server refused it."""
    import socket
    import threading

    import numpy as np

    from totton_tpu_torch.io.pcm import interleave

    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        if not chaos_attach(s):
            return None

        def pump():
            for i in range(0, x.shape[1], 997):
                s.sendall(interleave(x[:, i:i + 997]).astype("<f4").tobytes())
            s.shutdown(socket.SHUT_WR)

        t = threading.Thread(target=pump)
        t.start()
        buf = bytearray()
        while got := s.recv(65536):
            buf += got
        t.join(timeout=60)
    return np.frombuffer(bytes(buf), "<f4").reshape(-1, 2).T


def chaos_client(kind, port, rng, ratio, errors) -> None:
    """One client of tests/test_serve_chaos.py's mix: a normal stream
    (structure checked: the spectrum swaps under it), a mid-stream abort
    by RST, a connect that never sends a header, a wrong-rate header
    (must be refused) or a flood that never reads its output."""
    import socket
    import struct

    import numpy as np

    from totton_tpu_torch.io.pcm import interleave
    from totton_tpu_torch.io.sockets import HEADER_BYTES, pack_header

    if kind == "normal":
        x = (rng.normal(size=(2, int(rng.integers(500, 4000)))) * 0.3
             ).astype(np.float32)
        try:
            y = chaos_roundtrip(port, x)
        except OSError as e:
            errors.append(("normal stream", repr(e)))
            return
        if y is not None and (y.shape != (2, x.shape[1] * ratio)
                              or not np.isfinite(y).all()):
            errors.append(("normal stream", x.shape, y.shape))
        return
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
            if kind == "abort":
                if chaos_attach(s):
                    x = (rng.normal(size=(2, 1500)) * 0.3).astype(np.float32)
                    s.sendall(interleave(x).astype("<f4").tobytes())
                    time.sleep(float(rng.uniform(0, 0.05)))
                    s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                 struct.pack("ii", 1, 0))
            elif kind == "silent":
                time.sleep(0.2)
            elif kind == "wrong_rate":
                s.settimeout(10)
                s.sendall(pack_header(None, 2, 96000))  # serving RATE
                if s.recv(HEADER_BYTES):
                    errors.append(("wrong-rate client got a reply header",))
            else:  # flood
                s.settimeout(0.15)
                if chaos_attach(s):
                    raw = (rng.normal(size=(2, 4096)) * 0.3).astype(np.float32)
                    payload = interleave(raw).astype("<f4").tobytes()
                    deadline = time.monotonic() + 1.0
                    while time.monotonic() < deadline:
                        s.sendall(payload)  # never reads its output
    except OSError:
        pass  # a fault racing the server's own teardown of that stream


def chaos_run(card, low, device, seconds=CHAOS_SECONDS):
    """(c): tests/test_serve_chaos.py's client mix, drawn from its seeds,
    against an in-process StreamServer on ``low`` (CHAOS_SLOTS slots, a
    200-frame swap fade, 16 backlog blocks, 2 s header timeout, device PCM
    off) for ``seconds``, under set_eq swaps 0.3-0.8 s apart and then one
    soft_reset. Gates (the JAX test's): every client behaved, every slot
    free with no pending step and no pre-swap bundle, accepted >= the
    normal clients, rejected >= the wrong-rate ones, the server not
    failed; after set_eq(None) a fresh
    stream equals the offline kernel output (rel < REL_TOL); on a card,
    the device memory after stop() within one bundle of its value before
    the chaos. Returns the launches."""
    import logging
    import threading

    import numpy as np
    import torch

    from totton_tpu_torch.engine.upsampler import upsample_signal
    from totton_tpu_torch.ops import fused_frames as ff
    from totton_tpu_torch.serve import StreamServer

    port = free_port()
    server = StreamServer(low, f"tcp-listen://127.0.0.1:{port}", RATE,
                          max_streams=CHAOS_SLOTS, channels=2,
                          swap_fade_frames=200, max_input_backlog_blocks=16,
                          header_timeout_s=2.0, device=device)
    server.start()
    # The mix's refusals and header faults would log a warning each.
    serve_log = logging.getLogger("totton.serve")
    level = serve_log.level
    serve_log.setLevel(logging.ERROR)
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated()
    bundle_bytes = (server._bundle.weights.numel()
                    * server._bundle.weights.element_size())
    ff.LAUNCHES = 0
    errors, behaviors, threads = [], [], []
    swaps = {"eq": 0}
    t0 = time.monotonic()
    deadline = t0 + seconds
    try:
        def control():
            r = np.random.default_rng(7)
            while time.monotonic() < deadline:
                time.sleep(float(r.uniform(0.3, 0.8)))
                server.set_eq(np.linspace(float(r.uniform(0.5, 0.9)),
                                          float(r.uniform(1.0, 1.4)),
                                          server.config.n_bins))
                swaps["eq"] += 1
            server.soft_reset()

        ct = threading.Thread(target=control)
        ct.start()
        seed = np.random.default_rng(42)
        while time.monotonic() < deadline:
            kind = CHAOS_MIX[int(seed.integers(0, 10))]
            t = threading.Thread(target=chaos_client, args=(
                kind, port, np.random.default_rng(1000 + len(threads)),
                server.config.ratio, errors))
            t.start()
            threads.append(t)
            behaviors.append(kind)
            time.sleep(float(seed.uniform(0.0, 0.12)))
        for t in threads + [ct]:
            t.join(timeout=120)
        chaos_s = time.monotonic() - t0
        if errors or any(t.is_alive() for t in threads + [ct]):
            raise AssertionError(f"chaos clients failed: {errors[:5]}")

        wait_until = time.monotonic() + 30
        while time.monotonic() < wait_until:
            with server._slot_lock:
                if len(server._free) == CHAOS_SLOTS:
                    break
            time.sleep(0.1)
        with server._slot_lock:
            free = len(server._free)
        pending = [s.pending_steps for s in server.slots]
        stale = len({id(s.fade_from) for s in server.slots
                     if s.fade_from is not None})
        if free != CHAOS_SLOTS or any(pending) or stale:
            raise AssertionError(f"after the chaos {free} of {CHAOS_SLOTS} "
                                 f"slots free, pending steps {pending}, "
                                 f"{stale} pre-swap bundles held")
        swaps_before = server.stats.spectrum_swaps
        server.set_eq(None)
        wait_until = time.monotonic() + 30
        while server.stats.spectrum_swaps <= swaps_before:
            if time.monotonic() > wait_until:
                raise AssertionError("set_eq(None) never applied")
            time.sleep(0.02)
        x = (np.random.default_rng(60).normal(size=(2, 2500)) * 0.3
             ).astype(np.float32)
        y = chaos_roundtrip(port, x)
        if y is None:
            raise AssertionError("the fresh stream was refused")
        rel = rel_err(y, upsample_signal(x, low, device=device))
        stats = server.stats
        counts = {k: behaviors.count(k) for k in dict.fromkeys(CHAOS_MIX)}
        if not (rel < REL_TOL and stats.accepted >= counts["normal"]
                and stats.rejected >= counts["wrong_rate"]
                and not server.failed):
            raise AssertionError(
                f"after the chaos: fresh stream rel {rel:.3e}, accepted "
                f"{stats.accepted}, rejected {stats.rejected}, clients "
                f"{counts}, failed {server.failed}")
    finally:
        server.stop()
        serve_log.setLevel(level)
    launches = ff.LAUNCHES
    if cuda and launches < 1:
        raise AssertionError("the chaos run never launched fused_frames")
    mem = "device memory not measured (no card)"
    if cuda:
        torch.cuda.synchronize()
        mem_after = torch.cuda.memory_allocated()
        if abs(mem_after - mem_before) > bundle_bytes:
            raise AssertionError(
                f"device memory {mem_before} B before the chaos, "
                f"{mem_after} B after stop(): more than one bundle "
                f"({bundle_bytes} B) apart")
        mem = (f"device memory allocated {mem_before / 2**20:.2f} MiB before"
               f" the chaos, {mem_after / 2**20:.2f} MiB after stop() "
               f"({mem_after - mem_before:+d} B; limit one bundle, "
               f"{bundle_bytes} B)")
    phase("serve-control", f"(c) chaos in process, StreamServer({device}) "
          f"{low.sidecar.taps} taps {server.config.ratio}x, {CHAOS_SLOTS} "
          f"slots, device PCM off: {len(behaviors)} clients in "
          f"{chaos_s:.2f} s ({', '.join(f'{k} {n}' for k, n in counts.items())})"
          f", {swaps['eq']} set_eq swaps then a soft_reset: all "
          f"{CHAOS_SLOTS} slots free, 0 pending steps, 0 pre-swap bundles "
          f"held; accepted {stats.accepted} (>= {counts['normal']}), "
          f"rejected {stats.rejected} (>= {counts['wrong_rate']}), server "
          f"failed "
          f"{server.failed}; after set_eq(None) a fresh 2500-frame stream "
          f"rel {rel:.3e} vs the offline kernel output (limit {REL_TOL:g});"
          f" fused_frames launches {launches}; {mem} on {card}")
    return launches


def serve_control_phase(card, work, low, device="cuda", filter_dir=FILTER_DIR,
                        ratio=16, seconds=SERVE_CONTROL_SECONDS,
                        fleet_seconds=FLEET_SECONDS,
                        chaos_seconds=CHAOS_SECONDS) -> int:
    """The serving plane's control surface and fault paths, through the
    port's own CLI and server: (a) ``totton-serve-torch`` at ``ratio``
    (the bank's normal-latency min-phase filter from ``filter_dir``) with
    --control-endpoint, --config, --stats-path and --swap-fade SERVE_FADE;
    SERVE_CONTROL_STREAMS f32 streams of ``seconds`` (evenly spread), each
    held at its middle block until config.json says linear and a RELOAD
    has been answered; every reply exact in length and within REL_TOL of
    the swap model on the offline kernel output of both filters, searched
    over dispatch boundaries; STATS reloads 1, phase linear and, once the
    stats file is rewritten, spectrum_swaps 1 and 8 accepted;
    PHASE_TYPE_SET minimum persisted; SHUTDOWN exits 0. (b) A leader
    (control and PUB endpoints) and a follower (--control-follow) on the
    same device: the follower's ``fleet_seconds`` streams fade at the
    leader's PHASE_TYPE_SET linear, the leader's SHUTDOWN stops both with
    exit 0. (c) ``chaos_run`` on ``low``. The three servers start together
    and (c) runs while they do. Returns the launches (the CLIs' own
    reports and (c)'s)."""
    from totton_tpu_torch.control.client import DaemonClient
    from totton_tpu_torch.engine.selector import resolve_filter_path
    from totton_tpu_torch.filters.sidecar import load_filter

    started = time.monotonic()
    lf = {ph: load_filter(resolve_filter_path(
        filter_path=None, filter_dir=filter_dir, phase=ph, ratio=ratio,
        input_rate=RATE, latency="normal")) for ph in ("minimum", "linear")}
    block_in = ((lf["minimum"].sidecar.fft_size - lf["minimum"].sidecar.taps
                 + 1) // ratio)
    cfg_path = os.path.join(work, "serve_control_config.json")
    with open(cfg_path, "w") as f:
        json.dump({"filter": {"phaseType": "minimum"}}, f)
    stats_path = os.path.join(work, "serve_control_stats.json")
    fol_stats = os.path.join(work, "serve_follower_stats.json")
    ep, lead_ep, pub = (f"ipc://{work}/{n}.sock"
                        for n in ("sc_ctl", "lead_ctl", "lead_pub"))
    procs = {
        "serve": start_serve_cli(
            device, "serve_control", work, ratio, filter_dir,
            SERVE_CONTROL_STREAMS, ["--control-endpoint", ep, "--config",
                                    cfg_path, "--stats-path", stats_path]),
        "leader": start_serve_cli(
            device, "serve_leader", work, ratio, filter_dir, 4,
            ["--control-endpoint", lead_ep, "--control-pub-endpoint", pub]),
        "follower": start_serve_cli(
            device, "serve_follower", work, ratio, filter_dir, 4,
            ["--control-follow", pub, "--stats-path", fol_stats]),
    }
    ready = watch_serving(procs)
    launches = 0
    try:
        # (c) in this process while the three servers start.
        launches += chaos_run(card, low, device, chaos_seconds)

        # (a) RELOAD under SERVE_CONTROL_STREAMS streams through the CLI.
        proc, port, log_path, t0 = procs["serve"]
        listen_s = wait_serving(ready, "serve", proc, log_path, t0)
        # The control endpoint starts before the server: it answers now.
        client = DaemonClient(endpoint=ep, timeout_ms=30000)
        replies = {}
        timed(replies, "PING", lambda: client.request("PING"))
        n = SERVE_CONTROL_STREAMS
        lengths = [seconds[0] + (seconds[1] - seconds[0]) * i / (n - 1)
                   for i in range(n)]
        sigs = [seeded_signal(s, 20 + i) for i, s in enumerate(lengths)]
        held = {i: (x.shape[1] // 2 // block_in) * block_in
                for i, x in enumerate(sigs)}

        def reload():
            with open(cfg_path, "w") as f:
                json.dump({"filter": {"phaseType": "linear"}}, f)
            timed(replies, "RELOAD", client.reload_config)

        outs, wall = run_clients(port, sigs, split=held, swap=reload)
        rels, landed = fade_rels(sigs, outs, lf["minimum"], lf["linear"],
                                 device)
        st = timed(replies, "STATS", client.stats)
        written = st.data["stream"]["uptime_ms"]
        wait_until = time.monotonic() + STATS_REFRESH_WAIT_S
        while st.data["stream"]["uptime_ms"] <= written:
            if time.monotonic() > wait_until:
                raise AssertionError("the serve stats file was not rewritten "
                                     f"within {STATS_REFRESH_WAIT_S:g} s")
            time.sleep(0.1)
            st = client.stats()
        got = (st.data["reloads"], st.data["phase_type"],
               st.data["stream"]["spectrum_swaps"],
               st.data["stream"]["streams"]["accepted"])
        if got != (1, "linear", 1, n):
            raise AssertionError(f"STATS (reloads, phase, spectrum_swaps, "
                                 f"accepted) {got}, expected (1, linear, 1, "
                                 f"{n})")
        timed(replies, "PHASE_TYPE_SET",
              lambda: client.set_phase_type("minimum"))
        with open(cfg_path) as f:
            persisted = json.load(f)["filter"]["phaseType"]
        if persisted != "minimum":
            raise AssertionError(f"PHASE_TYPE_SET not persisted: {persisted}")
        timed(replies, "SHUTDOWN", client.shutdown)
        rc = proc.wait(timeout=120)
        n_launch, log_text = entry_launches(log_path)
        if rc != 0 or "Live serve reload" not in log_text or (
                device == "cuda" and n_launch < 1):
            raise AssertionError(f"serve exit {rc}, launches {n_launch}: "
                                 + log_text[-3000:])
        launches += n_launch
        no_jax()
        phase("serve-control", f"(a) totton-serve-torch --device {device} "
              f"--control-endpoint, {lf['minimum'].sidecar.taps} taps "
              f"{ratio}x, {n} slots, {n} concurrent f32 streams of "
              f"{lengths[0]:g}-{lengths[-1]:g} s, RELOAD to linear phase "
              f"with every stream held mid-way: rel vs the swap model on the"
              f" offline kernel output {max(rels):.3e} max over the {n} "
              f"(limit {REL_TOL:g}), swap at block "
              f"{', '.join(map(str, landed))}; STATS reloads 1, "
              f"spectrum_swaps 1, accepted {n}; PHASE_TYPE_SET persisted; "
              f"SHUTDOWN exit {rc}; reply ms "
              f"{', '.join(f'{k} {v:.2f}' for k, v in replies.items())}; "
              f"listening {listen_s:.2f} s after its start; streams "
              f"{wall:.2f} s; fused_frames launches {n_launch} on {card}")

        # (b) The fleet: the follower replays the leader's phase flip.
        (lead, _, lead_log, lt0), (fol, fol_port, fol_log, ft0) = (
            procs["leader"], procs["follower"])
        lead_s = wait_serving(ready, "leader", lead, lead_log, lt0)
        fol_s = wait_serving(ready, "follower", fol, fol_log, ft0)
        leader = DaemonClient(endpoint=lead_ep, timeout_ms=30000)
        fleet = {}
        timed(fleet, "PING", lambda: leader.request("PING"))
        sigs = [seeded_signal(s, 40 + i) for i, s in enumerate(fleet_seconds)]
        held = {i: (x.shape[1] // 2 // block_in) * block_in
                for i, x in enumerate(sigs)}
        follow = {}

        def flip():
            timed(fleet, "PHASE_TYPE_SET",
                  lambda: leader.set_phase_type("linear"))
            t1 = time.monotonic()
            while True:  # the follower's stats file shows its swap
                try:
                    with open(fol_stats) as f:
                        if json.load(f)["spectrum_swaps"] >= 1:
                            break
                except (OSError, ValueError, KeyError):
                    pass
                if time.monotonic() - t1 > 60:
                    raise AssertionError("the follower never swapped")
                time.sleep(0.02)
            follow["s"] = time.monotonic() - t1

        outs, _ = run_clients(fol_port, sigs, split=held, swap=flip)
        fol_rels, fol_landed = fade_rels(sigs, outs, lf["minimum"],
                                         lf["linear"], device)
        timed(fleet, "SHUTDOWN", leader.shutdown)
        rcs = (lead.wait(timeout=120), fol.wait(timeout=120))
        lead_n, _ = entry_launches(lead_log)
        fol_n, fol_text = entry_launches(fol_log)
        if rcs != (0, 0) or "Live serve reload" not in fol_text or (
                device == "cuda" and fol_n < 1):
            raise AssertionError(f"fleet exits {rcs}, follower launches "
                                 f"{fol_n}: " + fol_text[-3000:])
        launches += lead_n + fol_n
        phase("serve-control", f"(b) fleet: a leader (--control-endpoint, "
              f"--control-pub-endpoint) and a follower (--control-follow) "
              f"on the one {device} device, each its own process and CUDA "
              f"context (two contexts on one card are fine), 4 slots each: "
              f"the follower's {len(sigs)} f32 streams "
              f"({'/'.join(f'{s:g}' for s in fleet_seconds)} s) fade at the "
              f"leader's PHASE_TYPE_SET linear, rel vs the swap model "
              f"{', '.join(f'{r:.3e}' for r in fol_rels)} (limit "
              f"{REL_TOL:g}), swap at block "
              f"{', '.join(map(str, fol_landed))}; the follower's swap seen "
              f"{follow['s']:.2f} s after the leader's reply (its stats "
              f"file, written every 0.5 s); leader SHUTDOWN: exit codes "
              f"leader {rcs[0]}, follower {rcs[1]}; reply ms "
              f"{', '.join(f'{k} {v:.2f}' for k, v in fleet.items())}; "
              f"listening {lead_s:.2f} s (leader), {fol_s:.2f} s (follower) "
              f"after their start; fused_frames launches {lead_n} (leader, "
              f"its warm-up), {fol_n} (follower) on {card}")
    finally:
        for proc, *_ in procs.values():
            if proc.poll() is None:
                kill_group(proc)
    phase("serve-control", f"phase serve-control took "
          f"{time.monotonic() - started:.1f} s on {card}")
    return launches


EQ_PROFILE = ("Preamp: -5 dB\n"
              "Filter 1: ON PK Fc 1000 Hz Gain 3 dB Q 1.0\n"
              "Filter 2: ON LSC Fc 105 Hz Gain 4 dB Q 0.7\n"
              "Filter 3: ON HSC Fc 8000 Hz Gain -2 dB Q 0.7\n")


def write_profile(work: str, name: str = "eq.txt") -> str:
    """EQ_PROFILE written into ``work``; returns its path."""
    path = os.path.join(work, name)
    with open(path, "w") as f:
        f.write(EQ_PROFILE)
    return path


def no_jax() -> None:
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")


def run_cli(args, capture=False):
    """totton-stream-torch in this process (so the kernel's launch count
    sees it); returns (exit code, launches, its stderr if ``capture``)."""
    import contextlib
    import io

    from totton_tpu_torch.cli import stream as stream_cli
    from totton_tpu_torch.ops import fused_frames as ff

    err = io.StringIO()
    ff.LAUNCHES = 0
    with contextlib.redirect_stderr(err) if capture else contextlib.nullcontext():
        rc = stream_cli.main(args)
    launches = ff.LAUNCHES
    return rc, launches, err.getvalue()


def max_lsb(a, b) -> float:
    import numpy as np

    if a.shape != b.shape:
        raise AssertionError(f"shape {a.shape} != {b.shape}")
    return float(np.abs(np.round(a * 32768) - np.round(b * 32768)).max())


def ratio1_states(device, profile_path):
    """(label, cfg, bundle, spectrum) of the two ratio-1 geometries the
    kernel's halves branch runs: (129, 1024, 1) with a seeded filter, and
    the CLI's identity geometry (1025, 4096, 1) with an APO EQ baked in."""
    import numpy as np

    from totton_tpu_torch.control.wiring import resolve_eq_response
    from totton_tpu_torch.ops import overlap_save as osv

    rng = np.random.default_rng(1)
    out = []
    for taps, fft in ((129, 1024), (1025, 4096)):
        cfg = osv.OverlapSaveConfig(taps, fft, fft - taps + 1, 1)
        if taps == 129:
            h, eq, label = (rng.normal(size=taps)
                            * np.exp(-np.arange(taps) / 20.0)), None, ""
        else:
            h = np.zeros(taps)
            h[0] = 1.0
            eq, _ = resolve_eq_response(profile_path, None, fft, RATE)
            label = " identity + APO EQ"
        spec = osv.filter_spectrum(h, fft, eq, device=device)
        out.append((f"ratio 1 ({taps}, {fft}){label}", cfg,
                    osv.fold_bundle(spec, cfg), spec))
    return out


def ratio1_phase(card, work, device="cuda", seconds=10.0):
    """totton-stream-torch --ratio 1 --eq-profile on ``device`` against the
    same command on the CPU (<= 1 LSB), then (on the card) the
    frame_reading of a 512-block ratio-1 stereo dispatch. Returns (the
    launches, the reading or None)."""
    import numpy as np
    import torch

    from totton_tpu_torch.io.wav import read_wav, write_wav
    from totton_tpu_torch.testing.signals import sine

    profile = write_profile(work)
    x = sine(1000.0, seconds, RATE, amplitude=0.5, channels=2)
    x[1] = sine(220.0, seconds, RATE, amplitude=0.4, channels=1)[0]
    in_path = os.path.join(work, "r1_in.wav")
    write_wav(in_path, x, RATE)
    outs, launches, walls = {}, 0, {}
    for dev in (device, "cpu"):
        path = os.path.join(work, f"r1_{dev}.wav")
        t0 = time.monotonic()
        rc, n, _ = run_cli(["--in", in_path, "--out", path, "--ratio", "1",
                            "--eq-profile", profile, "--format", "s16",
                            "--device", dev])
        walls[dev] = time.monotonic() - t0
        if rc != 0:
            raise AssertionError(f"--ratio 1 on {dev} exited {rc}")
        if dev == device:
            launches = n
        outs[dev] = read_wav(path)[0]
    lsb = max_lsb(outs[device], outs["cpu"])
    if not (lsb <= 1.0 and outs[device].shape == x.shape):
        raise AssertionError(f"--ratio 1 {device} vs cpu: {lsb} LSB")
    if device == "cuda" and launches < 1:
        raise AssertionError("--ratio 1 never launched fused_frames")
    eq_db = 20 * np.log10(np.abs(outs[device]).max() / np.abs(x).max())
    no_jax()
    phase("ratio1", f"totton-stream-torch --ratio 1 --eq-profile (3-band APO EQ, "
          f"identity 1025 taps, fft 4096), {seconds:g} s stereo s16: "
          f"{device} vs cpu max {lsb:.0f} LSB (limit 1); fused_frames "
          f"launches {launches}; wall {walls[device]:.2f} s ({device}), "
          f"{walls['cpu']:.2f} s (cpu); peak level {eq_db:+.2f} dB vs input "
          f"on {card}")
    if device != "cuda":
        return launches, None
    reading = ratio1_reading(card, profile)
    return launches, reading


def ratio1_reading(card, profile_path, rng=None) -> dict:
    """frame_reading of the CLI's ratio-1 geometry (identity 1025 taps, fft
    4096, the APO EQ at ``profile_path`` baked in), 512 stereo blocks,
    printed as phase ratio1."""
    import numpy as np
    import torch

    (_, cfg, bundle, spec), = [s for s in ratio1_states("cuda", profile_path)
                               if s[1].taps == 1025]
    r = frame_reading("ratio 1 (1025, 4096) + APO EQ", cfg, bundle,
                      torch.complex(spec[0], spec[1]),
                      rng or np.random.default_rng(2))
    phase("ratio1", reading_line(r, card))
    return r


def ratios_phase(card, work, device="cuda", seconds=10.0, cpu_seconds=2.0):
    """totton-stream-torch file mode, stereo s16, at each of CLI_RATIOS
    (the filter by auto lookup): ``seconds`` of a sine on ``device``
    through validate_audio, and its first ``cpu_seconds`` against the same
    command on the CPU over those seconds of input (<= 1 LSB). Returns the
    launches on ``device``."""
    import numpy as np

    from totton_tpu_torch.engine.selector import resolve_filter_path
    from totton_tpu_torch.io.wav import read_wav, write_wav
    from totton_tpu_torch.testing.signals import sine
    from totton_tpu_torch.testing.validate_output import validate_audio

    total = 0
    for fs, ratio, latency in CLI_RATIOS:
        chosen = os.path.basename(resolve_filter_path(
            None, FILTER_DIR, "min", ratio, fs, latency))
        x = sine(1000.0, seconds, fs, amplitude=0.5, channels=2)
        keep = int(cpu_seconds * fs)
        outs, walls, launches = {}, {}, 0
        for run, dev, signal in (("run", device, x), ("cpu", "cpu",
                                                      x[:, :keep])):
            in_path = os.path.join(work, f"ratios_{run}_in.wav")
            out_path = os.path.join(work, f"ratios_{run}_out.wav")
            write_wav(in_path, signal, fs)
            t0 = time.monotonic()
            rc, n, _ = run_cli(["--in", in_path, "--out", out_path,
                                "--ratio", str(ratio), "--latency", latency,
                                "--filter-dir", FILTER_DIR, "--format", "s16",
                                "--device", dev])
            walls[run] = time.monotonic() - t0
            if rc != 0:
                raise AssertionError(f"--ratio {ratio} --latency {latency} "
                                     f"at {fs} Hz on {dev} exited {rc}")
            if run == "run":
                launches = n
            outs[run], rate = read_wav(out_path)
            if rate != fs * ratio:
                raise AssertionError(f"--ratio {ratio} on {dev}: {rate} Hz")
        y = outs["run"]
        report = validate_audio(x, y, output_ratio=ratio)
        lsb = max_lsb(y[:, :keep * ratio], outs["cpu"])
        if not (report["passed"] and y.shape == (2, x.shape[1] * ratio)
                and np.isfinite(y).all() and lsb <= 1.0):
            raise AssertionError(
                f"--ratio {ratio} --latency {latency} at {fs} Hz: "
                f"{lsb} LSB vs cpu, validate_audio {report}")
        if device == "cuda" and launches < 1:
            raise AssertionError(f"--ratio {ratio} --latency {latency} "
                                 "never launched fused_frames")
        total += launches
        no_jax()
        phase("ratios", f"totton-stream-torch --ratio {ratio} --latency "
              f"{latency}, {seconds:g} s stereo {fs} Hz -> {fs * ratio} Hz "
              f"s16 ({chosen}): fused_frames launches {launches}; "
              f"validate_audio passed (correlation "
              f"{report['correlation']:.6f}); first {cpu_seconds:g} s vs "
              f"cpu max {lsb:.0f} LSB (limit 1); wall {walls['run']:.2f} s "
              f"({device}), {walls['cpu']:.2f} s (cpu, {cpu_seconds:g} s) on "
              f"{card}")
    return total


def threaded_phase(card, work, device="cuda", seconds=10.0):
    """--threaded file mode at 16x/80k against the same file without it:
    0 LSB expected, 1 LSB limit. Returns the launches of the threaded
    run."""
    from totton_tpu_torch.io.wav import read_wav, write_wav
    from totton_tpu_torch.testing.signals import sine

    x = sine(1000.0, seconds, RATE, amplitude=0.5, channels=2)
    in_path = os.path.join(work, "th_in.wav")
    write_wav(in_path, x, RATE)
    outs, runs = {}, {}
    for name, extra in (("threaded", ["--threaded"]), ("sync", [])):
        path = os.path.join(work, f"th_{name}.wav")
        stats_path = os.path.join(work, f"th_{name}.json")
        t0 = time.monotonic()
        rc, n, _ = run_cli(["--in", in_path, "--out", path, "--ratio", "16",
                            "--filter-dir", FILTER_DIR, "--format", "s16",
                            "--device", device, "--stats-path", stats_path]
                           + extra)
        if rc != 0:
            raise AssertionError(f"{name} run exited {rc}")
        with open(stats_path) as f:
            stats = json.load(f)
        runs[name] = (n, time.monotonic() - t0, stats)
        outs[name] = read_wav(path)[0]
    lsb = max_lsb(outs["threaded"], outs["sync"])
    n, wall, stats = runs["threaded"]
    if not (lsb <= 1.0 and outs["threaded"].shape == (2, x.shape[1] * 16)
            and stats["frames_out"] == 16 * stats["frames_in"]):
        raise AssertionError(f"--threaded vs synchronous: {lsb} LSB, "
                             f"stats {stats}")
    if device == "cuda" and n < 1:
        raise AssertionError("--threaded never launched fused_frames")
    no_jax()
    phase("threaded", f"--threaded 16x/80k file mode, {seconds:g} s stereo "
          f"s16: max {lsb:.0f} LSB vs the synchronous session (limit 1); "
          f"fused_frames launches {n}; blocks {stats['blocks_processed']}; "
          f"realtime factor {stats['realtime_factor']:.1f}x threaded, "
          f"{runs['sync'][2]['realtime_factor']:.1f}x synchronous; wall "
          f"{wall:.2f} / {runs['sync'][1]:.2f} s on {card}")
    return n


def crossfeed_phase(card, work, lf, device="cuda", seconds=(3.0, 10.0),
                    time_blocks=512):
    """The crossfeed chain at 16x/80k with a set generated on the spot:
    (a) CrossfeedChain(StreamingUpsampler, CrossfeedProcessor) against the
    kernel's own upsample_signal output through a float64 2x2
    fftconvolve, shifted by the chain's latency (rel < 1e-5), with the
    crossfeed step's share of one ``time_blocks``-block dispatch, and the
    step's blocks bit-equal whether stepped at once or in runs of
    SPLIT_RUNS; (b) the CLI with --crossfeed passes validate_audio.
    Returns the launches."""
    import numpy as np
    import torch
    from scipy import signal as ssig

    from totton_tpu_torch.filters.hrtf import generate_all
    from totton_tpu_torch.io.wav import read_wav, write_wav
    from totton_tpu_torch.testing.signals import sine
    from totton_tpu_torch.testing.validate_output import validate_audio
    from totton_tpu_torch.engine.chain import CrossfeedChain
    from totton_tpu_torch.engine.crossfeed import (
        CrossfeedFilter,
        CrossfeedProcessor,
    )
    from totton_tpu_torch.engine.upsampler import (
        StreamingUpsampler,
        upsample_signal,
    )
    from totton_tpu_torch.ops import fused_frames as ff

    cf_path = generate_all(os.path.join(work, "cf"), sizes=["M"],
                           families=["44k"])[0]
    cf_filter = CrossfeedFilter.load(cf_path)
    ff.LAUNCHES = 0
    chain = CrossfeedChain(StreamingUpsampler(lf, 2, device=device),
                           CrossfeedProcessor(cf_filter, device=device))
    bi = chain.block_input_frames
    nb = int(seconds[0] * RATE) // bi
    x = seeded_signal(nb * bi / RATE, 3)[:, :nb * bi]
    cuts = [0, 1, nb // 3, nb]
    y = np.concatenate([chain.process_block(x[:, a * bi:b * bi])
                        for a, b in zip(cuts, cuts[1:])], axis=1)
    launches = ff.LAUNCHES
    up = upsample_signal(x, lf, device=device).astype(np.float64)
    ll, lr, rl, rr = cf_filter.channels
    n = up.shape[1]
    ref = np.stack([
        ssig.fftconvolve(up[0], ll)[:n] + ssig.fftconvolve(up[1], rl)[:n],
        ssig.fftconvolve(up[0], lr)[:n] + ssig.fftconvolve(up[1], rr)[:n]])
    d = chain.latency
    rel = rel_err(y[:, d:], ref[:, :n - d])
    if not (rel < REL_TOL and np.abs(y[:, :d]).max() == 0):
        raise AssertionError(f"crossfeed chain vs float64 oracle rel {rel}")
    if device == "cuda" and launches < 1:
        raise AssertionError("the chain never launched fused_frames")

    # The crossfeed stage's share of one deep dispatch: host time of the
    # upsampler alone and of the chain on the same input (both end in a
    # host array), and the crossfeed step's device time alone.
    xt = seeded_signal(time_blocks * bi / RATE, 4)[:, :time_blocks * bi]
    up_eng = StreamingUpsampler(lf, 2, device=device)
    up_eng.process_block(xt)  # first use of the shape (allocation)
    t0 = time.perf_counter()
    y_up = up_eng.process_block(xt)
    t_up = time.perf_counter() - t0
    chain.reset()
    chain.process_block(xt)
    t0 = time.perf_counter()
    chain.process_block(xt)
    t_chain = time.perf_counter() - t0
    cf_ms = float("nan")
    if device == "cuda":
        cf = chain.crossfeed
        y_dev = torch.from_numpy(y_up[:, :y_up.shape[1] - y_up.shape[1]
                                      % cf.config.block_in].copy()).to(device)
        cf_ms = cuda_time_ms(lambda: cf._step(cf._tail, y_dev, cf._h),
                             warmup=1, reps=3)
        del y_dev
        torch.cuda.empty_cache()

    # The 2x2 step, batch invariance: time_blocks blocks in one step
    # against the same blocks stepped in runs of SPLIT_RUNS, the tail
    # carried.
    cf = chain.crossfeed
    cbi = cf.config.block_in
    xb = torch.from_numpy(seeded_signal(time_blocks * cbi / RATE, 5)
                          [:, :time_blocks * cbi].copy()).to(device)
    tail0 = torch.zeros((2, cf.config.halo_in), device=device)
    whole, _ = cf._step(tail0, xb, cf._h)
    tail, parts = tail0, []
    for lo, hi in split_runs(time_blocks):
        y_run, tail = cf._step(tail, xb[:, lo * cbi:hi * cbi], cf._h)
        parts.append(y_run)
    cf_split = (torch.cat(parts, 1) - whole).abs().max().item()
    del xb, whole, parts
    if cf_split != 0:
        raise AssertionError(f"crossfeed step on {device}: a block's output "
                             f"depends on its dispatch (max |diff| "
                             f"{cf_split:g})")

    # (b) the CLI with --crossfeed.
    xs = sine(1000.0, seconds[1], RATE, amplitude=0.5, channels=2)
    in_path = os.path.join(work, "cf_in.wav")
    out_path = os.path.join(work, "cf_out.wav")
    write_wav(in_path, xs, RATE)
    ff.LAUNCHES = 0
    rc, n_cli, err = run_cli(["--in", in_path, "--out", out_path, "--ratio",
                              "16", "--filter-dir", FILTER_DIR, "--format",
                              "s16", "--device", device, "--crossfeed",
                              cf_path], capture=True)
    ys, rate = read_wav(out_path)
    report = validate_audio(xs, ys, output_ratio=16)
    if not (rc == 0 and report["passed"] and ys.shape == (2, xs.shape[1] * 16)
            and "Crossfeed enabled" in err):
        raise AssertionError(f"--crossfeed CLI: exit {rc}, {report}")
    if device == "cuda" and n_cli < 1:
        raise AssertionError("--crossfeed CLI never launched fused_frames")
    no_jax()
    cfg = chain.crossfeed.config
    phase("crossfeed", f"set {os.path.basename(cf_path)}: {cf_filter.taps} "
          f"taps/channel, fft {cfg.fft_size}, block {cfg.block_size}, chain "
          f"latency {d} output frames; (a) 16x/80k chain, {nb} blocks in 3 "
          f"chunks, vs float64 2x2 fftconvolve of the kernel's output: rel "
          f"{rel:.3e} (limit {REL_TOL:g}); {time_blocks}-block stereo "
          f"dispatch, host: upsampler {t_up * 1e3:.1f} ms, chain "
          f"{t_chain * 1e3:.1f} ms (crossfeed share "
          f"{(t_chain - t_up) / t_chain:.1%}); crossfeed step device "
          f"{cf_ms:.3f} ms; the step on {time_blocks} blocks in runs of "
          f"{', '.join(map(str, SPLIT_RUNS))} vs one step: max |diff| "
          f"{cf_split:g} (limit 0); (b) --crossfeed CLI {seconds[1]:g} s: "
          f"exit {rc}, "
          f"validate_audio {json.dumps(report, default=float)}; "
          f"fused_frames launches {launches} + {n_cli} on {card}")
    return launches + n_cli


def start_web(work, endpoint, cfg_path, stats_path):
    """``python -m totton_tpu_torch.cli.webserver`` on a free port, its
    environment pointed at the live stream's control endpoint, config and
    stats, an EQ directory and OPRA_FIXTURE; returns (process, base URL)
    once /api/status answers."""
    import urllib.request

    db = os.path.join(work, "opra_database_v1.jsonl")
    with open(db, "w") as f:
        f.write(OPRA_FIXTURE + "\n")
    env = dict(os.environ, TOTTON_ZMQ_ENDPOINT=endpoint,
               TOTTON_CONFIG_PATH=cfg_path, TOTTON_STATS_PATH=stats_path,
               TOTTON_EQ_DIR=os.path.join(work, "EQ"),
               OPRA_DATABASE_PATH=db,
               TOTTON_DATA_DIR=os.path.join(work, "data"))
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "totton_tpu_torch.cli.webserver", "--host",
         "127.0.0.1", "--port", str(port)], cwd=HERE, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    url = f"http://127.0.0.1:{port}"
    deadline = time.monotonic() + 60
    while True:
        try:
            with urllib.request.urlopen(url + "/api/status", timeout=2):
                return proc, url
        except OSError:
            if proc.poll() is not None or time.monotonic() > deadline:
                proc.kill()
                out = proc.communicate()[0]
                raise AssertionError(f"totton-web-torch never answered: "
                                     f"{out[-2000:]}")
            time.sleep(0.1)


def http(url, method="GET", body=None) -> tuple[int, dict]:
    """(status, JSON reply) of one request to the web plane."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def live_phase(card, work, device="cuda", seconds=7.0, period=4096,
               pause=0.5):
    """The live product path: totton-stream-torch on a tcp-listen socket
    input, --threaded, with the in-process control endpoint, driven by a
    real-time sender thread and a controller thread, each reply timed and
    ``pause`` s apart. The controller speaks to the stream's endpoint
    directly (DaemonClient: PING, RELOAD with alsa.dither turned on in
    config.json, SOFT_RESET, STATS) and through the web plane,
    ``totton-web-torch`` in its own process (GET /api/status, PUT
    /api/daemon/phase-type linear, an EQ imported and activated, an OPRA
    preset applied). The CLI runs on this (the main) thread for its
    signal handlers. Returns the launches."""
    import socket
    import threading

    import numpy as np
    import torch

    from totton_tpu_torch.control.client import DaemonClient
    from totton_tpu_torch.io.pcm import PcmFormat, float_to_pcm, interleave
    from totton_tpu_torch.io.sockets import pack_header
    from totton_tpu_torch.io.wav import read_wav
    from totton_tpu_torch.testing.signals import sine

    port = free_port()
    endpoint = f"ipc://{work}/c.sock"
    cfg_path = os.path.join(work, "config.json")
    with open(cfg_path, "w") as f:
        json.dump({"eqEnabled": False}, f)
    out_path = os.path.join(work, "live.wav")
    stats_path = os.path.join(work, "live_stats.json")
    web, url = start_web(work, endpoint, cfg_path, stats_path)
    x = sine(440.0, seconds, RATE, amplitude=0.5, channels=2)
    replies, errors = [], []
    sent = {"frames": 0, "end": None}
    reloads_sent = 3  # RELOAD, the EQ activation, the OPRA apply

    def sender():
        try:
            deadline = time.monotonic() + 120
            while True:
                try:
                    s = socket.create_connection(("127.0.0.1", port),
                                                 timeout=10)
                    break
                except OSError:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.05)
            with s:
                s.sendall(pack_header(PcmFormat.S16_LE, 2, RATE))
                t0 = time.monotonic()
                for i in range(0, x.shape[1], period):
                    chunk = x[:, i:i + period]
                    s.sendall(float_to_pcm(interleave(chunk),
                                           PcmFormat.S16_LE))
                    sent["frames"] += chunk.shape[1]
                    ahead = t0 + sent["frames"] / RATE - time.monotonic()
                    if ahead > 0:
                        time.sleep(ahead)
                sent["end"] = time.monotonic()
        except Exception as e:  # raised on the main thread
            errors.append(("sender", e))

    def controller():
        try:
            client = DaemonClient(endpoint=endpoint, timeout_ms=30000)
            deadline = time.monotonic() + 120
            while not client.ping():
                if time.monotonic() > deadline:
                    raise AssertionError("the control endpoint never "
                                         "answered PING")
                time.sleep(0.05)
            while sent["frames"] < RATE:  # one second into the stream
                time.sleep(0.01)

            def timed(name, fn, check):
                t0 = time.perf_counter()
                r = fn()
                replies.append((name, (time.perf_counter() - t0) * 1e3,
                                time.monotonic()))
                if not check(r):
                    raise AssertionError(f"{name} reply "
                                         f"{getattr(r, 'raw', r)}")
                time.sleep(pause)
                return r

            def ok_http(status, body, key=None):
                return status == 200 and (key is None or body.get(key))

            timed("PING", client.ping, bool)
            timed("HTTP GET /api/status", lambda: http(url + "/api/status"),
                  lambda r: ok_http(*r, "daemon_running"))
            timed("HTTP PUT /api/daemon/phase-type linear",
                  lambda: http(url + "/api/daemon/phase-type", "PUT",
                               {"phase_type": "linear"}),
                  lambda r: ok_http(*r) and r[1]["phase_type"] == "linear")
            with open(cfg_path) as f:
                conf = json.load(f)
            conf["alsa"] = {"dither": True}
            with open(cfg_path, "w") as f:
                json.dump(conf, f)
            timed("RELOAD", client.reload_config, lambda r: r.ok)
            timed("HTTP POST /api/eq/import-text",
                  lambda: http(url + "/api/eq/import-text", "POST",
                               {"name": "live_eq", "content": EQ_PROFILE}),
                  lambda r: ok_http(*r, "imported"))
            timed("HTTP POST /api/eq/activate/live_eq",
                  lambda: http(url + "/api/eq/activate/live_eq", "POST"),
                  lambda r: ok_http(*r, "reloaded"))
            timed("HTTP POST /opra/apply/e1",
                  lambda: http(url + "/opra/apply/e1", "POST"),
                  lambda r: ok_http(*r, "reloaded"))
            timed("SOFT_RESET", client.soft_reset, lambda r: r.ok)
            timed("STATS", client.stats,
                  lambda r: r.ok and r.data["reloads"] >= reloads_sent)
        except Exception as e:  # raised on the main thread
            errors.append(("control", e))

    threads = [threading.Thread(target=sender, name="smoke-sender"),
               threading.Thread(target=controller, name="smoke-control")]
    for t in threads:
        t.start()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    try:
        rc, launches, err = run_cli(
            ["--in", f"tcp-listen://127.0.0.1:{port}", "--out", out_path,
             "--ratio", "16", "--filter-dir", FILTER_DIR, "--format", "s16",
             "--threaded", "--control-endpoint", endpoint, "--config",
             cfg_path, "--stats-path", stats_path, "--device", device],
            capture=True)
        wall = time.monotonic() - t0
        for t in threads:
            t.join(timeout=120)
    finally:
        web.terminate()
        web_out = web.communicate(timeout=30)[0]
    peak = (torch.cuda.max_memory_allocated() / 2**20 if device == "cuda"
            else float("nan"))
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"live phase threads failed: {errors}; "
                             f"stderr {err[-2000:]}; web {web_out[-2000:]}")
    with open(stats_path) as f:
        stats = json.load(f)
    y, rate = read_wav(out_path)
    blocks = stats["blocks_processed"]
    checks = {
        "exit 0": rc == 0,
        "frames_out = 16 x frames_in": (
            stats["frames_in"] == x.shape[1]
            and stats["frames_out"] == 16 * stats["frames_in"]
            and y.shape == (2, 16 * x.shape[1]) and rate == 16 * RATE),
        "no xruns": stats["xruns"] == {"input_overflows": 0,
                                       "output_overflows": 0},
        # The phase change and every RELOAD log a reload.
        "live reloads": (err.count("Live reload:") >= 1 + reloads_sent
                         and "Live dither: on" in err
                         and "live_eq.txt" in err and "opra_e1.txt" in err
                         and "linear_phase" in err),
        "last reply inside the stream": (
            sent["end"] is not None and replies[-1][2] < sent["end"]),
        "launches cover the blocks": blocks > 0 and (
            device != "cuda" or launches * 8 >= blocks),
        "finite": bool(np.isfinite(y).all()),
    }
    if device == "cuda" and launches < 1:
        checks["launched"] = False
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"live phase failed {failed}: stats {stats}; "
                             f"launches {launches}; stderr {err[-3000:]}")
    no_jax()
    phase("live", f"tcp-listen socket, {seconds:g} s stereo s16 at the live "
          f"44.1 kHz pace in {period}-frame periods -> 16x/80k, --threaded, "
          f"control endpoint (DaemonClient) and totton-web-torch (HTTP), "
          f"{pause:g} s apart: replies ms "
          f"{{{', '.join(f'{k}: {v:.2f}' for k, v, _ in replies)}}}; last "
          f"reply {sent['end'] - replies[-1][2]:.2f} s before the input "
          f"ended; STATS reloads >= {reloads_sent}; blocks "
          f"{blocks}, fused_frames launches {launches}; realtime factor "
          f"{stats['realtime_factor']:.1f}x; xruns {stats['xruns']}; wall "
          f"{wall:.2f} s; device peak memory {peak:.0f} MiB on {card}")
    return launches


DEPLOY = os.path.join(HERE, "deploy", "torch")
ENTRYPOINT = os.path.join(DEPLOY, "entrypoint.sh")
# Where the units and the image put the checkout.
INSTALL_ROOT = "/opt/totton-tpu-torch"
WAV_HEADER_BYTES = 44
# The streamer's stderr lines that mark its cold start: the filter loaded
# (imports, the device, the lookup done), the engine built (the session
# starts).
START_MARKS = ("Loaded filter", "Streaming started")
STOP_LIMIT_S = 10.0   # SIGTERM to the entrypoint: every child gone by then
DEPLOY_STREAM_S = 10.0  # (b)'s WAV file
DEPLOY_SERVE_S = 2.0    # each of (d)'s two ServeClient streams


def console_scripts() -> dict[str, str]:
    """pyproject.toml's [project.scripts]: name -> 'module:function'."""
    import tomllib

    with open(os.path.join(HERE, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)["project"]["scripts"]


def write_shims(bin_dir, names, log_dir=None) -> None:
    """A console-script wrapper in ``bin_dir`` for each of ``names``, as
    pip would install it (this interpreter runs the script's function),
    so the entrypoint finds the CLIs on PATH with nothing installed. With
    ``log_dir`` each wrapper first writes its arguments, one a line, to
    <log_dir>/<name>.argv."""
    import shlex

    scripts = console_scripts()
    os.makedirs(bin_dir, exist_ok=True)
    for name in names:
        module, func = scripts[name].split(":")
        code = f"import sys; from {module} import {func}; sys.exit({func}())"
        log = "" if log_dir is None else (
            "printf '%s\\n' \"$@\" > "
            f"{shlex.quote(os.path.join(log_dir, name + '.argv'))}\n")
        path = os.path.join(bin_dir, name)
        with open(path, "w") as f:
            f.write(f"#!/bin/sh\n{log}exec {shlex.quote(sys.executable)} -c "
                    f"{shlex.quote(code)} \"$@\"\n")
        os.chmod(path, 0o755)


def prebuild_command() -> str:
    """The prebuild of deploy/torch/Dockerfile (the kernels and the native
    PCM library): the command of its RUN line that calls
    ops._build.build."""
    with open(os.path.join(DEPLOY, "Dockerfile")) as f:
        for line in f:
            if line.startswith("RUN ") and "_build.build" in line:
                return line[len("RUN "):].strip()
    raise AssertionError("deploy/torch/Dockerfile has no kernel prebuild")


def unit_service(unit: str) -> tuple[list[str], dict[str, str]]:
    """(ExecStart's argv, the Environment= assignments) of
    deploy/torch/systemd/<unit>, with the install root read as this
    checkout."""
    import shlex

    argv, env = [], {}
    with open(os.path.join(DEPLOY, "systemd", unit)) as f:
        for line in f:
            key, _, value = line.strip().partition("=")
            value = value.replace(INSTALL_ROOT, HERE)
            if key == "Environment":
                env.update(a.split("=", 1) for a in shlex.split(value))
            elif key == "ExecStart":
                argv = shlex.split(value)
    return argv, env


def child_pid(parent: int, module: str, timeout: float = 120.0) -> int:
    """The pid of the live child of ``parent`` whose command line names
    ``module`` (a CLI the entrypoint started)."""
    deadline = time.monotonic() + timeout
    while True:
        for d in os.listdir("/proc"):
            try:
                with open(f"/proc/{d}/stat") as f:
                    state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
                with open(f"/proc/{d}/cmdline", "rb") as f:
                    cmd = f.read()
            except (OSError, ValueError):
                continue
            if int(ppid) == parent and state != "Z" and module.encode() in cmd:
                return int(d)
        if time.monotonic() > deadline:
            raise AssertionError(f"the entrypoint never started {module}")
        time.sleep(0.01)


def alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def cuda_context_pids() -> set:
    """The pids that hold a CUDA context: those with a card's device node
    (/dev/nvidiaN) open. (nvidia-smi's compute apps carry the pids of
    another PID namespace where the card's machine runs this.) This
    process holds one, so it must be among them."""
    import re

    pids = set()
    for d in filter(str.isdigit, os.listdir("/proc")):
        try:
            fds = os.listdir(f"/proc/{d}/fd")
            if any(re.fullmatch(r"/dev/nvidia\d+",
                                os.readlink(f"/proc/{d}/fd/{fd}"))
                   for fd in fds):
                pids.add(int(d))
        except OSError:
            continue
    if os.getpid() not in pids:
        raise AssertionError("cannot tell which processes hold a CUDA context")
    return pids


def tree_state(root: str) -> dict:
    """path -> (size, mtime ns) of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            st = os.stat(os.path.join(d, name))
            out[os.path.relpath(os.path.join(d, name), root)] = (
                st.st_size, st.st_mtime_ns)
    return out


def start_entry(argv, env, log_path):
    """The entrypoint as a service manager starts it: its own session,
    output to ``log_path``."""
    with open(log_path, "w") as log:
        return subprocess.Popen(argv, env=env, stdout=log,
                                stderr=subprocess.STDOUT, cwd=os.path.dirname(
                                    log_path), start_new_session=True)


def stop_entry(proc, timeout: float = 60.0) -> int:
    """SIGTERM to the entrypoint; its exit code. Its whole process group
    is killed if it outlives ``timeout``."""
    import signal

    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=timeout)
    finally:
        kill_group(proc)


def kill_group(proc) -> None:
    import signal

    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def entry_launches(log_path: str) -> tuple[int, str]:
    """(fused_frames launches the CLIs reported, the log's text)."""
    import re

    with open(log_path) as f:
        text = f.read()
    return sum(int(n) for n in re.findall(r"fused_frames_launches=(\d+)",
                                          text)), text


def deploy_env(root: str) -> dict:
    """The environment a service host gives the entrypoint: this
    checkout's CLIs as console-script wrappers first on PATH (write_shims;
    each logs its argv under <root>/argv), config.json a copy of
    release/config.example.json, the kernels' build directory
    <root>/kernels, the card, 16x from the bundled filters, and the web
    plane's directories and OPRA fixture under ``root``."""
    bin_dir, argv_dir = os.path.join(root, "bin"), os.path.join(root, "argv")
    os.makedirs(argv_dir, exist_ok=True)
    write_shims(bin_dir, [n for n in console_scripts() if n.endswith("-torch")],
                argv_dir)
    cfg_path = os.path.join(root, "config.json")
    shutil.copyfile(os.path.join(HERE, "release", "config.example.json"),
                    cfg_path)
    opra = os.path.join(root, "opra.jsonl")
    with open(opra, "w") as f:
        f.write(OPRA_FIXTURE + "\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("TOTTON_")}
    env.update(
        PATH=os.pathsep.join([bin_dir, os.path.dirname(sys.executable),
                              env.get("PATH", "")]),
        PYTHONPATH=HERE, TOTTON_DEVICE="cuda", TOTTON_CONFIG_PATH=cfg_path,
        TOTTON_FILTER_DIR=FILTER_DIR, TOTTON_RATIO="16",
        TOTTON_TORCH_BUILD_DIR=os.path.join(root, "kernels"),
        TOTTON_EQ_DIR=os.path.join(root, "EQ"),
        TOTTON_DATA_DIR=os.path.join(root, "data"), OPRA_DATABASE_PATH=opra,
        TOTTON_STATS_PATH=os.path.join(root, "stats.json"))
    return env


def start_prebuild(work: str):
    """Deploy phase (a), started early: deploy/torch/Dockerfile's prebuild
    command (prebuild_command: both kernels and the native PCM library)
    in a thread, into an empty TOTTON_TORCH_BUILD_DIR under
    <work>/deploy. Returns (thread, result); the result gets "seconds" and
    "proc" when it ends. finish_prebuild joins it."""
    import threading

    root = os.path.join(work, "deploy")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    env = deploy_env(root)
    result = {"build_dir": env["TOTTON_TORCH_BUILD_DIR"]}

    def run():
        t0 = time.monotonic()
        result["proc"] = subprocess.run(
            ["bash", "-c", prebuild_command()], env=env, cwd=root,
            capture_output=True, text=True, timeout=600)
        result["seconds"] = time.monotonic() - t0

    thread = threading.Thread(target=run, name="smoke-prebuild")
    thread.start()
    return thread, result


def finish_prebuild(card, pending) -> None:
    """Deploy phase (a), ended: join start_prebuild's thread (before
    anything is timed), check that it built both kernels and the native
    library and nothing else, and print its seconds and how long the join
    waited."""
    thread, result = pending
    t0 = time.monotonic()
    thread.join()
    waited = time.monotonic() - t0
    proc = result["proc"]
    built = sorted(tree_state(result["build_dir"]))
    if proc.returncode != 0 or {os.path.basename(b) for b in built} != {
            "_totton_native.so", *(f"lib{k}.so" for k in KERNELS)}:
        raise AssertionError(f"prebuild exited {proc.returncode}, built "
                             f"{built}: {proc.stderr[-2000:]}")
    phase("deploy", f"(a) the prebuild of deploy/torch/Dockerfile into an "
          f"empty TOTTON_TORCH_BUILD_DIR, run beside phases 3-4 and joined "
          f"before phase 5 (the first timed one), which waited "
          f"{waited:.2f} s for it: {result['seconds']:.2f} s, "
          f"{', '.join(built)} on {card}")


def deploy_phase(card, work) -> int:
    """The port run the way a service host runs it: deploy/torch/
    entrypoint.sh, bare (no Docker), in deploy_env's environment, after
    the Dockerfile's prebuild (sub-step a: start_prebuild, finish_prebuild)
    into <work>/deploy; nothing is built after it. (b) mode stream alone,
    DEPLOY_STREAM_S of stereo 44.1 kHz from a WAV file to one:
    validate_audio, <= 1 LSB from the same CLI arguments (its wrapper's
    log) run in this process, the child's pid among those holding the card
    while it runs, the wall time and the time to the first output. (c)
    mode all on the null devices and (d) the serve unit's ExecStart and
    environment on a free port, started together: (c) seconds to the
    first control PING, GET /api/status, PUT /api/daemon/phase-type
    linear, RELOAD, then STATS (phase linear, reloads >= 1), blocks
    processed, the card held by the streamer and not by the web plane,
    every child gone within STOP_LIMIT_S of SIGTERM; (d) seconds until it
    listens, two DEPLOY_SERVE_S ServeClient streams against the offline
    kernel output (rel < 1e-5), then SIGTERM. Returns the fused_frames
    launches the entrypoint's CLIs report."""
    import threading

    import numpy as np

    from totton_tpu_torch.control.client import DaemonClient
    from totton_tpu_torch.engine.selector import resolve_filter_path
    from totton_tpu_torch.engine.upsampler import upsample_signal
    from totton_tpu_torch.filters.sidecar import load_filter
    from totton_tpu_torch.io.wav import read_wav, write_wav
    from totton_tpu_torch.testing.validate_output import validate_audio

    started = time.monotonic()
    root = os.path.join(work, "deploy")
    env = deploy_env(root)
    cfg_path, build_dir = env["TOTTON_CONFIG_PATH"], env["TOTTON_TORCH_BUILD_DIR"]
    total = 0
    before = tree_state(build_dir)  # as (a) left it

    # (b) Mode stream alone: a WAV file through the entrypoint.
    write_wav(os.path.join(root, "in.wav"),
              seeded_signal(DEPLOY_STREAM_S, 50), RATE)
    x = read_wav(os.path.join(root, "in.wav"))[0]
    out_path = os.path.join(root, "out.wav")
    log = os.path.join(root, "stream.log")
    e = dict(env, TOTTON_IN=os.path.join(root, "in.wav"), TOTTON_OUT=out_path)
    done, seen = threading.Event(), set()

    def watch_card():  # every pid seen holding the card
        while not done.is_set():
            seen.update(cuda_context_pids())
            time.sleep(0.05)

    watcher = threading.Thread(target=watch_card, daemon=True)
    t0 = time.monotonic()
    proc = start_entry([ENTRYPOINT, "stream"], e, log)
    try:
        child = child_pid(proc.pid, "totton_tpu_torch.cli.stream")
        watcher.start()
        first, marks = None, dict.fromkeys(START_MARKS)
        while proc.poll() is None:
            now = time.monotonic() - t0
            if first is None and os.path.exists(out_path) and (
                    os.path.getsize(out_path) > WAV_HEADER_BYTES):
                first = now
            if None in marks.values():
                with open(log) as f:
                    text = f.read()
                marks.update({k: now for k, v in marks.items()
                              if v is None and k in text})
            time.sleep(0.002)
        wall = time.monotonic() - t0
        rc = proc.returncode
    finally:
        done.set()
        kill_group(proc)
    watcher.join(timeout=30)
    n_b, text = entry_launches(log)
    if rc != 0:
        raise AssertionError(f"entrypoint.sh stream exited {rc}: {text[-3000:]}")
    y, rate = read_wav(out_path)
    report = validate_audio(x, y, output_ratio=16)
    with open(os.path.join(root, "argv", "totton-stream-torch.argv")) as f:
        args = f.read().splitlines()
    ref_path = os.path.join(root, "ref.wav")
    args[args.index("--out") + 1] = ref_path
    args[args.index("--stats-path") + 1] = os.path.join(root, "ref.json")
    rc_ref, _, _ = run_cli(args, capture=True)
    with open(out_path, "rb") as fa, open(ref_path, "rb") as fb:
        same = fa.read() == fb.read()
    bits = 8 * (os.path.getsize(out_path) - WAV_HEADER_BYTES) // y.size
    lsb = 0.0 if same else float(np.abs(
        np.round(y * 2.0 ** (bits - 1))
        - np.round(read_wav(ref_path)[0] * 2.0 ** (bits - 1))).max())
    checks = {
        "validate_audio": report["passed"],
        "16x the input": y.shape == (2, 16 * x.shape[1]) and rate == 16 * RATE,
        "<= 1 LSB from the CLI in-process": rc_ref == 0 and lsb <= 1.0,
        "ran on the card": child in seen and n_b > 0,
        "no build after the prebuild": tree_state(build_dir) == before,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"entrypoint.sh stream failed {failed}: lsb "
                             f"{lsb}, launches {n_b}, {text[-3000:]}")
    total += n_b
    phase("deploy", f"(b) entrypoint.sh stream, {DEPLOY_STREAM_S:g} s stereo "
          f"44.1 kHz WAV -> {rate} Hz s{bits} WAV (config.json's format), "
          f"TOTTON_DEVICE=cuda: exit 0, validate_audio passed, "
          f"{'byte-equal to' if same else f'{lsb:.0f} LSB from'} the same "
          f"arguments run in this process; child pid {child} held the card "
          f"(/dev/nvidiaN open); nothing built; "
          f"fused_frames launches {n_b}; wall {wall:.2f} s; the cold "
          f"start, s after the entrypoint began: "
          + ", ".join(f"'{k}' {v:.2f}" for k, v in marks.items())
          + f", first output {first:.2f} on {card}")

    # (c) Mode all (the streamer with its control plane, and the web
    # plane) and (d) mode serve as its unit runs it, started together.
    endpoint = f"ipc://{root}/c.sock"
    web_port = free_port()
    url = f"http://127.0.0.1:{web_port}"
    log_c = os.path.join(root, "all.log")
    argv, unit_env = unit_service("totton-serve-torch.service")
    serve_port = free_port()
    log_d = os.path.join(root, "serve.log")
    serve_cfg = os.path.join(root, "serve_config.json")
    shutil.copyfile(cfg_path, serve_cfg)  # (c) persists its phase change
    e_d = {**env, **unit_env, **dict(
        TOTTON_CONFIG_PATH=serve_cfg, TOTTON_FILTER_DIR=FILTER_DIR,
        TOTTON_SERVE_LISTEN=f"tcp-listen://127.0.0.1:{serve_port}",
        TOTTON_ZMQ_ENDPOINT=f"ipc://{root}/s.sock",
        TOTTON_SERVE_STATS_PATH=os.path.join(root, "serve.json"))}
    t0 = time.monotonic()
    proc_c = start_entry([ENTRYPOINT, "all"], dict(
        env, TOTTON_IN="null", TOTTON_OUT="null",
        TOTTON_ZMQ_ENDPOINT=endpoint, TOTTON_WEB_PORT=str(web_port)), log_c)
    proc_d = start_entry(argv, e_d, log_d)
    try:
        client = DaemonClient(endpoint=endpoint, timeout_ms=60000)
        while not client.ping():
            if proc_c.poll() is not None or time.monotonic() - t0 > 180:
                raise AssertionError("the streamer never answered PING: "
                                     + entry_launches(log_c)[1][-3000:])
        ping_s = time.monotonic() - t0
        stream = child_pid(proc_c.pid, "totton_tpu_torch.cli.stream")
        web = child_pid(proc_c.pid, "totton_tpu_torch.cli.webserver")
        while True:
            try:
                status, _ = http(url + "/api/status")
                break
            except OSError:
                if proc_c.poll() is not None or time.monotonic() - t0 > 180:
                    raise
                time.sleep(0.05)
        status_s = time.monotonic() - t0
        t1 = time.perf_counter()
        put = http(url + "/api/daemon/phase-type", "PUT",
                   {"phase_type": "linear"})
        put_ms = (time.perf_counter() - t1) * 1e3
        # The daemon counts RELOADs, not phase changes: a RELOAD re-reads
        # config.json, where the phase change was persisted.
        reload = client.reload_config()
        st = client.stats()
        # The streamer has run blocks through the engine (its first,
        # deep dispatch of null input) before the card is read.
        while (blocks := client.stats().data.get("stream", {}).get(
                "blocks_processed", 0)) < 1:
            if proc_c.poll() is not None or time.monotonic() - t0 > 180:
                raise AssertionError("the streamer processed no block: "
                                     + entry_launches(log_c)[1][-3000:])
            time.sleep(0.05)
        pids = cuda_context_pids()
        t1 = time.monotonic()
        rc_c = stop_entry(proc_c, timeout=STOP_LIMIT_S)
        stop_s = time.monotonic() - t1

        while "Serving on" not in entry_launches(log_d)[1]:
            if proc_d.poll() is not None or time.monotonic() - t0 > 300:
                raise AssertionError("the server never listened: "
                                     + entry_launches(log_d)[1][-3000:])
            time.sleep(0.05)
        ready_s = time.monotonic() - t0
        sigs = [seeded_signal(DEPLOY_SERVE_S, 51 + i) for i in range(2)]
        outs, serve_wall = run_clients(serve_port, sigs)
        rc_d = stop_entry(proc_d)
    finally:
        kill_group(proc_c)
        kill_group(proc_d)
    n_c, text = entry_launches(log_c)
    checks = {
        "GET /api/status 200": status == 200,
        "PUT phase-type linear": put[0] == 200 and put[1].get(
            "phase_type") == "linear",
        "RELOAD, then STATS linear, reloads >= 1": reload.ok and st.ok and (
            st.data.get("phase_type") == "linear"
            and st.data.get("reloads", 0) >= 1),
        "streamer on the card, web not": (
            stream in pids and web not in pids and n_c > 0),
        f"children gone within {STOP_LIMIT_S:g} s of SIGTERM": (
            stop_s < STOP_LIMIT_S and not alive(stream) and not alive(web)),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"entrypoint.sh all failed {failed}: STATS "
                             f"{st.data}, PUT {put}, {text[-3000:]}")
    total += n_c
    phase("deploy", f"(c) entrypoint.sh all, null in and out, 16x, started "
          f"with (d): first PING {ping_s:.2f} s after start, GET "
          f"/api/status 200 at {status_s:.2f} s, PUT /api/daemon/phase-type "
          f"linear in {put_ms:.1f} ms, RELOAD, then STATS phase_type linear, "
          f"reloads {st.data['reloads']}, then {blocks} blocks processed; "
          f"the streamer (pid {stream}) held the card, the web plane (pid "
          f"{web}) did not (/dev/nvidiaN open); SIGTERM: exit {rc_c}, both children gone in {stop_s:.2f} s; "
          f"fused_frames launches {n_c} on {card}")

    n_d, text = entry_launches(log_d)
    # The filter the server's own lookup picks (config.json's phase).
    lf = load_filter(resolve_filter_path(
        filter_path=None, filter_dir=FILTER_DIR, phase="minimum", ratio=16,
        input_rate=RATE, latency="normal"))
    rels = [rel_err(y, upsample_signal(x, lf, device="cuda"))
            for x, y in zip(sigs, outs)]
    if not max(rels) < REL_TOL or n_d < 1:
        raise AssertionError(f"entrypoint.sh serve: rel {rels}, launches "
                             f"{n_d}: {text[-3000:]}")
    if tree_state(build_dir) != before:
        raise AssertionError("a CLI built into TOTTON_TORCH_BUILD_DIR after "
                             "the prebuild")
    total += n_d
    no_jax()
    phase("deploy", f"(d) {os.path.relpath(argv[0], HERE)} {argv[1]} with "
          f"totton-serve-torch.service's environment "
          f"(TOTTON_SERVE_MAX_STREAMS={unit_env['TOTTON_SERVE_MAX_STREAMS']})"
          f", {lf.sidecar.taps} taps 16x, started with (c): listening "
          f"{ready_s:.2f} s after start; two f32 ServeClients of "
          f"{DEPLOY_SERVE_S:g} s in {serve_wall:.2f} s: rel vs offline kernel "
          f"output {', '.join(f'{r:.2e}' for r in rels)} (limit "
          f"{REL_TOL:g}); SIGTERM: exit {rc_d}; fused_frames launches {n_d};"
          f" nothing built after (a); the phase took "
          f"{time.monotonic() - started:.1f} s on {card}")
    return total


def _engine_run(eng, steps, swap_before, eq):
    """(outputs, fused_frames launches) of ``eng`` over ``steps`` inputs,
    set_eq(eq) before step ``swap_before``."""
    from totton_tpu_torch.ops import fused_frames as ff

    outs, before = [], ff.LAUNCHES
    for i, x in enumerate(steps):
        if i == swap_before:
            eng.set_eq(eq)
        outs.append(eng.process_block(x))
    return outs, ff.LAUNCHES - before


def host_ms_pair(fa, fb, reps: int = 9) -> tuple[list, list]:
    """Host ms of fa() and of fb() (each returns a host array), ``reps``
    runs each in turns a, b, b, a, ... after one warm run of each; returns
    both lists sorted."""
    fa(), fb()
    ta, tb = [], []
    for i in range(reps):
        for f, t in ((fa, ta), (fb, tb))[::1 if i % 2 == 0 else -1]:
            t0 = time.perf_counter()
            f()
            t.append((time.perf_counter() - t0) * 1e3)
    return sorted(ta), sorted(tb)


def ms_spread(t: list) -> str:
    """'median [min-max]' of a sorted list of ms."""
    return f"{t[len(t) // 2]:.3f} [{t[0]:.3f}-{t[-1]:.3f}]"


def host_ops(f, calls: int = 5, top: int = 4) -> str:
    """Self CPU ms per call of f() over ``calls`` calls (torch.profiler, CPU
    activity only): all operations, then the ``top`` ones as 'name ms
    (launches per call)'."""
    import torch

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(calls):
            f()
    events = sorted(prof.key_averages(),
                    key=lambda e: e.self_cpu_time_total, reverse=True)
    total = sum(e.self_cpu_time_total for e in events) / 1e3 / calls
    return f"all {total:.3f} ms: " + ", ".join(
        f"{e.key} {e.self_cpu_time_total / 1e3 / calls:.3f} ms "
        f"({e.count / calls:g})" for e in events[:top])


def dryrun(args, timeout: int):
    """python -m totton_tpu_torch.parallel.dryrun ``args``; returns (its
    output, the fused_frames launches its ranks report); raises unless it
    printed PASS."""
    import re

    cmd = [sys.executable, "-m", "totton_tpu_torch.parallel.dryrun",
           "--timeout", str(timeout - 30), *args]
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=HERE,
                          timeout=timeout)
    out = proc.stdout + proc.stderr
    if proc.returncode != 0 or "PASS" not in proc.stdout:
        raise AssertionError(f"dryrun {' '.join(args)} exited "
                             f"{proc.returncode}: {out[-4000:]}")
    launches = sum(int(n) for n in re.findall(r"fused_frames launches (\d+)",
                                              out))
    return proc.stdout, launches


def sharded_phase(card, work, lf, device="cuda", cli_seconds=10.0,
                  serve_seconds=(2.0, 3.5, 5.0, 7.3), stream_seconds=5.0,
                  timed_blocks=512) -> int:
    """The sharded engine (parallel/) on one card, sub-steps (a)-(e), each
    on its own line; returns the sharded paths' fused_frames launches.
    (a) a 1x1 mesh equals StreamingUpsampler bit for bit over three steps
    with a faded set_eq between them; (b) 1x2 (time) and 2x1 (channel)
    meshes over [device, device] at full width against StreamingUpsampler
    (rel < 1e-5) through a faded swap, and the host ms of a sharded step
    against a plain step of the same input; (c) two gloo ranks on the one
    device through parallel.dryrun, engine mode and --stream; (d) the CLI
    with --shard-time 1 --shard-channel 1 against the plain CLI (<= 1 LSB)
    and --shard-time 2 exiting 2 on one card; (e) the serve plane on a
    2x1 mesh, four f32 ServeClients against the offline kernel output."""
    import numpy as np
    import torch

    from totton_tpu_torch.engine.upsampler import (
        StreamingUpsampler,
        upsample_signal,
    )
    from totton_tpu_torch.io.wav import read_wav, write_wav
    from totton_tpu_torch.ops import fused_frames as ff
    from totton_tpu_torch.parallel import ShardedUpsampler, make_mesh
    from totton_tpu_torch.serve import StreamServer
    from totton_tpu_torch.testing.signals import sine

    dev = torch.device(device, 0) if device == "cuda" else torch.device(
        device)
    total = 0

    # (a) A 1x1 mesh is the plain block step: bit for bit.
    sh = ShardedUpsampler(lf, make_mesh(1, 1, devices=[dev]), 2,
                          swap_fade_frames=SERVE_FADE)
    cfg = sh.config
    eq = np.linspace(1.0, 0.5, cfg.n_bins)
    pl = StreamingUpsampler(lf, 2, swap_fade_frames=SERVE_FADE, device=dev)
    g = sh.block_input_frames
    x = seeded_signal(3 * g / RATE + 1, 21)
    steps = [x[:, i * g:(i + 1) * g] for i in range(3)]
    ys, n_a = _engine_run(sh, steps, 1, eq)
    refs, _ = _engine_run(pl, steps, 1, eq)
    if not all(np.array_equal(a, b) for a, b in zip(ys, refs)):
        raise AssertionError("1x1 mesh differs from StreamingUpsampler")
    if device == "cuda" and n_a < 1:
        raise AssertionError("the 1x1 mesh never launched fused_frames")
    total += n_a
    phase("sharded", f"(a) 1x1 mesh on {dev}, {cfg.ratio}x/{cfg.taps} "
          f"stereo, 3 steps of {g} frames, a set_eq crossfaded over "
          f"{SERVE_FADE} frames before step 1: bit-equal to "
          f"StreamingUpsampler; fused_frames launches {n_a}")
    del sh, pl

    # (b) Two cells on one device, time and channel meshes, each fed the
    # 1x2 mesh's granule (twice the 1x1 one).
    g *= 2
    for label, (nc, nt) in (("1x2 (time)", (1, 2)), ("2x1 (channel)",
                                                     (2, 1))):
        mesh = make_mesh(nc, nt, devices=[dev, dev])
        sh = ShardedUpsampler(lf, mesh, 2, swap_fade_frames=SERVE_FADE)
        pl = StreamingUpsampler(lf, 2, swap_fade_frames=SERVE_FADE,
                                device=dev)
        x = seeded_signal(4 * g / RATE + 1, 22)
        steps = [x[:, i * g:(i + 1) * g] for i in range(4)]
        ys, n_b = _engine_run(sh, steps, 3, eq)
        refs, _ = _engine_run(pl, steps, 3, eq)
        rel = max(rel_err(a, b) for a, b in zip(ys, refs))
        if not rel < REL_TOL or (device == "cuda" and n_b < 1):
            raise AssertionError(f"{label} mesh: rel {rel}, fused_frames "
                                 f"launches {n_b}")
        total += n_b
        times = []
        for n_in in (g, timed_blocks * cfg.block_in):
            xt = seeded_signal(n_in / RATE + 1, 23)[:, :n_in]
            sh.reset()
            pl.reset()
            times.append((n_in,) + host_ms_pair(
                lambda: sh.process_block(xt), lambda: pl.process_block(xt)))
        # Where the host time of one large step goes, sharded and plain.
        ops = [host_ops(lambda: e.process_block(xt)) for e in (sh, pl)]
        phase("sharded", f"(b) {label} mesh over [{dev}, {dev}], "
              f"{cfg.ratio}x/{cfg.taps} stereo, 3 steps of {g} frames and "
              f"a step after a set_eq crossfaded over {SERVE_FADE} frames: "
              f"rel {rel:.3e} vs StreamingUpsampler (limit {REL_TOL:g}); "
              f"fused_frames launches {n_b}; host ms of one step, sharded "
              f"vs plain, median [min-max] of 9 in turns: " + "; ".join(
                  f"{n} frames {ms_spread(a)} vs {ms_spread(b)} ms "
                  f"({a[len(a) // 2] - b[len(b) // 2]:+.3f} ms)"
                  for n, a, b in times)
              + f"; host ops per {timed_blocks}-block step over 5 steps "
              f"(torch.profiler, self CPU): sharded {ops[0]} | plain "
              f"{ops[1]} on {card}")
        del sh, pl
        if device == "cuda":
            torch.cuda.empty_cache()

    # (c) Two processes on the one device over gloo.
    path = lf.json_path
    out, n_c = dryrun(["--device", device, "--filter", str(path)], 600)
    ranks = [line for line in out.splitlines() if ": ok (" in line]
    out_s, n_s = dryrun(["--stream", "--device", device, "--filter",
                         str(path), "--seconds", str(stream_seconds)], 600)
    if device == "cuda" and (n_c < 1 or n_s < 1):
        raise AssertionError(f"the ranks never launched fused_frames "
                             f"({n_c}, {n_s})")
    total += n_c + n_s
    phase("sharded", f"(c) parallel.dryrun, 2 gloo ranks on {dev}, "
          f"{cfg.ratio}x/{cfg.taps}: PASS; {' | '.join(ranks)}; --stream "
          f"{stream_seconds:g} s: {out_s.strip().splitlines()[-1]}; ranks' "
          f"fused_frames launches {n_c} + {n_s}. NCCL across cards is not "
          "exercised: one H100 cannot host two NCCL ranks")

    # (d) The CLI on a 1x1 mesh, and a mesh one card cannot cover.
    xs = sine(1000.0, cli_seconds, RATE, amplitude=0.5, channels=2)
    in_path = os.path.join(work, "sh_in.wav")
    write_wav(in_path, xs, RATE)
    common = ["--in", in_path, "--filter", str(path), "--format", "s16",
              "--device", device]
    outs, n_d = {}, 0
    for name, extra in (("plain", []), ("1x1", ["--shard-time", "1",
                                                "--shard-channel", "1"])):
        out_path = os.path.join(work, f"sh_{name}.wav")
        rc, n, err = run_cli(common + ["--out", out_path] + extra,
                             capture=True)
        if rc != 0:
            raise AssertionError(f"--shard {name} exited {rc}: {err[-2000:]}")
        outs[name] = read_wav(out_path)[0]
        if name == "1x1":
            n_d = n
            if "Sharded engine: mesh" not in err:
                raise AssertionError("--shard-time 1 ran no sharded engine")
    lsb = max_lsb(outs["1x1"], outs["plain"])
    if not (lsb <= 1.0 and outs["1x1"].shape == (2, xs.shape[1] * cfg.ratio)):
        raise AssertionError(f"--shard-time 1 vs plain CLI: {lsb} LSB")
    if device == "cuda" and n_d < 1:
        raise AssertionError("--shard-time 1 never launched fused_frames")
    total += n_d
    refusal = "not run (a CPU mesh covers any size)"
    if device == "cuda":
        rc, _, err = run_cli(common + ["--out", os.path.join(
            work, "sh_2.wav"), "--shard-time", "2"], capture=True)
        if rc != 2 or "does not cover" not in err:
            raise AssertionError(f"--shard-time 2 on one card exited {rc}: "
                                 f"{err[-1000:]}")
        refusal = f"exit {rc}, '{err.strip().splitlines()[-1]}'"
    phase("sharded", f"(d) totton-stream-torch --shard-time 1 "
          f"--shard-channel 1, {cli_seconds:g} s stereo s16: max {lsb:.0f} "
          f"LSB vs the plain CLI (limit 1); fused_frames launches {n_d}; "
          f"--shard-time 2 on one card: {refusal}")

    # (e) The serve plane's rows split over a 2x1 mesh.
    port = free_port()
    mesh = make_mesh(n_channel=2, n_time=1, devices=[dev, dev])
    before = ff.LAUNCHES
    server = StreamServer(lf, f"tcp-listen://127.0.0.1:{port}", RATE,
                          max_streams=8, channels=2, mesh=mesh,
                          device=device)
    server.start()
    sigs = [seeded_signal(s, 30 + i) for i, s in enumerate(serve_seconds)]
    replies, wall = run_clients(port, sigs)
    server.stop()
    n_e = ff.LAUNCHES - before
    rels = [rel_err(y, upsample_signal(x, lf, device=device))
            for x, y in zip(sigs, replies)]
    if server.failed or not max(rels) < REL_TOL or (
            device == "cuda" and n_e < 1):
        raise AssertionError(f"mesh serve failed={server.failed}, rel "
                             f"{rels}, fused_frames launches {n_e}")
    total += n_e
    no_jax()
    phase("sharded", f"(e) StreamServer on a 2x1 mesh over [{dev}, {dev}], "
          f"{cfg.ratio}x/{cfg.taps}, 8 slots, {len(sigs)} f32 ServeClients "
          f"({'/'.join(f'{s:g}' for s in serve_seconds)} s): rel vs offline "
          f"kernel output {', '.join(f'{r:.2e}' for r in rels)} (limit "
          f"{REL_TOL:g}); fused_frames launched {n_e} times; "
          f"{serve_figures(server, wall)} on {card}")
    return total


def trace_records(path: str) -> tuple[int, int, float]:
    """(launches, kernel records, the least launch-to-kernel-start offset
    in us) of a Chrome trace: a negative offset is the device clock's
    drift behind the host's."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launch = {ev["args"]["correlation"]: ev["ts"] for ev in events
              if "LaunchKernel" in str(ev.get("name", ""))
              and "correlation" in ev.get("args", {})}
    kernels = [ev for ev in events if ev.get("cat") == "kernel"]
    offsets = [ev["ts"] - launch[ev["args"]["correlation"]] for ev in kernels
               if ev.get("args", {}).get("correlation") in launch]
    return len(launch), len(kernels), min(offsets, default=float("nan"))


def trace_window(work, fn, use_trace_context: bool, i: int) -> str:
    """One CUDA profiler window around fn(): trace_context's, or a bare
    torch.profiler window; returns the Chrome trace's path."""
    import glob

    import torch
    from torch.profiler import ProfilerActivity, profile

    from totton_tpu_torch.utils.profiling import trace_context

    if use_trace_context:
        trace_dir = os.path.join(work, f"trace_{i}")
        with trace_context(trace_dir):
            fn()
        files = glob.glob(os.path.join(trace_dir, "trace_*.json"))
        if len(files) != 1:
            raise AssertionError(f"trace_context wrote {files}")
        return files[0]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = os.path.join(work, f"bare_window_{i}.json")
    prof.export_chrome_trace(path)
    return path


def trace_phase(card, work, bundle, cfg, late: bool = False,
                n_frames: int = 1024, bare_windows: int = 3) -> None:
    """trace_context around one dispatch of ``n_frames`` frames. Early in
    the process, (f): the trace keeps the stage plan's fft_stage kernel
    records. At its end, (g): it keeps them or is marked for their loss
    (``profiling.check_kernel_records``), and ``bare_windows`` bare
    torch.profiler windows around the same dispatch show how many keep
    theirs and the least launch-to-kernel offset (the device timestamps'
    shift against the host's). Kineto drops some of a window's device
    records now and then, early in the process too (C13, H2): a window
    that did neither is taken again, up to PROFILE_TRIES windows, and the
    run prints what each such window kept. More frame kernel records
    than the plan has fail at once."""
    import numpy as np
    import torch

    from totton_tpu_torch.ops import fused_frames as ff
    from totton_tpu_torch.utils.profiling import NO_KERNEL_SUFFIX

    frames = torch.from_numpy((np.random.default_rng(5).normal(
        size=(n_frames, cfg.frame_in)) * 0.3).astype(np.float32)).to("cuda")

    def dispatch():
        ff.fused_upsample_frames(frames, bundle, cfg)

    dispatch()  # built and warm
    torch.cuda.synchronize()
    saved = ff.LAUNCHES
    plan = len(ff.flops_per_launch(cfg))
    dropped = []
    for window in range(1, PROFILE_TRIES + 1):
        path = trace_window(work, dispatch, True, f"{int(late)}_{window}")
        with open(path) as f:
            trace = json.load(f)
        events = trace["traceEvents"]
        stages = [ev for ev in events if ev.get("cat") == "kernel"
                  and any(k in str(ev.get("name", "")) for k in FRAME_KERNELS)]
        launches, records, offset = trace_records(path)
        marked = NO_KERNEL_SUFFIX in os.path.basename(path)
        got = (f"{os.path.basename(path)}: {len(stages)} frame kernel "
               f"records, the plan has {plan}; {launches} launches, "
               f"{records} kernel records, marked {marked}")
        if len(stages) > plan:
            raise AssertionError(got)
        if len(stages) == plan or (late and records == 0 and marked
                                   and "tottonKernelRecords" in trace):
            break
        dropped.append(got)
    else:
        lost = " or was marked for losing them all" if late else ""
        raise AssertionError(f"no window of {PROFILE_TRIES} kept the plan's "
                             f"frame kernel records{lost}: "
                             f"{'; '.join(dropped)}")
    probes = [trace_records(trace_window(work, dispatch, False, i))
              for i in range(bare_windows if late else 0)]
    ff.LAUNCHES = saved
    where = ("at the end of the process" if late
             else "early in the process")
    phase("sharded", f"({'g' if late else 'f'}) trace_context around one "
          f"{n_frames // 2}-block {cfg.ratio}x/{cfg.taps} stereo dispatch "
          f"{where}: {os.path.basename(path)} {os.path.getsize(path)} "
          f"bytes, {len(events)} events, {launches} launches, "
          f"{len(stages)} frame kernel records (plan {plan} launches)"
          f"{', marked: no kernel record' if marked else ''}, least "
          f"launch-to-kernel offset {offset:.1f} us; window {window} of at "
          f"most {PROFILE_TRIES}"
          + (f", earlier windows dropped records ({'; '.join(dropped)})"
             if dropped else "")
          + (f"; {len(probes)} bare torch.profiler windows: " + "; ".join(
              f"{n} launches, {k} kernel records, offset {o:.1f} us"
              for n, k, o in probes) if probes else "") + f" on {card}")


def iir_chain_ops(samples: int, bands: int) -> int:
    """Dependent FP32 operations on the cascade's longest chain, per
    channel. Each band's recursion runs y(t) -> a1 * y (FMUL) ->
    fma(b1, v, -a1 * y) (FMA) -> + s2 (FADD) = s1(t) -> y(t + 1) =
    fma(b0, v, s1) (FMA): four dependent operations a sample, whatever
    the schedule. Band i's y(t) also waits for band i - 1's y(t) (one FMA),
    so the bands pipeline one operation apart: 4T + S in all. (The
    kernel's own order, every band of a sample before the next sample,
    chains about T x S FMAs.)"""
    return 4 * samples + bands


def iir_bound_ms(samples: int, bands: int, mhz: float):
    """({"latency", "bytes", "operations": ms}, the side that sets the
    bound) for a stereo cascade of ``bands`` over ``samples``: the chain
    of iir_chain_ops at FP32_LATENCY_CYCLES each and ``mhz``; x and y,
    the state in and out and the coefficients once at the HBM rate; 9
    FLOP a band a sample and the preamp at the fp32 peak."""
    bound = {"latency": (iir_chain_ops(samples, bands) * FP32_LATENCY_CYCLES
                         / (mhz * 1e6) * 1e3),
             "bytes": (2 * 2 * samples * 4 + 2 * 2 * bands * 2 * 4
                       + bands * 5 * 4) / PEAK_BYTES_S * 1e3,
             "operations": 2 * samples * (9 * bands + 1) / PEAK_FP32_FLOPS
             * 1e3}
    return bound, max(bound, key=bound.get)


def cycles_per_sample(ms: float, mhz: float, samples: int) -> float:
    """SM cycles at ``mhz`` per sample of one channel (the channels run
    side by side)."""
    return ms * mhz * 1e3 / samples


def iir_sweep(device, xc, s0, ref, ref_st, mhz):
    """Phase iir (f): the kernel at S = IIR_SWEEP bands on the chunk
    ``xc`` (one launch up to iir.MAX_BANDS bands), each against the plain
    version with a carried state (S = 10 is (a): ``s0``, ``ref``,
    ``ref_st``; above IIR_PLAIN_FULL_BANDS on the first IIR_PLAIN_SHORT
    samples, where the full run's first samples must equal a short run's
    bit for bit) and timed with CUDA events (``launch_ms``). Leaves
    iir.LAUNCHES as it found it. Returns the printed cases."""
    import numpy as np
    import torch

    from totton_tpu_torch.eq import iir
    from totton_tpu_torch.eq.apo import parse_eq_string

    coeffs, preamp = iir.profile_to_coeff_matrix(
        parse_eq_string(IIR_PROFILE_40), RATE)
    c40 = torch.from_numpy(coeffs).to(xc.device)
    st40 = torch.from_numpy((np.random.default_rng(41).normal(
        size=(2, coeffs.shape[0], 2)) * 0.01).astype(np.float32)).to(
        xc.device)
    saved = iir.LAUNCHES
    chunk = xc.shape[1]
    cases = []
    for bands in IIR_SWEEP:
        c = c40[:bands]
        st = s0 if bands == s0.shape[1] else st40[:, :bands].contiguous()
        before = iir.LAUNCHES
        y, y_st = iir.cascade(xc, c, st, preamp)
        launches = iir.LAUNCHES - before
        m = chunk if bands <= IIR_PLAIN_FULL_BANDS else IIR_PLAIN_SHORT
        if bands == s0.shape[1]:
            r, r_st = ref, ref_st
        else:
            r, r_st = iir.cascade_plain(xc[:, :m], c, st, preamp)
        prefix_lsb = 0.0
        if m < chunk:
            y_m, y_st = iir.cascade(xc[:, :m].contiguous(), c, st, preamp)
            prefix_lsb = (y[:, :m] - y_m).abs().max().item()
        rel = ((y[:, :m] - r).abs().max() / r.abs().max()).item()
        st_rel = ((y_st - r_st).abs().max() / r_st.abs().max()).item()
        if not (rel <= REL_TOL and st_rel <= REL_TOL and prefix_lsb == 0.0
                and (device != "cuda"
                     or launches == -(-bands // iir.MAX_BANDS))
                and torch.isfinite(y).all().item()):
            raise AssertionError(
                f"biquad_cascade sweep, {bands} bands: rel {rel:.3e}, state "
                f"rel {st_rel:.3e}, prefix max |diff| {prefix_lsb}, "
                f"launches {launches}")
        ms = (launch_ms(lambda: iir.cascade(xc, c, st, preamp))
              if device == "cuda" else float("nan"))
        bound, side = iir_bound_ms(chunk, bands, mhz)
        cases.append(
            f"S={bands}: {launches} launch{'es' if launches > 1 else ''}, "
            f"rel {rel:.3e}, state rel {st_rel:.3e} vs plain at {m} samples"
            + (f" (the {chunk}-sample run's first {m} equal a {m}-sample "
               f"run's)" if m < chunk else "")
            + f", {ms:.4f} ms = {cycles_per_sample(ms, mhz, chunk):.1f} "
            f"cycles a sample, {bound[side] / ms:.1%} of the {side} bound "
            f"{bound[side]:.4f} ms")
    iir.LAUNCHES = saved
    return cases


def iir_phase(card, device="cuda", seconds=IIR_SECONDS, chunk=IIR_CHUNK):
    """The time-domain EQ cascade (eq/iir.py, csrc/biquad_cascade.cu) on
    IIR_PROFILE, stereo at 44.1 kHz: (a) kernel vs plain at one ``chunk``
    with a carried state (rel, limit REL_TOL; the state too), the plain
    version timed there once; (b) ``biquad_cascade`` on ``seconds`` of
    noise against a float64 ``sosfilt`` (the reference suite's
    tolerance); (c) ``BiquadCascade`` fed ``chunk``-frame chunks equals
    (b) bit for bit; (d) the kernel timed with CUDA events at the chunk
    (per launch back to back, ``launch_ms``, and one call with a cold
    L2) and on the whole signal (ms per second of audio), with SM cycles
    a sample; (e) its bound; (f) the band sweep (``iir_sweep``). Returns the
    kernels-line entry; its launches are (b) and (c)'s."""
    import numpy as np
    import torch
    from scipy import signal as ssig

    from totton_tpu_torch.eq import iir
    from totton_tpu_torch.eq.apo import parse_eq_string

    profile = parse_eq_string(IIR_PROFILE)
    coeffs, preamp = iir.profile_to_coeff_matrix(profile, RATE)
    bands = coeffs.shape[0]
    dev = torch.device(device)
    c = torch.from_numpy(coeffs).to(dev)
    rng = np.random.default_rng(40)
    saved = iir.LAUNCHES

    # (a) Kernel vs plain on the same chunk and state.
    xc = torch.from_numpy((rng.normal(size=(2, chunk)) * 0.3).astype(
        np.float32)).to(dev)
    s0 = torch.from_numpy((rng.normal(size=(2, bands, 2)) * 0.01).astype(
        np.float32)).to(dev)
    y, st = iir.cascade(xc, c, s0, preamp)
    if device == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ref, ref_st = iir.cascade_plain(xc, c, s0, preamp)
        end.record()
        end.synchronize()
        p_ms = start.elapsed_time(end)
    else:
        ref, ref_st = iir.cascade_plain(xc, c, s0, preamp)
        p_ms = float("nan")
    err = (y - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    st_rel = ((st - ref_st).abs().max() / ref_st.abs().max()).item()
    if not (rel <= REL_TOL and st_rel <= REL_TOL
            and torch.isfinite(y).all().item()):
        raise AssertionError(f"biquad_cascade vs plain: rel {rel:.3e}, "
                             f"state rel {st_rel:.3e}")

    # (b), (c): the user's entry points, launches counted.
    x = (rng.normal(size=(2, int(seconds * RATE))) * 0.3).astype(np.float32)
    iir.LAUNCHES = 0
    one_shot = iir.biquad_cascade(x, profile, RATE, device=device)
    casc = iir.BiquadCascade(profile, RATE, 2, device=device)
    streamed = np.concatenate([casc.process(x[:, i:i + chunk])
                               for i in range(0, x.shape[1], chunk)], 1)
    launches = iir.LAUNCHES
    sos = np.concatenate([coeffs[:, :3], np.ones((bands, 1), np.float32),
                          coeffs[:, 3:]], 1).astype(np.float64)
    oracle = ssig.sosfilt(sos, x.astype(np.float64) * preamp, axis=-1)
    o_rel = float(np.abs(one_shot - oracle).max() / np.abs(oracle).max())
    o_ok = np.allclose(one_shot, oracle, rtol=IIR_ORACLE_RTOL,
                       atol=IIR_ORACLE_ATOL)
    s_lsb = float(np.abs(streamed - one_shot).max())
    if not (o_ok and s_lsb == 0.0 and np.isfinite(one_shot).all()):
        raise AssertionError(f"biquad_cascade: oracle rel {o_rel:.3e} "
                             f"(allclose {o_ok}); streamed vs one-shot "
                             f"max |diff| {s_lsb}")
    if device == "cuda" and launches < 1:
        raise AssertionError("the cascade never launched biquad_cascade")

    # (d) Kernel times (launches not counted), (e) the bound.
    k_ms = k_one_ms = k_all_ms = mhz = float("nan")
    if device == "cuda":
        xt = torch.from_numpy(x).to(dev)
        z = torch.zeros((2, bands, 2), dtype=torch.float32, device=dev)
        k_ms = launch_ms(lambda: iir.cascade(xc, c, s0, preamp))
        k_one_ms = cuda_time_ms(lambda: iir.cascade(xc, c, s0, preamp))
        k_all_ms = cuda_time_ms(lambda: iir.cascade(xt, c, z, preamp),
                                warmup=1, reps=3)
        mhz = card_max_sm_mhz()
        del xt
    iir.LAUNCHES = saved + launches
    chain = iir_chain_ops(chunk, bands)
    bound, bound_by = iir_bound_ms(chunk, bands, mhz)
    # (f) The band sweep (its launches not counted).
    sweep = iir_sweep(device, xc, s0, ref, ref_st, mhz)
    no_jax()
    phase("iir", f"{bands}-band APO cascade (PK/LS/HS), stereo 44.1 kHz: "
          f"(a) kernel vs plain at {chunk} samples, carried state: rel "
          f"{rel:.3e}, state rel {st_rel:.3e} (limit {REL_TOL:g}); (b) "
          f"{seconds:g} s of noise vs float64 sosfilt: max|diff|/max|ref| "
          f"{o_rel:.3e} (allclose rtol {IIR_ORACLE_RTOL:g} atol "
          f"{IIR_ORACLE_ATOL:g}: {o_ok}); (c) {chunk}-frame chunks vs "
          f"one-shot max |diff| {s_lsb:g}; biquad_cascade launches "
          f"{launches}; (d) kernel {k_ms:.4f} ms per {chunk}-sample chunk "
          f"(per launch, {chunk}-sample chunks back to back; "
          f"{cycles_per_sample(k_ms, mhz, chunk):.1f} cycles a sample at "
          f"{mhz:g} MHz; one call with a cold L2, host enqueue included: "
          f"{k_one_ms:.4f} ms), {k_all_ms:.3f} ms for {seconds:g} s "
          f"({k_all_ms / seconds:.4f} ms per second of audio, "
          f"{cycles_per_sample(k_all_ms, mhz, x.shape[1]):.1f} cycles a "
          f"sample), plain {p_ms:.1f} ms per chunk (one run); (e) bound at "
          f"{chunk} samples {bound[bound_by]:.4f} ms ({bound_by}: {chain} "
          f"dependent FP32 operations x {FP32_LATENCY_CYCLES} cycles at "
          f"{mhz:g} MHz; bytes {bound['bytes']:.6f}, operations "
          f"{bound['operations']:.6f}); kernel at "
          f"{bound[bound_by] / k_ms:.1%} of it on {card}")
    phase("iir", f"(f) band sweep at {chunk} samples, stereo, carried "
          f"state, ms per launch back to back (limit rel {REL_TOL:g}): "
          + "; ".join(sweep)
          + f" on {card}")
    return {
        "name": "biquad_cascade",
        "route": "cuda",
        "source": "totton_tpu_torch/csrc/biquad_cascade.cu",
        "replaces": "totton_tpu/eq/iir.py:43",
        "launches": launches,
        "max_abs_err": err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound[bound_by],
        "bound_by": bound_by,
        "library_ms": None,
        "shape": f"2 x {chunk} samples, {bands} bands",
        "ms_per_audio_second": k_all_ms / seconds,
        "one_call_ms": k_one_ms,
    }


# ---- phase ci: what the port's CI cannot run on a CPU runner -----------

# (a) The cuda-marked tests: every one is in this file, which imports no
# jax (both checked by tests/test_torch_copies.py) and needs no conftest.
CI_TESTS = "tests/test_torch_cuda.py"
# The frame counts and geometries its test_cuda_kernel_matches_plain holds
# the kernel to against the plain version (tests/test_torch_chip_
# geometries.py keeps them equal to the test's): phase 3 skips those
# counts at those geometries and runs the rest of PARITY_FRAMES.
CI_FRAME_COUNTS = (2, 16, 18, 64, 128, 1024)
CI_FILTERS = (SERVED["16x_80k"], SERVED["2x_80k"], SERVED["16x_8k"],
              SERVED["2x_8k"], "ratio 1 (1025, 4096) identity + APO EQ")
# (b) The port's e2e script, on the card and on the CPU.
E2E_SCRIPT = os.path.join("scripts", "torch", "e2e_local_file_test.sh")
# (c) The installed wheel: seconds of 16x/80k stereo through its CLI.
WHEEL_SECONDS = 3.0


def ci_pytest_argv(junit: str) -> list[str]:
    """(a)'s command: the cuda-marked tests without the conftest (it
    imports jax, which the card's machine lacks), results to ``junit``."""
    return [sys.executable, "-m", "pytest", "-p", "no:cacheprovider",
            "--noconftest", "-m", "cuda", CI_TESTS, f"--junitxml={junit}"]


def junit_counts(path: str) -> dict[str, int]:
    """tests, passed, failures, errors and skipped of a pytest junit XML."""
    import xml.etree.ElementTree as ET

    root = ET.parse(path).getroot()
    suite = root if root.tag == "testsuite" else root.find("testsuite")
    n = {k: int(suite.get(k, 0))
         for k in ("tests", "failures", "errors", "skipped")}
    n["passed"] = n["tests"] - n["failures"] - n["errors"] - n["skipped"]
    return n


def e2e_run(work: str, device: str | None) -> dict:
    """scripts/torch/e2e_local_file_test.sh as a CI job runs it, with
    TOTTON_DEVICE unset (the card) or ``device``, and the kernels' build
    directory this process built. The script keeps nothing, so a wrapper
    named ``python`` first on PATH runs each of its python commands and
    keeps a copy of the streamer's output WAV. Returns the exit code,
    output, seconds, the streamer's launches and the kept WAV's path."""
    import re
    import shlex

    from totton_tpu_torch.ops import _build

    label = device or "cuda"
    bin_dir = os.path.join(work, f"e2e_bin_{label}")
    keep = os.path.join(work, f"e2e_{label}.wav")
    os.makedirs(bin_dir, exist_ok=True)
    shim = os.path.join(bin_dir, "python")
    with open(shim, "w") as f:
        f.write(f"#!{sys.executable}\n"
                "import shutil, subprocess, sys\n"
                "args = sys.argv[1:]\n"
                f"rc = subprocess.call([{sys.executable!r}, *args])\n"
                "if rc == 0 and args[:2] == "
                "['-m', 'totton_tpu_torch.cli.stream']:\n"
                "    shutil.copyfile(args[args.index('--out') + 1], "
                f"{keep!r})\n"
                "sys.exit(rc)\n")
    os.chmod(shim, 0o755)
    env = {k: v for k, v in os.environ.items() if not k.startswith("TOTTON_")}
    env.update(PATH=os.pathsep.join([bin_dir, env.get("PATH", "")]),
               TOTTON_TORCH_BUILD_DIR=str(_build.build_root()))
    if device is not None:
        env["TOTTON_DEVICE"] = device
    t0 = time.monotonic()
    proc = subprocess.run(["bash", E2E_SCRIPT], env=env, cwd=HERE,
                          capture_output=True, text=True, timeout=600)
    out = proc.stdout + proc.stderr
    launches = re.findall(r"fused_frames_launches=(\d+)", out)
    return {"rc": proc.returncode, "out": out,
            "seconds": time.monotonic() - t0, "keep": keep,
            "launches": int(launches[-1]) if launches else None,
            "command": f"{'' if device is None else f'TOTTON_DEVICE={device} '}"
                       f"bash {shlex.quote(E2E_SCRIPT)}"}


def wheel_python(root: str) -> str:
    return os.path.join(root, "venv", "bin", "python")


def wheel_env(root: str) -> dict:
    """An installed package's environment: no checkout on PYTHONPATH, no
    TOTTON_TORCH_BUILD_DIR, a fresh XDG_CACHE_HOME under ``root``, the
    venv first on PATH."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TOTTON_") and k != "PYTHONPATH"}
    env.update(XDG_CACHE_HOME=os.path.join(root, "cache"),
               PATH=os.pathsep.join([os.path.dirname(wheel_python(root)),
                                     env.get("PATH", "")]))
    return env


def start_wheel(work: str):
    """Phase ci (c), started early beside deploy (a): build this
    checkout's wheel offline (pip wheel --no-deps --no-build-isolation,
    from a copy of the files the wheel takes), install it with --no-deps
    --no-index into a venv made with --system-site-packages, and from a
    temporary directory, with the venv's python, run the image's prebuild
    (prebuild_command: both kernels and the native library), which builds
    into the fresh XDG_CACHE_HOME. Where this interpreter is itself a venv
    its site-packages (torch) are not the system's, so the new venv gets a
    .pth naming them. Returns (thread, result); finish_wheel joins it."""
    import shlex
    import sysconfig
    import threading

    root = os.path.join(work, "wheel")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "cwd"))
    result = {"root": root, "steps": []}

    def step(name, argv, **kw):
        t0 = time.monotonic()
        proc = subprocess.run(argv, capture_output=True, text=True,
                              timeout=600, **kw)
        result["steps"].append((name, time.monotonic() - t0))
        if proc.returncode != 0:
            raise RuntimeError(f"{name} exited {proc.returncode}: "
                               f"{(proc.stdout + proc.stderr)[-3000:]}")
        return proc.stdout

    def run():
        try:
            src = os.path.join(root, "src")
            skip = shutil.ignore_patterns("__pycache__", "*.so")
            for name in ("totton_tpu", "totton_tpu_torch"):
                shutil.copytree(os.path.join(HERE, name),
                                os.path.join(src, name), ignore=skip)
            for name in ("pyproject.toml", "README.md", "LICENSE"):
                shutil.copyfile(os.path.join(HERE, name),
                                os.path.join(src, name))
            dist = os.path.join(root, "dist")
            step("pip wheel", [sys.executable, "-m", "pip", "wheel",
                               "--no-deps", "--no-build-isolation",
                               "--no-index", "-w", dist, src])
            (wheel,) = [os.path.join(dist, n) for n in os.listdir(dist)
                        if n.endswith(".whl")]
            result["wheel"] = wheel
            venv = os.path.join(root, "venv")
            step("venv", [sys.executable, "-m", "venv",
                          "--system-site-packages", venv])
            if sys.prefix != sys.base_prefix:
                purelib = subprocess.run(
                    [wheel_python(root), "-c", "import sysconfig; "
                     "print(sysconfig.get_paths()['purelib'])"],
                    capture_output=True, text=True, check=True).stdout.strip()
                with open(os.path.join(purelib, "smoke_outer_site.pth"),
                          "w") as f:
                    f.write(sysconfig.get_paths()["purelib"] + "\n")
            step("pip install", [wheel_python(root), "-m", "pip", "install",
                                 "--no-deps", "--no-index", wheel])
            (_, _, code), = [shlex.split(prebuild_command())]
            out = step("prebuild", [wheel_python(root), "-c", code
                                    + "; import totton_tpu_torch; "
                                    "print(totton_tpu_torch.__file__)"],
                       env=wheel_env(root), cwd=os.path.join(root, "cwd"))
            result["package"] = out.strip().splitlines()[-1]
        except (OSError, RuntimeError, ValueError,
                subprocess.SubprocessError) as e:
            result["error"] = repr(e)

    thread = threading.Thread(target=run, name="smoke-wheel")
    thread.start()
    return thread, result


def finish_wheel(card, pending) -> dict:
    """Phase ci (c), the build ended: join start_wheel's thread (before
    anything is timed) and check that the venv's package is the wheel's
    (not this checkout) and that the prebuild built both kernels and the
    native library into the fresh cache, under the same source hash as
    this checkout's build."""
    from totton_tpu_torch.ops import _build

    thread, result = pending
    t0 = time.monotonic()
    thread.join()
    waited = time.monotonic() - t0
    if "error" in result:
        raise AssertionError(f"ci (c): the wheel failed: {result['error']}")
    root = result["root"]
    cache = os.path.join(root, "cache", "totton_tpu_torch")
    built = sorted(tree_state(cache)) if os.path.isdir(cache) else []
    want = sorted([os.path.join("native", "_totton_native.so")] + [
        os.path.join(os.path.basename(os.path.dirname(_build.build(k))),
                     f"lib{k}.so") for k in KERNELS])
    package = result.get("package", "")
    checks = {
        "the package is the venv's": package.startswith(
            os.path.join(root, "venv")),
        "both kernels and the native library in the fresh cache, as this "
        "checkout's hash": built == want,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"ci (c) failed {failed}: package {package}, "
                             f"built {built}, expected {want}")
    phase("ci", f"(c) {os.path.basename(result['wheel'])} built offline "
          f"(pip wheel --no-deps --no-build-isolation) and installed "
          f"--no-deps --no-index into a venv, then the image's prebuild run "
          f"by its python from a temporary directory, TOTTON_TORCH_BUILD_DIR "
          f"unset: " + ", ".join(f"{n} {s:.2f} s" for n, s in result["steps"])
          + f" (the prebuild: nvcc of both kernels from the wheel's "
          f"sources, cold, into XDG_CACHE_HOME); {', '.join(built)}; run "
          f"beside phases 3-4, joined before phase 5, which waited "
          f"{waited:.2f} s for it, on {card}")
    return result


def ci_phase(card, work, wheel) -> int:
    """What the port's CI (.github/workflows/ci-torch.yml, a CPU runner)
    cannot run, on the card. (a) CI_TESTS, the cuda-marked tests, in a
    pytest subprocess with --noconftest and this process's build
    directory: passed must equal collected, nothing skipped. (b) the e2e
    script with TOTTON_DEVICE unset (the card): [e2e] PASS and the
    streamer's fused_frames launches > 0, its wall time, and its output
    within 1 LSB at 16 bits of the same script with TOTTON_DEVICE=cpu (run
    beside (a)). (c) the installed wheel (start_wheel, finish_wheel): its
    totton-stream-torch from a temporary directory, WHEEL_SECONDS of
    16x/80k stereo s16 on the card, launching the kernel built into the
    fresh cache (nothing built now), within 1 LSB of this checkout's CLI on
    the same arguments (run in this process). Returns the fused_frames
    launches of (b) and (c), that run included."""
    import re
    import threading

    import numpy as np

    from totton_tpu_torch.io.wav import read_wav, write_wav
    from totton_tpu_torch.ops import _build

    started = time.monotonic()
    # (b) on the CPU, beside (a): neither is timed.
    cpu = {}
    cpu_thread = threading.Thread(
        target=lambda: cpu.update(e2e_run(work, "cpu")), name="smoke-e2e-cpu")
    cpu_thread.start()

    # (a) The cuda-marked tests.
    junit = os.path.join(work, "ci_cuda.xml")
    env = dict(os.environ, PYTHONPATH=HERE,
               TOTTON_TORCH_BUILD_DIR=str(_build.build_root()))
    before = tree_state(str(_build.build_root()))
    t0 = time.monotonic()
    proc = subprocess.run(ci_pytest_argv(junit), env=env, cwd=HERE,
                          capture_output=True, text=True, timeout=900)
    a_s = time.monotonic() - t0
    out = proc.stdout + proc.stderr
    n = junit_counts(junit) if os.path.exists(junit) else {}
    summary = out.strip().splitlines()[-1] if out.strip() else ""
    if not (proc.returncode == 0 and n.get("tests", 0) > 0
            and n["passed"] == n["tests"] and n["skipped"] == 0
            and "deselected" not in summary
            and tree_state(str(_build.build_root())) == before):
        raise AssertionError(f"ci (a): pytest exited {proc.returncode}, "
                             f"{n}: {out[-4000:]}")
    phase("ci", f"(a) {' '.join(ci_pytest_argv('<xml>')[1:])}: "
          f"collected {n['tests']}, passed {n['passed']}, skipped "
          f"{n['skipped']}, failed {n['failures'] + n['errors']} "
          f"('{summary}'), nothing rebuilt; {a_s:.2f} s on {card}")

    # (b) The e2e script on the card, alone, then against the CPU run.
    cuda = e2e_run(work, None)
    cpu_thread.join()
    for r in (cuda, cpu):
        if r.get("rc") != 0 or "[e2e] PASS" not in r.get("out", ""):
            raise AssertionError(f"ci (b): {r.get('command')} exited "
                                 f"{r.get('rc')}: {r.get('out', '')[-3000:]}")
    if not cuda["launches"] or cpu["launches"] != 0:
        raise AssertionError(f"ci (b): fused_frames launches {cuda['launches']}"
                             f" on the card, {cpu['launches']} on the cpu")
    (y, rate), (yc, rate_c) = read_wav(cuda["keep"]), read_wav(cpu["keep"])
    bits = 8 * (os.path.getsize(cuda["keep"]) - WAV_HEADER_BYTES) // y.size
    pcm = []
    for path in (cuda["keep"], cpu["keep"]):
        with open(path, "rb") as f:
            pcm.append(np.frombuffer(f.read()[WAV_HEADER_BYTES:],
                                     f"<i{bits // 8}").astype(np.int64))
    lsb_own = int(np.abs(pcm[0] - pcm[1]).max())
    lsb = max_lsb(y, yc)
    if not (rate == rate_c and lsb <= 1.0):
        raise AssertionError(f"ci (b): cuda vs cpu {lsb} LSB at 16 bits, "
                             f"rates {rate} {rate_c}")
    report = re.search(r'"correlation": ([\d.e-]+)', cuda["out"])
    phase("ci", f"(b) {cuda['command']} (the card): [e2e] PASS, "
          f"correlation {report[1] if report else '?'}, fused_frames "
          f"launches {cuda['launches']} (a 2001-tap 2x filter at fft 2048, "
          f"block 48), wall {cuda['seconds']:.2f} s; against "
          f"{cpu['command']} ({cpu['seconds']:.2f} s, beside (a)): "
          f"{y.shape[1]} frames at {rate} Hz s{bits}, max {lsb:.0f} LSB at "
          f"16 bits (limit 1), {lsb_own} LSB at s{bits} on {card}")

    # (c) The installed wheel's CLI on the card.
    root = wheel["root"]
    cache = os.path.join(root, "cache")
    before = tree_state(cache)
    in_path = os.path.join(root, "in.wav")
    write_wav(in_path, seeded_signal(WHEEL_SECONDS, 60), RATE)
    args = ["--in", in_path, "--ratio", "16", "--filter-dir", FILTER_DIR,
            "--format", "s16", "--device", "cuda", "--out"]
    t0 = time.monotonic()
    proc = subprocess.run(
        [os.path.join(os.path.dirname(wheel_python(root)),
                      "totton-stream-torch"), *args,
         os.path.join(root, "wheel.wav")],
        env=wheel_env(root), cwd=os.path.join(root, "cwd"),
        capture_output=True, text=True, timeout=600)
    c_s = time.monotonic() - t0
    found = re.findall(r"fused_frames_launches=(\d+)", proc.stderr)
    c_launches = int(found[-1]) if found else 0
    rc_ref, ref_launches, _ = run_cli(
        args + [os.path.join(root, "repo.wav")], capture=True)
    yw, yr = (read_wav(os.path.join(root, f"{n}.wav"))[0]
              for n in ("wheel", "repo"))
    lsb_c = max_lsb(yw, yr)
    checks = {
        "exit 0": proc.returncode == 0 and rc_ref == 0,
        "the kernel launched": c_launches > 0,
        "nothing built at run time": tree_state(cache) == before,
        "<= 1 LSB from this checkout's CLI": lsb_c <= 1.0,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"ci (c) failed {failed}: {proc.stderr[-3000:]}")
    phase("ci", f"(c) the venv's totton-stream-torch, {WHEEL_SECONDS:g} s "
          f"stereo 44.1 kHz -> 16x/80k s16 on the card from a temporary "
          f"directory: exit 0, fused_frames launches {c_launches} from the "
          f"kernel in the fresh cache (nothing built), {c_s:.2f} s; max "
          f"{lsb_c:.0f} LSB from this checkout's CLI on the same arguments "
          f"(limit 1) on {card}")
    phase("ci", f"phase ci took {time.monotonic() - started:.2f} s")
    return cuda["launches"] + c_launches + ref_launches


def main() -> int:
    try:
        import numpy as np
        import torch

        from totton_tpu_torch.filters.sidecar import load_filter
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
    started = time.monotonic()
    card = card_line()
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    phase("env", f"card {card} | torch {torch.__version__} CUDA "
          f"{torch.version.cuda} | {nvcc[-1]}")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 must be off on the signal path")
    dev = torch.device("cuda")

    # 2. Build the kernels from the checkout's sources, in parallel.
    t0 = time.monotonic()
    builds = build_kernels()
    phase("build", f"{', '.join(f'{k} {v:.2f} s' for k, v in builds.items())}"
          f" (nvcc in parallel); built and loaded in "
          f"{time.monotonic() - t0:.2f} s")

    work = os.path.join(HERE, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    profile = write_profile(work)
    # The image's prebuild (phase 13b, sub-step a) and the wheel's build,
    # install and prebuild into a fresh cache (phase 14b, sub-step c) on
    # the CPU's cores while phases 3-4 check the kernels on the card
    # (nothing there is timed); joined at the end of phase 4.
    prebuild = start_prebuild(work)
    wheel = start_wheel(work)

    # 3. Kernel vs plain on the card at the main path's ragged frame counts
    # at every served geometry, and the ratio-1 (halves) branch at the same
    # counts and at 1024; where phase ci (a) holds a geometry at
    # CI_FRAME_COUNTS, only the other counts.
    rng = np.random.default_rng(0)
    main_err = 0.0
    served = {key: engine_state(name, dev) for key, name in SERVED.items()}
    states = [(name, *served[key][1:3]) for key, name in SERVED.items()]
    states += ratio1_states(dev, profile)
    for name, cfg, bundle, *_ in states:
        rels = []
        counts = PARITY_FRAMES + ((1024,) if cfg.ratio == 1 else ())
        if name in CI_FILTERS:  # the rest in phase ci (a)
            counts = tuple(n for n in counts if n not in CI_FRAME_COUNTS)
        for n in counts:
            frames = torch.from_numpy(
                (rng.normal(size=(n, cfg.frame_in)) * 0.3).astype(np.float32)
            ).to(dev)
            rel, err = kernel_vs_plain(frames, bundle, cfg)
            rels.append(f"{n}: {rel:.3e}")
            if name == MAIN_FILTER:
                main_err = max(main_err, err)
        split = kernel_split_diff(bundle, cfg)
        phase("parity", f"{name}: kernel vs plain rel by frame count "
              f"{{{', '.join(rels)}}} (limit rel {REL_TOL:g}); kernel, "
              f"{SPLIT_BLOCKS} stereo blocks in runs of "
              f"{', '.join(map(str, SPLIT_RUNS))} vs one dispatch: max "
              f"|diff| {split:g} (limit 0)")
        if split != 0:
            raise AssertionError(f"{name}: a frame's kernel output depends "
                                 f"on its dispatch (max |diff| {split:g})")
    del states

    # 4. Kernel vs the float64 oracle at every served geometry (three
    # launches at 80k, resident at 8k), 32 blocks each; the classic
    # odd-overlap program.
    lf, cfg, bundle, hspec = served["16x_80k"]
    for key, (f, c, b, _) in served.items():
        name = SERVED[key]
        k_db, p_db = snr_db(f, c, b, rng)
        phase("snr", f"{name} ({c.ratio}x, {c.taps} taps) vs float64 oracle,"
              f" {SNR_BLOCKS} blocks: kernel {k_db:.2f} dB, plain "
              f"{p_db:.2f} dB (gate > {SNR_GATE_DB:g})")
        if not k_db > SNR_GATE_DB:
            raise AssertionError(f"{name}: SNR {k_db:.2f} dB below the gate")
    classic_phase(card, rng)
    finish_prebuild(card, prebuild)
    wheel = finish_wheel(card, wheel)

    # 5. The main path: totton-stream-torch, file mode, 16x/80k stereo s16.
    from totton_tpu_torch.io.wav import read_wav, write_wav
    from totton_tpu_torch.testing.signals import sine
    from totton_tpu_torch.testing.validate_output import validate_audio
    from totton_tpu_torch.cli import stream as stream_cli

    fs = 44100
    in_path = os.path.join(work, "in.wav")
    out_path = os.path.join(work, "out.wav")
    stats_path = os.path.join(work, "stats.json")
    try:
        x = sine(1000.0, 40.0, fs, amplitude=0.5, channels=2)
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
        for path in (in_path, out_path):
            if os.path.exists(path):
                os.remove(path)
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
    # 5b. The CLI at the other served ratios: 4x and 8x, and 8x low latency
    # from 48 kHz.
    ratios_launches = ratios_phase(card, work)

    # 6. Kernel vs plain vs the torch.fft composition (library), compared
    # and timed in turns with a cold L2, one 16x/80k stereo dispatch of 512
    # blocks; the bound; each launch's device time (the three-launch
    # plan), and the same at 16x/8k (the resident plan, one launch) and at
    # the six other served geometries.
    main_r = frame_reading("16x/80k", cfg, bundle, hspec, rng)
    main_err = max(main_err, main_r["err"])
    phase("time", reading_line(main_r, card))
    n = 2 * main_r["blocks"]
    phase("bound", f"512 blocks stereo 16x/80k: "
          f"{ff.flops_per_frame(cfg) * n / 1e9:.2f} GFLOP "
          f"({main_r['bound']['operations']:.4f} ms at "
          f"{PEAK_FP32_FLOPS / 1e12:g} TFLOP/s fp32), "
          f"{ff.bound_bytes(cfg, n) / 1e6:.1f} MB each input read and each "
          f"output written once ({main_r['bound']['bytes']:.4f} ms at "
          f"{PEAK_BYTES_S / 1e12:g} TB/s); bound "
          f"{main_r['bound'][main_r['bound_by']]:.4f} ms "
          f"({main_r['bound_by']}); kernel at "
          f"{main_r['bound'][main_r['bound_by']] / main_r['ms']['kernel']:.1%}"
          f" of it")
    low_r = frame_reading("16x/8k", *served["16x_8k"][1:], rng)
    phase("time-8k", reading_line(low_r, card))
    # The six other served geometries (4x and 8x have no other timing).
    served_r = {}
    for key in SERVED:
        if key not in ("16x_80k", "16x_8k"):
            served_r[key] = frame_reading(key.replace("_", "/"),
                                          *served[key][1:], rng)
            phase("time-served", reading_line(served_r[key], card))
    del served

    # 7b. trace_context around one 512-block dispatch (the sharded phase's
    # sub-step f), early: late in the process torch.profiler drops the
    # device records of some windows (sub-step g).
    trace_phase(card, work, bundle, cfg)

    # 8. The serve plane at 16x/80k: four concurrent f32 streams on an
    # 8-slot server, a live swap to the linear-phase filter under two.
    lin = load_filter(os.path.join(FILTER_DIR,
                                   "filter_44k_16x_80000_linear_phase.json"))
    serve_launches, server = serve_phase(card, lf, lin, "cuda")
    costs = step_costs_ms(server, [(8, 1), (8, 16), (16, 16), (64, 16)])
    phase("serve-shapes", f"16x/80k one serve step, host ms of the first/"
          f"second/third run after emptying the caches, and its device "
          f"memory peak: {'; '.join(costs)} on {card}")
    del server
    torch.cuda.empty_cache()

    # 9. The low-latency bank (16x/8k), device PCM, twelve concurrent 2 s
    # s16 streams on 16 slots (so the 8- and 16-slot widths both run).
    low = load_filter(os.path.join(FILTER_DIR, LOW_FILTER + ".json"))
    low_launches = serve_low_phase(card, low, "cuda", work)
    torch.cuda.empty_cache()
    # 9b. The serving plane's control surface and fault paths: the serve
    # CLI's control endpoint (RELOAD under 8 streams), a fleet leader and
    # follower, and the chaos client mix in process.
    sc_launches = serve_control_phase(card, work, low)
    torch.cuda.empty_cache()

    # 10. Ratio 1 (the kernel's halves branch) through the CLI, EQ only,
    # and the time-domain EQ cascade on its own kernel.
    t0 = time.monotonic()
    r1_launches, r1 = ratio1_phase(card, work)
    phase("ratio1", f"phase ratio1 took {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    iir_entry = iir_phase(card)
    phase("iir", f"phase iir took {time.monotonic() - t0:.1f} s")
    # 11. The threaded session in file mode, 16x/80k.
    th_launches = threaded_phase(card, work)
    # 12. The crossfeed chain, engine level and CLI, 16x/80k.
    cf_launches = crossfeed_phase(card, work, lf)
    torch.cuda.empty_cache()
    # 13. The live product path: socket input, threaded, control endpoint.
    live_launches = live_phase(card, work)
    # 13b. The same CLIs as a service host runs them: the entrypoint's
    # stream, all and serve modes, bare, after the image's kernel prebuild.
    torch.cuda.empty_cache()
    deploy_launches = deploy_phase(card, work)
    # 14. The sharded engine, the CLI and the serve plane on meshes over
    # the one card, two processes on it, and trace_context.
    torch.cuda.empty_cache()
    sh_launches = sharded_phase(card, work, lf)
    # 14b. What the port's CI cannot run on a CPU runner: the cuda-marked
    # tests, the e2e script and the installed wheel, on the card.
    torch.cuda.empty_cache()
    ci_launches = ci_phase(card, work, wheel)
    # 15. trace_context at the end of the process: its kernel records, or
    # the trace marked for their loss (sub-step g).
    trace_phase(card, work, bundle, cfg, late=True)
    shutil.rmtree(work, ignore_errors=True)

    phase("done", f"every phase passed in {time.monotonic() - started:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "fused_frames",
        "route": "cuda",
        "source": "totton_tpu_torch/csrc/fused_frames.cu",
        "replaces": "totton_tpu/experimental/pallas_kernels.py:284",
        "launches": (launches + ratios_launches + serve_launches
                     + low_launches + sc_launches + r1_launches
                     + th_launches
                     + cf_launches + live_launches + deploy_launches
                     + sh_launches + ci_launches),
        "launches_per_dispatch": main_r["per_dispatch"],
        "max_abs_err": main_err,
        "ms": main_r["ms"]["kernel"],
        "plain_ms": main_r["ms"]["plain"],
        "bound_ms": main_r["bound"][main_r["bound_by"]],
        "bound_by": main_r["bound_by"],
        "library_ms": main_r["ms"]["library"],
        "ratio1": reading_entry(r1),
        "16x_8k": reading_entry(low_r),
        **{key: reading_entry(r) for key, r in served_r.items()},
    }, iir_entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def frames_main(root: str) -> int:
    """``python3 chip_smoke.py --frames ROOT``: the frame kernel of the
    checkout at ROOT (its package and kernel sources, built into its own
    build directory; e.g. a parent commit unpacked under build/) timed by
    frame_reading at 512 stereo blocks of ratio 1 (1025, 4096) with the
    APO EQ and of every served geometry (SERVED), so that two versions can
    be run in turns in one call on one card. Prints one phase line each
    and a JSON line of the nine."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import totton_tpu_torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    card = card_line()
    work = os.path.join(HERE, "build", "chip_smoke_frames")
    os.makedirs(work, exist_ok=True)
    package = os.path.dirname(os.path.abspath(totton_tpu_torch.__file__))
    rng = np.random.default_rng(7)
    readings = {"ratio1": ratio1_reading(card, write_profile(work), rng)}
    for key, name in SERVED.items():
        r = frame_reading(name, *engine_state(name, "cuda")[1:], rng)
        phase("frames", reading_line(r, card))
        readings[key] = r
    no_jax()
    print(json.dumps({"package": package, "card": card, **{
        k: reading_entry(r) for k, r in readings.items()}}))
    return 0


#: (rows, K, N) of a frame's product in the plain programs: a one-stage
#: DFT of a frame (rows 1), two-stage DFT stages, a pruned inverse stage.
PROBE_SHAPES = ((1, 512, 512), (1, 64, 64), (32, 64, 64), (64, 64, 32),
                (128, 128, 64))
PROBE_FRAMES = 1024
PROBE_COUNTS = (1, 2, 3, 7, 64, 100, 513)
#: Stereo blocks a dispatch of the plain programs the card runs on a
#: user's path (the classic program, the crossfeed step) holds: a live
#: period's few and a file's deep SPLIT_BLOCKS.
LIVE_BLOCKS = (1, 2, 4, 8, SPLIT_BLOCKS)
#: ``ops.fft.CUDA_BATCH`` values ``--plain`` sweeps where the checkout
#: has the constant.
PLAIN_BATCHES = (8, 16, 32, 64, 128, 256)


def bmm_probe(dev, raw: bool = True) -> dict:
    """For each PROBE_SHAPES product against a constant expanded with
    stride 0: the max |diff| of the first b of PROBE_FRAMES seeded frames
    as one ``torch.bmm`` of b frames (``raw``) against the same frames in
    one bmm of all PROBE_FRAMES, by b in PROBE_COUNTS; and the same
    through the checkout's ``ops.fft.frame_matmul`` where it has one."""
    import torch

    from totton_tpu_torch.ops import fft as tfft

    gen = torch.Generator(device="cpu").manual_seed(3)
    mm = getattr(tfft, "frame_matmul", None)
    out = {}
    for rows, k, n in PROBE_SHAPES:
        x = torch.randn(PROBE_FRAMES, rows, k, generator=gen).to(dev)
        w = torch.randn(k, n, generator=gen).to(dev)
        runs = {}
        if raw:
            runs["bmm"] = lambda a: torch.bmm(a, w.expand(a.shape[0], k, n))
        if mm is not None:
            runs["frame_matmul"] = lambda a: mm(a, w)
        for name, fn in runs.items():
            whole = fn(x)
            out[f"{name} {rows}x{k}x{n}"] = {
                b: (fn(x[:b]) - whole[:b]).abs().max().item()
                for b in PROBE_COUNTS}
    return out


def plain_main(root: str) -> int:
    """``python3 chip_smoke.py --plain ROOT``: the plain frame programs of
    the checkout at ROOT on the card, for parent-vs-change calls in turns
    on one card.

    The 16x/80k split_frames dispatch through the folded program; then,
    for each PLAIN_BATCHES value of ``ops.fft.CUDA_BATCH`` (once where
    the checkout has none), the
    classic program at CLASSIC_GEOMETRY and the crossfeed step on a
    seeded 3102-tap set (the M size) at every LIVE_BLOCKS count, each by
    cuda_time_ms (the host's launch pace included) and graph_ms (the
    card's own time), the classic program's split_diff and ``bmm_probe``
    through ``frame_matmul``; the raw ``torch.bmm`` probe once. Prints
    one JSON line; exits 1 if a split was not 0 or there is no card."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import totton_tpu_torch
    from totton_tpu_torch.engine import crossfeed as tcf
    from totton_tpu_torch.filters.sidecar import load_filter
    from totton_tpu_torch.ops import fft as tfft
    from totton_tpu_torch.ops import overlap_save as osv

    def upsampler(bundle, cfg):
        return lambda f: osv.upsample_frames(f, bundle, cfg)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    splits = {}
    out = {"package": os.path.dirname(os.path.abspath(
               totton_tpu_torch.__file__)),
           "blocks": SPLIT_BLOCKS, "channels": 2}
    dev = torch.device("cuda")
    card = {"card": card_line()}
    lf = load_filter(os.path.join(FILTER_DIR, MAIN_FILTER + ".json"))
    cfg = osv.OverlapSaveConfig.from_sidecar(lf.sidecar)
    bundle = osv.fold_bundle(osv.filter_spectrum(
        lf.taps, cfg.fft_size, device=dev), cfg)
    fd = split_frames(cfg.frame_in, dev)
    run = upsampler(bundle, cfg)
    card["16x_80k_folded_ms"] = cuda_time_ms(lambda: run(fd))
    del bundle, run, fd
    rng = np.random.default_rng(7)
    taps, fft, ratio = CLASSIC_GEOMETRY
    ccfg = osv.OverlapSaveConfig(taps, fft, fft - taps + 1, ratio)
    h = rng.normal(size=taps) * np.exp(-np.arange(taps) / (taps / 8))
    classic = upsampler(osv.fold_bundle(
        osv.filter_spectrum(h, fft, device=dev), ccfg), ccfg)
    cframes = split_frames(ccfg.frame_in, dev)
    xcfg = tcf._cf_geometry(3102)
    spec = np.fft.rfft(rng.normal(size=(4, xcfg.taps)) * np.exp(
        -np.arange(xcfg.taps) / 400.0), xcfg.fft_size)
    hs = tuple(torch.from_numpy(v.astype(np.float32)).to(dev)
               for v in (spec.real, spec.imag))
    step = tcf._make_cf_step(xcfg)
    xs = torch.from_numpy((rng.normal(
        size=(2, SPLIT_BLOCKS * xcfg.block_in)) * 0.3).astype(
            np.float32)).to(dev)
    tail = torch.zeros((2, xcfg.halo_in), device=dev)
    batches = PLAIN_BATCHES if hasattr(tfft, "CUDA_BATCH") else (None,)
    for b in batches:
        if b is not None:
            tfft.CUDA_BATCH = b
        row = {}
        for n in LIVE_BLOCKS:
            cf = cframes[:, :n].contiguous()
            x = xs[:, :n * xcfg.block_in].contiguous()
            for name, fn in (("classic", lambda: classic(cf)),
                             ("crossfeed", lambda: step(tail, x, hs))):
                row[f"{name} {n} ms"] = cuda_time_ms(fn)
                row[f"{name} {n} device ms"] = graph_ms(fn)
        splits[f"cuda classic CUDA_BATCH {b}"] = split_diff(classic,
                                                            cframes)
        row["probe"] = bmm_probe(dev, raw=False)
        card[f"CUDA_BATCH {b}"] = row
    card["bmm_probe"] = bmm_probe(dev, raw=True)
    out["cuda"] = card
    out["splits"] = splits
    no_jax()
    print(json.dumps(out))
    return int(any(v != 0 for v in splits.values()))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--frames"] and len(sys.argv) == 3:
        sys.exit(frames_main(sys.argv[2]))
    if sys.argv[1:2] == ["--plain"] and len(sys.argv) == 3:
        sys.exit(plain_main(sys.argv[2]))
    sys.exit(main())
