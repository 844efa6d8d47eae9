#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: python3 chip_smoke.py

Builds the port's CUDA frame kernel from this checkout's sources, checks it
against its plain torch version (at every frame count the main path gives
it) and against a float64 oracle, drives the port's main path
(``totton-stream-torch`` file mode, 16x / 80001 taps, stereo s16, the
bundled filter) through the kernel, times the kernel against its plain
version and the same function composed of ``torch.fft`` calls (cuFFT,
the yardstick ``library_ms``) with a cold L2, computes the kernel's bound
from its work, times each of its launches, serves concurrent client streams
through the port's ``StreamServer`` (16x/80k f32 with a live filter swap;
the 16x/8k bank with device PCM and s16 clients) against the offline
kernel output, runs the kernel's ratio-1 branch through the CLI's EQ-only
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
version and a float64 ``sosfilt``, streamed in chunks and timed. It
prints one JSON line with both kernels and a final status line:

  {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": N}}

Exits non-zero, printing no result, without CUDA or outside the repository.
Imports nothing of JAX and nothing of the JAX package (``totton_tpu``).
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
MAIN_FILTER = "filter_44k_16x_80000_min_phase"
PARITY_FILTERS = (MAIN_FILTER, "filter_44k_2x_80000_min_phase",
                  "filter_44k_16x_8000_min_phase")
REL_TOL = 1e-5       # kernel vs plain on the card (fp32, other sum order)
SNR_GATE_DB = 125.0  # vs the float64 oracle (bench.py's gate)
# Frame counts the main path hands the kernel besides its full 512-block
# stereo dispatch (1024 frames, checked in phase 6): the ragged 32/8/1-block
# tail dispatches (64, 16, 2), one off every tile edge (18), a round 128,
# and the serve steps' rows x blocks (8 stereo slots at 2 and 16 blocks:
# 32, 256; 16 slots at 16 blocks: 512).
PARITY_FRAMES = (2, 16, 18, 32, 64, 128, 256, 512)
RATE = 44100
SERVE_FADE = 4096    # output frames of the live swap's crossfade
# The kernel's launches by their store functor (fft_stage<N, INV, Load,
# Store>): the fused forward (F) or its two four-step launches (F1, F2),
# then I1 and I2.
LAUNCH_NAMES = {"SpecStore": "F", "FwdStage1Store": "F1",
                "FwdStage2Store": "F2", "InvStage1Store": "I1",
                "OutStore": "I2"}
# The card's peaks (NVIDIA's data sheet, H100 SXM at 700 W): fp32 on the
# CUDA cores and HBM3; bound_ms is the larger of the two times.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
L2_FLUSH_BYTES = 128 * 2**20  # more than the 50 MB L2
KERNELS = ("fused_frames", "biquad_cascade")
# The time-domain EQ cascade (phase iir): a 10-band APO profile of PK, LS
# and HS bands at 44.1 kHz, stereo; kernel vs plain at one 4096-sample
# chunk, the float64 oracle on 60 s of noise.
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
IIR_SECONDS = 60.0
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


def launch_times_ms(fn, labels, reps: int = 3):
    """(device ms per launch of each of the kernel's launches (``labels``,
    e.g. F, I1, I2), kernel launches per call of fn()) from torch.profiler
    over ``reps`` calls of fn(), each after an L2 flush; (None, None)
    where the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush_l2()
            fn()
        torch.cuda.synchronize()
    out, launches = {}, 0
    for ev in prof.key_averages():
        if "fft_stage" not in ev.key:
            continue
        us = max(getattr(ev, a, 0) or 0 for a in (
            "device_time_total", "self_device_time_total",
            "cuda_time_total", "self_cuda_time_total"))
        for store, label in LAUNCH_NAMES.items():
            if store in ev.key and us > 0:
                out[label] = us / 1e3 / ev.count
                launches += ev.count
    if set(out) != set(labels):
        return None, None
    return out, launches // reps if launches % reps == 0 else launches / reps


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
    if device == "cuda" and server._bundle.absorbed:
        raise AssertionError("the live swap folded GW on the card; the "
                             "kernel takes G")
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


def ratio1_phase(card, work, device="cuda", seconds=40.0):
    """totton-stream-torch --ratio 1 --eq-profile on ``device`` against the
    same command on the CPU (<= 1 LSB), then kernel vs plain timed at a
    512-block ratio-1 stereo dispatch. Returns the launches."""
    import numpy as np
    import torch

    from totton_tpu_torch.io.wav import read_wav, write_wav
    from totton_tpu_torch.testing.signals import sine
    from totton_tpu_torch.ops import fused_frames as ff
    from totton_tpu_torch.ops import overlap_save as osv

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
    (_, cfg, bundle, spec), = [s for s in ratio1_states(device, profile)
                               if s[1].taps == 1025]
    k_ms = p_ms = l_ms = lib_rel = float("nan")
    n = 2 * 512
    bound, bound_by = kernel_bound_ms(cfg, n)
    if device == "cuda":
        frames = torch.from_numpy((np.random.default_rng(2).normal(
            size=(n, cfg.frame_in)) * 0.3).astype(np.float32)).to(device)
        hspec = torch.complex(spec[0], spec[1])
        ref = osv.upsample_frames(frames, bundle, cfg)
        lib_rel = ((library_frames(frames, hspec, cfg) - ref).abs().max()
                   / ref.abs().max()).item()
        saved = ff.LAUNCHES
        k_ms = cuda_time_ms(lambda: ff.fused_upsample_frames(frames, bundle,
                                                              cfg))
        p_ms = cuda_time_ms(lambda: osv.upsample_frames(frames, bundle, cfg))
        l_ms = cuda_time_ms(lambda: library_frames(frames, hspec, cfg))
        ff.LAUNCHES = saved
        del frames, ref
    no_jax()
    phase("ratio1", f"totton-stream-torch --ratio 1 --eq-profile (3-band APO EQ, "
          f"identity 1025 taps, fft 4096), {seconds:g} s stereo s16: "
          f"{device} vs cpu max {lsb:.0f} LSB (limit 1); fused_frames "
          f"launches {launches}; wall {walls[device]:.2f} s ({device}), "
          f"{walls['cpu']:.2f} s (cpu); peak level {eq_db:+.2f} dB vs input; "
          f"512 blocks stereo ratio 1, cold L2: kernel {k_ms:.3f} ms, plain "
          f"{p_ms:.3f} ms, torch.fft composition {l_ms:.3f} ms (vs plain rel "
          f"{lib_rel:.3e}); bound {bound[bound_by]:.4f} ms ({bound_by}; "
          f"operations {bound['operations']:.4f}, bytes "
          f"{bound['bytes']:.4f}), kernel at "
          f"{bound[bound_by] / k_ms:.1%} of it on {card}")
    return launches


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
    crossfeed step's share of one ``time_blocks``-block dispatch; (b) the
    CLI with --crossfeed passes validate_audio. Returns the launches."""
    import numpy as np
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
        import torch

        cf = chain.crossfeed
        y_dev = torch.from_numpy(y_up[:, :y_up.shape[1] - y_up.shape[1]
                                      % cf.config.block_in].copy()).to(device)
        cf_ms = cuda_time_ms(lambda: cf._step(cf._tail, y_dev, cf._h),
                             warmup=1, reps=3)
        del y_dev
        torch.cuda.empty_cache()

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
          f"{cf_ms:.3f} ms; (b) --crossfeed CLI {seconds[1]:g} s: exit {rc}, "
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
    if device == "cuda" and any(b.absorbed for b in server._bundle.values()):
        raise AssertionError("the mesh server folded GW on the card")
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
    shift against the host's)."""
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
    path = trace_window(work, dispatch, True, int(late))
    probes = [trace_records(trace_window(work, dispatch, False, i))
              for i in range(bare_windows if late else 0)]
    ff.LAUNCHES = saved
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    stages = [ev for ev in events if "fft_stage" in str(ev.get("name", ""))
              and ev.get("cat") == "kernel"]
    plan = len(ff.flops_per_launch(cfg))
    launches, records, offset = trace_records(path)
    marked = NO_KERNEL_SUFFIX in os.path.basename(path)
    kept = len(stages) == plan
    if not (kept or (late and records == 0 and marked
                     and "tottonKernelRecords" in trace)):
        raise AssertionError(f"{path}: {len(stages)} fft_stage kernel "
                             f"records, the plan has {plan}; {launches} "
                             f"launches, {records} kernel records, marked "
                             f"{marked}")
    where = ("at the end of the process" if late
             else "early in the process")
    phase("sharded", f"({'g' if late else 'f'}) trace_context around one "
          f"{n_frames // 2}-block {cfg.ratio}x/{cfg.taps} stereo dispatch "
          f"{where}: {os.path.basename(path)} {os.path.getsize(path)} "
          f"bytes, {len(events)} events, {launches} launches, "
          f"{len(stages)} fft_stage kernel records (plan {plan} launches)"
          f"{', marked: no kernel record' if marked else ''}, least "
          f"launch-to-kernel offset {offset:.1f} us"
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


def iir_phase(card, device="cuda", seconds=IIR_SECONDS, chunk=IIR_CHUNK):
    """The time-domain EQ cascade (eq/iir.py, csrc/biquad_cascade.cu) on
    IIR_PROFILE, stereo at 44.1 kHz: (a) kernel vs plain at one ``chunk``
    with a carried state (rel, limit REL_TOL; the state too), the plain
    version timed there once; (b) ``biquad_cascade`` on ``seconds`` of
    noise against a float64 ``sosfilt`` (the reference suite's
    tolerance); (c) ``BiquadCascade`` fed ``chunk``-frame chunks equals
    (b) bit for bit; (d) the kernel timed with CUDA events at the chunk
    and on the whole signal (ms per second of audio); (e) its bound.
    Returns the kernels-line entry; its launches are (b) and (c)'s."""
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
    k_ms = k_all_ms = mhz = float("nan")
    if device == "cuda":
        xt = torch.from_numpy(x).to(dev)
        z = torch.zeros((2, bands, 2), dtype=torch.float32, device=dev)
        k_ms = cuda_time_ms(lambda: iir.cascade(xc, c, s0, preamp))
        k_all_ms = cuda_time_ms(lambda: iir.cascade(xt, c, z, preamp),
                                warmup=1, reps=3)
        mhz = card_max_sm_mhz()
        del xt
    iir.LAUNCHES = saved + launches
    chain = iir_chain_ops(chunk, bands)
    bound = {"latency": chain * FP32_LATENCY_CYCLES / (mhz * 1e6) * 1e3,
             "bytes": (2 * 2 * chunk * 4 + 2 * 2 * bands * 2 * 4
                       + bands * 5 * 4) / PEAK_BYTES_S * 1e3,
             "operations": 2 * chunk * (9 * bands + 1) / PEAK_FP32_FLOPS
             * 1e3}
    bound_by = max(bound, key=bound.get)
    no_jax()
    phase("iir", f"{bands}-band APO cascade (PK/LS/HS), stereo 44.1 kHz: "
          f"(a) kernel vs plain at {chunk} samples, carried state: rel "
          f"{rel:.3e}, state rel {st_rel:.3e} (limit {REL_TOL:g}); (b) "
          f"{seconds:g} s of noise vs float64 sosfilt: max|diff|/max|ref| "
          f"{o_rel:.3e} (allclose rtol {IIR_ORACLE_RTOL:g} atol "
          f"{IIR_ORACLE_ATOL:g}: {o_ok}); (c) {chunk}-frame chunks vs "
          f"one-shot max |diff| {s_lsb:g}; biquad_cascade launches "
          f"{launches}; (d) kernel {k_ms:.4f} ms per {chunk}-sample chunk, "
          f"{k_all_ms:.3f} ms for {seconds:g} s ({k_all_ms / seconds:.4f} "
          f"ms per second of audio), plain {p_ms:.1f} ms per chunk (one "
          f"run); (e) bound at {chunk} samples {bound[bound_by]:.4f} ms "
          f"({bound_by}: {chain} dependent FP32 operations x "
          f"{FP32_LATENCY_CYCLES} cycles at {mhz:g} MHz; bytes "
          f"{bound['bytes']:.6f}, operations {bound['operations']:.6f}); "
          f"kernel at {bound[bound_by] / k_ms:.1%} of it on {card}")
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
    }


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

    def engine_state(name):
        lf = load_filter(os.path.join(FILTER_DIR, name + ".json"))
        cfg = osv.OverlapSaveConfig.from_sidecar(lf.sidecar)
        spec = osv.filter_spectrum(lf.taps, cfg.fft_size, device=dev)
        bundle = osv.fold_bundle(spec, cfg)
        if bundle.absorbed:
            raise AssertionError(f"{name}: the card folded GW; the kernel "
                                 "takes the folded G")
        return lf, cfg, bundle

    work = os.path.join(HERE, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    profile = write_profile(work)

    # 3. Kernel vs plain on the card at the main path's ragged frame counts,
    # and the ratio-1 (halves) branch at the same counts and at 1024.
    rng = np.random.default_rng(0)
    main_err = 0.0
    states = [(name, *engine_state(name)[1:]) for name in PARITY_FILTERS]
    states += ratio1_states(dev, profile)
    for name, cfg, bundle, *_ in states:
        rels = []
        counts = PARITY_FRAMES + ((1024,) if cfg.ratio == 1 else ())
        for n in counts:
            frames = torch.from_numpy(
                (rng.normal(size=(n, cfg.frame_in)) * 0.3).astype(np.float32)
            ).to(dev)
            rel, err = kernel_vs_plain(frames, bundle, cfg)
            rels.append(f"{n}: {rel:.3e}")
            if name == MAIN_FILTER:
                main_err = max(main_err, err)
        phase("parity", f"{name}: kernel vs plain rel by frame count "
              f"{{{', '.join(rels)}}} (limit rel {REL_TOL:g})")
        del bundle
    del states

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

    # 6. Kernel vs plain vs the torch.fft composition (library), compared
    # and timed in turns (kernel, plain, library, library, plain, kernel;
    # the median of each one's runs), one 16x/80k stereo dispatch, the L2
    # flushed before every timed run.
    timings = {}
    saved = ff.LAUNCHES
    hspec = torch.fft.rfft(
        torch.from_numpy(lf.taps.astype(np.float64)).to(dev),
        n=cfg.fft_size).to(torch.complex64)
    for blocks in (512, 1024):
        frames = torch.from_numpy(
            (rng.normal(size=(2 * blocks, cfg.frame_in)) * 0.3)
            .astype(np.float32)).to(dev)
        rel, err = kernel_vs_plain(frames, bundle, cfg)
        main_err = max(main_err, err)
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
        k_ms, p_ms, l_ms = (min(runs[k]) for k in fns)
        medians = {k: [round(v, 4) for v in r] for k, r in runs.items()}
        out_samples = 2 * blocks * cfg.block_size
        timings[blocks] = (k_ms, p_ms, l_ms)
        phase("time", f"{blocks} blocks stereo 16x/80k, cold L2: kernel vs "
              f"plain rel {rel:.3e}, torch.fft composition vs plain rel "
              f"{lib_rel:.3e}; kernel {k_ms:.3f} ms "
              f"({out_samples / k_ms / 1e6:.3f} G samples/s), plain "
              f"{p_ms:.3f} ms, torch.fft composition {l_ms:.3f} ms "
              f"(the lower of two medians of 5; medians {json.dumps(medians)})"
              f" on {card}")
        del frames
    torch.cuda.empty_cache()
    n = 2 * 512
    flops = ff.flops_per_frame(cfg) * n
    nbytes = ff.bound_bytes(cfg, n)
    bound, bound_by = kernel_bound_ms(cfg, n)
    phase("bound", f"512 blocks stereo 16x/80k: {flops / 1e9:.2f} GFLOP "
          f"({bound['operations']:.4f} ms at {PEAK_FP32_FLOPS / 1e12:g} "
          f"TFLOP/s fp32), {nbytes / 1e6:.1f} MB each input read and each "
          f"output written once ({bound['bytes']:.4f} ms at "
          f"{PEAK_BYTES_S / 1e12:g} TB/s); bound {bound[bound_by]:.4f} ms "
          f"({bound_by}); kernel at {bound[bound_by] / timings[512][0]:.1%} "
          f"of it")

    # 7. Device time of each of the kernel's launches, 512 blocks.
    labels = list(ff.flops_per_launch(cfg))
    frames = torch.from_numpy(
        (rng.normal(size=(n, cfg.frame_in)) * 0.3).astype(np.float32)).to(dev)
    try:
        per_launch, per_dispatch = launch_times_ms(
            lambda: ff.fused_upsample_frames(frames, bundle, cfg), labels)
        why = "the profiler recorded no device time"
    except RuntimeError as e:  # the profiler, not the kernel, failed
        per_launch, per_dispatch, why = None, None, f"profiler error: {e}"
    ff.LAUNCHES = saved
    del frames
    if per_launch is None:
        phase("launches", f"per-launch device time and launches per "
              f"dispatch: not measured ({why})")
    else:
        if per_dispatch != len(labels):
            raise AssertionError(
                f"the profiler saw {per_dispatch} kernel launches per "
                f"dispatch; the stage plan has {len(labels)} ({labels})")
        fl, by = ff.flops_per_launch(cfg), ff.bytes_per_launch(cfg)
        parts = [f"{k} {per_launch[k]:.3f} ms "
                 f"({fl[k] * n / per_launch[k] / 1e9:.1f} TFLOP/s, "
                 f"{by[k] * n / per_launch[k] / 1e6:.0f} GB/s)"
                 for k in labels]
        total = sum(per_launch.values())
        phase("launches", f"512 blocks stereo 16x/80k, torch.profiler, "
              f"cold L2: {per_dispatch:g} launches a dispatch; "
              f"{', '.join(parts)}; sum {total:.3f} ms "
              f"({ff.flops_per_frame(cfg) * n / total / 1e9:.1f} TFLOP/s, "
              f"{sum(by.values()) * n / total / 1e6:.0f} GB/s of scratch "
              f"and frame traffic) on {card}")

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
    low = load_filter(os.path.join(FILTER_DIR,
                                   "filter_44k_16x_8000_min_phase.json"))
    low_launches = serve_low_phase(card, low, "cuda", work)
    torch.cuda.empty_cache()

    # 10. Ratio 1 (the kernel's halves branch) through the CLI, EQ only,
    # and the time-domain EQ cascade on its own kernel.
    r1_launches = ratio1_phase(card, work)
    iir_entry = iir_phase(card)
    # 11. The threaded session in file mode, 16x/80k.
    th_launches = threaded_phase(card, work)
    # 12. The crossfeed chain, engine level and CLI, 16x/80k.
    cf_launches = crossfeed_phase(card, work, lf)
    torch.cuda.empty_cache()
    # 13. The live product path: socket input, threaded, control endpoint.
    live_launches = live_phase(card, work)
    # 14. The sharded engine, the CLI and the serve plane on meshes over
    # the one card, two processes on it, and trace_context.
    torch.cuda.empty_cache()
    sh_launches = sharded_phase(card, work, lf)
    # 15. trace_context at the end of the process: its kernel records, or
    # the trace marked for their loss (sub-step g).
    trace_phase(card, work, bundle, cfg, late=True)
    shutil.rmtree(work, ignore_errors=True)

    print(json.dumps({"kernels": [{
        "name": "fused_frames",
        "route": "cuda",
        "source": "totton_tpu_torch/csrc/fused_frames.cu",
        "replaces": "totton_tpu/experimental/pallas_kernels.py:284",
        "launches": (launches + serve_launches + low_launches + r1_launches
                     + th_launches + cf_launches + live_launches
                     + sh_launches),
        "launches_per_dispatch": per_dispatch,
        "max_abs_err": main_err,
        "ms": timings[512][0],
        "plain_ms": timings[512][1],
        "bound_ms": bound[bound_by],
        "bound_by": bound_by,
        "library_ms": timings[512][2],
    }, iir_entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
