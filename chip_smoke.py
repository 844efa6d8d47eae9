#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: python3 chip_smoke.py

Builds the port's CUDA frame kernel from this checkout's sources, checks it
against its plain torch version (at every frame count the main path gives
it) and against a float64 oracle, drives the port's main path
(``totton-stream-torch`` file mode, 16x / 80001 taps, stereo s16, the
bundled filter) through the kernel, times kernel and plain version and
each of the kernel's four launches, serves concurrent client streams
through the port's ``StreamServer`` (16x/80k f32 with a live filter swap;
the 16x/8k bank with device PCM and s16 clients) against the offline
kernel output, and prints one JSON line per kernel and a final status
line:

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
# tail dispatches (64, 16, 2), one off every tile edge (18), a round 128,
# and the serve steps' rows x blocks (8 stereo slots at 2 and 16 blocks:
# 32, 256; 16 slots at 16 blocks: 512).
PARITY_FRAMES = (2, 16, 18, 32, 64, 128, 256, 512)
RATE = 44100
SERVE_FADE = 4096    # output frames of the live swap's crossfade
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


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_clients(port, signals, fmt=None, split=None, swap=None):
    """Stream each [2, n] signal through its own ServeClient, all connected
    at once, each sent in 1 s bursts from a pump thread while its reply is
    read. A stream i in ``split`` (i -> input frames) holds after that many
    frames until ``swap()`` has run; swap() runs once every held stream has
    read its first part's output and every other stream has finished.
    Returns (outputs, wall seconds from connect to the last reply byte)."""
    import threading

    import numpy as np

    from totton_tpu.io.serve_client import ServeClient

    split = split or {}
    outs = [None] * len(signals)
    errors = []
    gate = threading.Event()
    first = {i: threading.Event() for i in split}

    def stream(i, x):
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

    from totton_tpu.testing.validate_output import validate_audio
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


def serve_low_phase(card, low, device, n_streams=12, seconds=2.0) -> int:
    """Serve ``n_streams`` s16 streams at once on a 16-slot device-PCM
    StreamServer (both the 8- and the 16-slot widths run). Gates: every
    reply within one LSB of float_to_pcm(offline upsample_signal);
    fused_frames launched; the server did not fail; no jax. Returns the
    launches."""
    import numpy as np

    from totton_tpu.io.pcm import (
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
    outs, wall = run_clients(port, sigs, fmt=s16)
    server.stop()
    launches = ff.LAUNCHES
    figures = serve_figures(server, wall)
    if server.failed or (device == "cuda" and launches < 1):
        raise AssertionError(f"serve-low failed={server.failed}, "
                             f"fused_frames launches {launches}")
    lsb = 0.0
    for x, y in zip(sigs, outs):
        ref = s16_roundtrip(upsample_signal(s16_roundtrip(x), low,
                                            device=device))
        if y.shape != ref.shape:
            raise AssertionError(f"reply shape {y.shape} != {ref.shape}")
        lsb = max(lsb, float(np.abs(y - ref).max()) * 32768)
    if not lsb <= 1.0:
        raise AssertionError(f"serve-low off by {lsb} LSB")
    if not any(key.startswith("16x") for key in server.stats.steps_by_shape):
        raise AssertionError("the 16-slot width never ran")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    phase("serve-low", f"{low.sidecar.taps} taps {server.config.ratio}x, "
          f"16 slots, device PCM, {n_streams} s16 streams of {seconds:g} "
          f"s: max {lsb:.0f} LSB vs float_to_pcm(offline kernel output) "
          f"(limit 1); fused_frames launches {launches}; start "
          f"{warm_s:.2f} s; {figures} on {card}")
    return launches


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
    low_launches = serve_low_phase(card, low, "cuda")

    print(json.dumps({"kernels": [{
        "name": "fused_frames",
        "route": "cuda",
        "source": "totton_tpu_torch/csrc/fused_frames.cu",
        "replaces": "totton_tpu/experimental/pallas_kernels.py:284",
        "launches": launches + serve_launches + low_launches,
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
