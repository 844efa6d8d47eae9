"""Multi-process dry run of the sharded engine over torch.distributed:

  python -m totton_tpu_torch.parallel.dryrun [--device cuda|cpu]
                                             [--stream | --cli]

Runs on the card (``--device cuda``, the default; without CUDA it exits
2) unless the caller passes ``--device cpu``. Spawns ``--nproc`` ranks
(default 2) joined over ``--backend`` (default gloo; nccl needs a card per
rank) on a free local port, each with one mesh cell on CUDA (the card its
``LOCAL_RANK`` names) or two CPU cells, and checks them against the
single-process engine on the same device:

- engine mode (the default): a time-sharded mesh (1 x nproc*k, k the
  cells a rank has; each rank feeds only its own time span, the boundary
  halo goes rank to rank), four steps, and a channel-only mesh
  (nproc*k x 1; each rank its own channel rows), two steps; on the time mesh every rank schedules one EQ swap for step
  2 and reports the step whose output first matches the swapped
  reference. Each rank's output must be within ``REL_TOL`` of the
  single-process engine, and the swap must land at the same step in
  every rank.
- ``--stream``: ``totton-stream-torch --distributed --shard-time nproc``
  in each rank on ``--seconds`` of audio fed through its stdin (each rank
  its time span of every dispatch granule). Rank 0 serves the control
  endpoint and publishes, the others follow; one RELOAD (an EQ switched
  on in config.json) must be scheduled at the same step in every rank,
  and every granule of every rank's output must match the old, the
  crossfaded or the new reference.
- ``--cli``: one process, ``totton-stream-torch`` on a ``--seconds`` s16
  stereo WAV over every mesh of 1 or 2 channel rows and a power-of-two
  number of time columns that the devices cover (every card there is;
  four CPU cells with ``--device cpu``), each held against the plain CLI's
  file: byte-identical, or within 1 LSB.

``--filter`` takes a filter JSON; without it a small windowed-sinc filter
(4x, 1025 taps) is made on the spot. Every child runs under ``--timeout``
seconds, so a hung rank fails the run instead of hanging it. Prints PASS
and exits 0 when every check holds.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

RATE = 44100
REL_TOL = 1e-5
SEED = 7
SWAP_STEP = 2
STEPS = 4
SWAP_FADE = 512


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _small_filter():
    """4x, 1025-tap Kaiser-windowed sinc (fft 4096): block_in 768, halo_in
    256, so a test-sized mesh covers its halo with one block."""
    from totton_tpu_torch.filters.sidecar import FilterSidecar, LoadedFilter

    ratio, taps_n, fft = 4, 1025, 4096
    n = np.arange(taps_n) - (taps_n - 1) / 2
    taps = (np.sinc(n / ratio) * np.kaiser(taps_n, 12.0)).astype(np.float32)
    taps *= ratio * 0.99 / taps.sum()
    return LoadedFilter(taps=taps, sidecar=FilterSidecar(
        coefficients_bin="<dryrun>", taps=taps_n, fft_size=fft,
        block_size=fft - (taps_n - 1), upsample_factor=ratio))


def _load(path):
    from totton_tpu_torch.filters.sidecar import load_filter

    return load_filter(path) if path else _small_filter()


def _rel(y: np.ndarray, ref: np.ndarray) -> float:
    if y.shape != ref.shape:
        raise AssertionError(f"shape {y.shape} != {ref.shape}")
    return float(np.abs(y - ref).max() / max(np.abs(ref).max(), 1e-30))


def worker(rank: int, args) -> int:
    """One rank of engine mode: prints "rank N: ok ..." when every check
    holds; raises otherwise."""
    import torch

    from totton_tpu_torch.engine.upsampler import StreamingUpsampler
    from totton_tpu_torch.ops import fused_frames
    from totton_tpu_torch.parallel import (
        ShardedUpsampler,
        initialize_distributed,
        make_mesh,
    )

    from totton_tpu_torch.parallel.mesh import local_devices

    initialize_distributed(f"127.0.0.1:{args.port}", args.nproc, rank,
                           backend=args.backend)
    card = (local_devices(args.nproc) if args.device == "cuda"
            else [torch.device(args.device)])
    # Two CPU cells a rank, so a rank also holds a halo inside itself; a
    # rank's one card on CUDA.
    per_rank = 2 if args.device == "cpu" else 1
    devices = card * per_rank
    lf = _load(args.filter)
    k = args.nproc * per_rank
    rng = np.random.default_rng(SEED)
    lines = []

    # Time-sharded: each rank feeds only its own span of every step.
    mesh = make_mesh(n_channel=1, n_time=k, devices=devices)
    ups = ShardedUpsampler(lf, mesh, channels=2)
    cols = ups._local_time_cols
    if len(cols) != per_rank:
        raise AssertionError(f"rank {rank} owns time columns {cols}")
    per_step = ups.block_input_frames
    span = per_step // k * len(cols)
    lo = per_step // k * cols[0]
    x = (rng.normal(size=(2, STEPS * per_step)) * 0.3).astype(np.float32)
    eq = np.linspace(1.0, 0.5, ups.config.n_bins)
    at = ups.schedule_swap(eq_response=eq, apply_at_step=SWAP_STEP)
    ref = StreamingUpsampler(lf, 2, device=card[0])
    old = StreamingUpsampler(lf, 2, device=card[0])
    landed, rels, times, launches, ys = None, [], [], 0, []
    for s in range(STEPS):
        xs = x[:, s * per_step:(s + 1) * per_step]
        if s == SWAP_STEP:
            ref.set_eq(eq)
        before = fused_frames.LAUNCHES
        t0 = time.perf_counter()
        y = ups.process_block(xs[:, lo:lo + span])
        times.append((time.perf_counter() - t0) * 1e3)
        launches += fused_frames.LAUNCHES - before
        ys.append(y)
        want = ref.process_block(xs)[:, lo * lf.ratio:(lo + span) * lf.ratio]
        rels.append(_rel(y, want))
        pure_old = old.process_block(xs)[:, lo * lf.ratio:
                                         (lo + span) * lf.ratio]
        if landed is None and _rel(y, pure_old) > REL_TOL:
            landed = s
    if max(rels) >= REL_TOL or ups.swap_deadline_misses:
        raise AssertionError(f"rank {rank} time mesh: rel {rels}, misses "
                             f"{ups.swap_deadline_misses}")
    lines.append(f"time mesh 1x{k} cols {cols}: rel "
                 f"{max(rels):.3e} over {STEPS} steps, step host ms "
                 f"{', '.join(f'{t:.2f}' for t in times)}; swap scheduled "
                 f"at step {at}, landed at step {landed}, step_index "
                 f"{ups.step_index}")

    # Channel-only: each rank feeds its own channel rows.
    mesh = make_mesh(n_channel=k, n_time=1, devices=devices)
    ups = ShardedUpsampler(lf, mesh, channels=k)
    rows = ups._local_channel_rows
    per_step = ups.block_input_frames
    x_c = (rng.normal(size=(k, 2 * per_step)) * 0.3).astype(np.float32)
    ref = StreamingUpsampler(lf, k, device=card[0])
    rels, ys_c = [], []
    for s in range(2):
        xs = x_c[:, s * per_step:(s + 1) * per_step]
        before = fused_frames.LAUNCHES
        y = ups.process_block(xs[rows[0]:rows[-1] + 1])
        launches += fused_frames.LAUNCHES - before
        ys_c.append(y)
        rels.append(_rel(y, ref.process_block(xs)[rows[0]:rows[-1] + 1]))
    if max(rels) >= REL_TOL:
        raise AssertionError(f"rank {rank} channel mesh: rel {rels}")
    lines.append(f"channel mesh {k}x1 rows {rows}: rel {max(rels):.3e}")
    if args.save_dir:
        # Both meshes' global inputs and this rank's outputs, for a check
        # by another implementation on the same input.
        np.savez(os.path.join(args.save_dir, f"rank{rank}.npz"),
                 taps=lf.taps, fft_size=lf.sidecar.fft_size, ratio=lf.ratio,
                 eq=eq, swap_step=SWAP_STEP, time_x=x,
                 time_y=np.concatenate(ys, axis=1), time_lo=lo,
                 time_span=span, time_cols=k, channel_x=x_c,
                 channel_y=np.concatenate(ys_c, axis=1),
                 channel_rows=np.asarray(rows))

    import torch.distributed as dist

    dist.destroy_process_group()
    print(f"rank {rank}: ok ({'; '.join(lines)}; the sharded engine's "
          f"fused_frames launches {launches})", flush=True)
    return 0


def _run_children(cmds, timeout: float, log_dir: str, stdins=None):
    """Start every command (stdout+stderr to a log file each), feed each
    its stdin from a thread of its own (``stdins``: one callable per
    command, given the pipe), wait for all under one deadline, and return
    [(rc, log text)]."""
    procs, feeders = [], []
    for i, cmd in enumerate(cmds):
        log = open(os.path.join(log_dir, f"child{i}.log"), "w+")
        # Child i is rank i, and on CUDA it takes card LOCAL_RANK.
        env = dict(os.environ, LOCAL_RANK=str(i))
        p = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                             stdin=subprocess.PIPE if stdins else None,
                             env=env)
        procs.append((p, log))
    if stdins:
        for (p, _), feed in zip(procs, stdins):
            t = threading.Thread(target=feed, args=(p.stdin,), daemon=True)
            t.start()
            feeders.append(t)
    # Wait until every child has exited, one has failed (its peers would
    # block on it) or the deadline passed; then kill what is left.
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        codes = [p.poll() for p, _ in procs]
        if None not in codes or any(c not in (None, 0) for c in codes):
            break
        time.sleep(0.2)
    out = []
    for p, log in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        log.seek(0)
        out.append((p.returncode, log.read()))
        log.close()
    for t in feeders:  # their pipes closed with the children
        t.join(timeout=10)
    return out


def orchestrate(args) -> int:
    port = args.port or _free_port()
    cmds = [[sys.executable, "-m", "totton_tpu_torch.parallel.dryrun",
             "--worker", str(r), "--port", str(port), "--nproc",
             str(args.nproc), "--device", args.device,
             "--backend", args.backend]
            + (["--filter", args.filter] if args.filter else [])
            + (["--save-dir", args.save_dir] if args.save_dir else [])
            for r in range(args.nproc)]
    with tempfile.TemporaryDirectory(prefix="totton_dryrun_") as tmp:
        results = _run_children(cmds, args.timeout, tmp)
    rc = 0
    landed = set()
    for r, (code, log) in enumerate(results):
        ok = code == 0 and f"rank {r}: ok" in log
        m = re.search(r"landed at step (\d+)", log)
        if m:
            landed.add(int(m.group(1)))
        print(f"--- rank {r} rc={code} ok={ok}")
        print(log[-3000:] if not ok else
              next(line for line in log.splitlines()
                   if line.startswith(f"rank {r}: ok")))
        rc |= not ok
    if len(landed) != 1 or landed != {SWAP_STEP}:
        print(f"the scheduled swap landed at steps {sorted(landed)}, "
              f"not {SWAP_STEP} in every rank")
        rc = 1
    print("dryrun:", "PASS" if rc == 0 else "FAIL", flush=True)
    return rc


def orchestrate_stream(args) -> int:
    """--stream mode (module docstring)."""
    with tempfile.TemporaryDirectory(prefix="totton_dryrun_") as tmp:
        return _stream(args, tmp)


def _stream(args, tmp: str) -> int:
    from totton_tpu_torch.control.client import DaemonClient
    from totton_tpu_torch.engine.upsampler import upsample_signal
    from totton_tpu_torch.eq.apo import parse_eq_file
    from totton_tpu_torch.eq.biquad import profile_response_for_fft
    from totton_tpu_torch.filters.sidecar import save_filter
    from totton_tpu_torch.io.pcm import (
        PcmFormat,
        deinterleave,
        float_to_pcm,
        interleave,
        pcm_to_float,
    )
    from totton_tpu_torch.io.wav import read_wav
    from totton_tpu_torch.ops.overlap_save import OverlapSaveConfig

    n = args.nproc
    lf = _load(args.filter)
    filter_json = args.filter or save_filter(
        lf.taps, tmp, "dryrun_4x", lf.ratio, fft_size=lf.sidecar.fft_size)
    eq_path = os.path.join(tmp, "quiet.txt")
    with open(eq_path, "w") as f:
        f.write("Preamp: -12 dB\n")
    config = os.path.join(tmp, "config.json")
    with open(config, "w") as f:
        json.dump({"eqEnabled": False}, f)
    # The dispatch granule of a 1 x n time mesh (ShardedUpsampler's rule).
    cfg = OverlapSaveConfig.from_sidecar(lf.sidecar)
    mult = 1
    while mult * cfg.block_in < cfg.halo_in:
        mult *= 2
    granule = cfg.block_in * n * mult
    local = granule // n
    # The leader schedules the swap SWAP_MARGIN_STEPS steps ahead, so the
    # stream runs past that with a few granules to spare.
    from totton_tpu_torch.parallel.sharded import SWAP_MARGIN_STEPS

    n_gran = -(-int(args.seconds * RATE) // granule)
    reload_at = max(2, n_gran // 3)
    n_gran = max(n_gran, reload_at + SWAP_MARGIN_STEPS + 4)
    rng = np.random.default_rng(11)
    # Well inside full scale, so the s32 output never clips.
    x = np.clip(rng.normal(size=(2, n_gran * granule)) * 0.1,
                -0.5, 0.5).astype(np.float32)
    s32 = PcmFormat.S32_LE
    x = deinterleave(pcm_to_float(float_to_pcm(interleave(x), s32), s32), 2)

    coord, pub = _free_port(), _free_port()
    endpoint = f"ipc://{tmp}/ctl.sock"
    cmds = []
    for r in range(n):
        cmd = [sys.executable, "-m", "totton_tpu_torch.cli.stream",
               "--in", "-", "--out", os.path.join(tmp, f"out{r}.wav"),
               "--rate", str(RATE), "--channels", "2", "--format", "s32",
               "--filter", filter_json, "--ratio", str(lf.ratio),
               "--config", config, "--distributed",
               "--coordinator", f"127.0.0.1:{coord}",
               "--num-processes", str(n), "--process-id", str(r),
               "--backend", args.backend, "--shard-time", str(n),
               "--swap-fade", str(SWAP_FADE), "--batch-blocks", "1",
               "--device", args.device,
               "--control-pub-endpoint", f"tcp://127.0.0.1:{pub}"]
        if r == 0:
            cmd += ["--control-endpoint", endpoint]
        cmds.append(cmd)
    reloaded = threading.Event()

    def feeder(r):
        def feed(pipe):
            try:
                for g in range(n_gran):
                    if g == reload_at:
                        reloaded.wait(timeout=args.timeout)
                    a = g * granule + r * local
                    pipe.write(float_to_pcm(interleave(x[:, a:a + local]),
                                            s32))
                    pipe.flush()
            except OSError:
                pass  # the child died; its exit code tells
            finally:
                pipe.close()
        return feed

    errors = []

    def control():
        try:
            client = DaemonClient(endpoint=endpoint, timeout_ms=30000)
            deadline = time.monotonic() + args.timeout
            while not client.ping():
                if time.monotonic() > deadline:
                    raise RuntimeError("the leader never answered PING")
                time.sleep(0.3)
            time.sleep(2.0)  # the first granules dispatch meanwhile
            with open(config, "w") as f:
                json.dump({"eqEnabled": True, "eqProfile": "quiet",
                           "eqProfilePath": eq_path}, f)
            r = client.reload_config()
            if not r.ok:
                raise RuntimeError(f"RELOAD reply {r.raw}")
            time.sleep(2.0)  # the published event reaches the followers
        except Exception as e:  # reported below
            errors.append(e)
        finally:
            reloaded.set()

    ctl = threading.Thread(target=control, daemon=True)
    ctl.start()
    results = _run_children(cmds, args.timeout, tmp,
                            stdins=[feeder(r) for r in range(n)])
    ctl.join(timeout=10)
    rc = 1 if errors else 0
    if errors:
        print(f"control failed: {errors[0]}")
    steps = []
    for r, (code, log) in enumerate(results):
        m = re.search(r"Live reload scheduled at step (\d+)", log)
        ok = code == 0 and m is not None and (
            r == 0 or "Control follower" in log)
        launched = re.search(r"fused_frames_launches=(\d+)", log)
        print(f"--- rank {r} rc={code} ok={ok} fused_frames launches "
              f"{launched.group(1) if launched else 'not reported'}")
        if not ok:
            print(log[-4000:])
            rc = 1
        else:
            steps.append(int(m.group(1)))
    if rc:
        print("dryrun --stream: FAIL", flush=True)
        return 1
    if len(set(steps)) != 1:
        print(f"the ranks scheduled the swap at steps {steps}")
        print("dryrun --stream: FAIL", flush=True)
        return 1

    eq = profile_response_for_fft(parse_eq_file(eq_path), cfg.fft_size,
                                  RATE * cfg.ratio)
    ref_old = upsample_signal(x, lf, device=args.device).astype(np.float64)
    ref_new = upsample_signal(x, lf, eq_response=eq,
                              device=args.device).astype(np.float64)
    out_local = local * cfg.ratio
    first_new = []
    for r in range(n):
        y, rate = read_wav(os.path.join(tmp, f"out{r}.wav"))
        if rate != RATE * cfg.ratio or y.shape != (2, n_gran * out_local):
            print(f"rank {r}: output {y.shape} at {rate} Hz")
            return 1
        states = []
        for g in range(n_gran):
            a = (g * granule + r * local) * cfg.ratio
            got = y[:, g * out_local:(g + 1) * out_local]
            old = ref_old[:, a:a + out_local]
            new = ref_new[:, a:a + out_local]
            ramp = np.arange(SWAP_FADE) / SWAP_FADE
            fade = new.copy()
            fade[:, :SWAP_FADE] = (old[:, :SWAP_FADE] * (1.0 - ramp)
                                   + new[:, :SWAP_FADE] * ramp)
            snr = {k: 10 * np.log10(np.sum(ref ** 2)
                                    / max(np.sum((got - ref) ** 2), 1e-300))
                   for k, ref in (("old", old), ("new", new), ("fade", fade))}
            best = max(snr, key=snr.get)
            if snr[best] < 60:
                print(f"rank {r} granule {g} matches no reference: {snr}")
                return 1
            states.append(best)
        if states[0] != "old" or set(states) == {"old"}:
            print(f"rank {r}: the swap never landed or landed at once: "
                  f"{states}")
            return 1
        k = next(i for i, s in enumerate(states) if s != "old")
        expect = (["old"] * k + states[k:k + 1]
                  + ["new"] * (n_gran - k - 1))
        if states != expect or (r == 0 and states[k] != "fade"):
            print(f"rank {r}: not old -> (fade) -> new: {states}")
            return 1
        first_new.append(k)
        print(f"rank {r}: granules {states.count('old')} old, "
              f"{states.count('fade')} crossfaded, {states.count('new')} new "
              f"(each > 60 dB SNR vs its reference)")
    if len(set(first_new)) != 1:
        print(f"the swap landed at granules {first_new}")
        print("dryrun --stream: FAIL", flush=True)
        return 1
    print(f"dryrun --stream: PASS ({n} ranks, {n_gran} granules of {granule} "
          f"frames, RELOAD scheduled at step {steps[0]} in every rank, "
          f"landed at granule {first_new[0]} in every rank)", flush=True)
    return 0


def orchestrate_cli(args) -> int:
    """--cli mode (module docstring)."""
    with tempfile.TemporaryDirectory(prefix="totton_dryrun_") as tmp:
        return _cli(args, tmp)


def _cli(args, tmp: str) -> int:
    import torch

    from totton_tpu_torch.filters.sidecar import save_filter
    from totton_tpu_torch.io.wav import read_wav, write_wav
    from totton_tpu_torch.testing.signals import sine

    lf = _load(args.filter)
    filter_json = args.filter or save_filter(
        lf.taps, tmp, "dryrun_4x", lf.ratio, fft_size=lf.sidecar.fft_size)
    in_path = os.path.join(tmp, "in.wav")
    write_wav(in_path, sine(1000.0, args.seconds, RATE, amplitude=0.5,
                            channels=2), RATE)
    n_dev = torch.cuda.device_count() if args.device == "cuda" else 4
    meshes = [(c, t) for c in (1, 2) for t in (1, 2, 4, 8, 16)
              if c * t <= n_dev]
    outs, rc = {}, 0
    for mesh in [None] + meshes:
        name = "plain" if mesh is None else f"{mesh[0]}x{mesh[1]}"
        out_path = os.path.join(tmp, f"out_{name}.wav")
        cmd = [sys.executable, "-m", "totton_tpu_torch.cli.stream",
               "--in", in_path, "--out", out_path, "--filter", filter_json,
               "--ratio", str(lf.ratio), "--format", "s16",
               "--device", args.device]
        if mesh is not None:
            cmd += ["--shard-channel", str(mesh[0]),
                    "--shard-time", str(mesh[1])]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=args.timeout)
        if proc.returncode != 0 or (
                mesh is not None and "Sharded engine: mesh" not in proc.stderr):
            print(f"--- {name}: rc={proc.returncode}\n{proc.stderr[-3000:]}")
            rc = 1
            continue
        with open(out_path, "rb") as f:
            outs[name] = f.read()
        if mesh is None:
            continue
        same = outs[name] == outs["plain"]
        lsb = 0.0 if same else float(np.abs(
            np.round(read_wav(out_path)[0] * 32768)
            - np.round(read_wav(os.path.join(tmp, "out_plain.wav"))[0]
                       * 32768)).max())
        print(f"mesh {name}: " + ("byte-identical to the plain CLI" if same
                                  else f"max {lsb:.0f} LSB vs the plain CLI"))
        rc |= lsb > 1.0
    print(f"dryrun --cli: {'PASS' if rc == 0 else 'FAIL'} ({args.seconds:g} "
          f"s stereo s16, {lf.ratio}x/{lf.sidecar.taps} taps on "
          f"{args.device}, meshes "
          f"{', '.join(f'{c}x{t}' for c, t in meshes)})", flush=True)
    return rc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m totton_tpu_torch.parallel.dryrun",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--nproc", type=int, default=2)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device every rank runs on (default cuda; cpu runs "
                        "the plain torch path)")
    p.add_argument("--backend", default="gloo", choices=["gloo", "nccl"],
                   help="torch.distributed backend of the ranks")
    p.add_argument("--filter", help="filter JSON (default: a small 4x one)")
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--stream", action="store_true",
                      help="run the CLI in every rank (module docstring)")
    mode.add_argument("--cli", action="store_true",
                      help="the CLI over every mesh the devices cover, "
                           "against the plain CLI (module docstring)")
    p.add_argument("--seconds", type=float, default=5.0,
                   help="--stream, --cli: seconds of audio")
    p.add_argument("--timeout", type=float, default=300.0,
                   help="seconds each child may run")
    p.add_argument("--save-dir",
                   help="engine mode: each rank writes its inputs and "
                        "outputs to rank<N>.npz here")
    # The worker protocol: the orchestrator hands these to its ranks.
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    from totton_tpu_torch import resolve_device

    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: --device: {e}", file=sys.stderr)
        return 2
    if args.worker is not None:
        return worker(args.worker, args)
    if args.stream:
        return orchestrate_stream(args)
    if args.cli:
        return orchestrate_cli(args)
    return orchestrate(args)


if __name__ == "__main__":
    raise SystemExit(main())
