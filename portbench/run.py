"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout on a machine with an NVIDIA card. The cell's
configuration (``configs/<name>.json``) says how ``totton-serve-torch``
would be started; this process builds the same ``StreamServer`` on the
card, the load generators (``loadgen.py``, their own processes) connect
over loopback TCP and run the cell's traffic (``traffic/<name>.json``)
through a warm-up, the measured window and an untimed drain, and the
reference judges what the clients received (``compare.py``). With
``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics; each metric is read by
``metrics/<name>.py``. A traced run switches the serve plane's spans on
(``StreamServer.spans``) over its profiler windows only, after the
measured window, and prints the device's idle time by the dispatcher's
span on its ``run:`` line.

Two more modes serve the benchmark's own calibration and are never run by
a check: ``--control`` also reads the control (the reference in TF32, put
in the program's place on the same segments), and ``--sweep N1,N2,...``
runs the cell's traffic at each stream count against one server and prints
one line each (the knee of a live cell).

Exit codes: 0 a result was printed (``correct`` may be false), 1 the run
failed, 3 no CUDA card (or too few), 4 the JAX package or JAX was loaded.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pickle  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
BANNED = ("jax", "jaxlib", "flax", "totton_tpu")
#: a traced run's profiler windows: each this long, in this much more
#: traffic after the measured window
TRACE_WINDOW_S = 2.5
TRACE_AFTER_S = 12.0
#: the devices whose runs the profiler traces
PROFILED = ("cuda",)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# -- the cell, from BENCHMARK.json and the files it names -----------------


def load_cell(name: str, root: Path = ROOT, pkg: Path = PKG) -> dict:
    """The cell ``name``: its workload entry, configuration, traffic and
    metric entries, each read from the file its name points to."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    work = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[work["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((pkg / "traffic" / f"{work['traffic']}.json")
                         .read_text())
    return dict(workload=work, config=config, traffic=traffic,
                end_to_end=bench["end_to_end"], per_layer=bench["per_layer"],
                root=root, pkg=pkg)


def metrics_of(cell: dict, trace: bool) -> list[dict]:
    """The metric entries this cell reports in this kind of run."""
    name = cell["workload"]["name"]
    entries = cell["per_layer"] if trace else cell["end_to_end"]
    return [m for m in entries if name in m.get("workloads", [name])]


def load_reader(pkg: Path, name: str):
    path = pkg / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{len(sys.modules)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def clients_of(traffic: dict, config_name: str) -> int:
    n = traffic["clients"]
    return int(n[config_name] if isinstance(n, dict) else n)


def offered_samples_per_s(config: dict, clients: int) -> int:
    """The output samples a second that ``clients`` paced streams ask
    for: each sends the configuration's rate, answered by ratio frames of
    every channel."""
    flags = config["serve_flags"]
    return clients * flags["channels"] * flags["rate"] * config["ratio"]


# -- the server under test ------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def build_server(config: dict, root: Path, device: str, port: int):
    """``StreamServer`` as ``cli/serve.py`` builds it from the flags in
    the configuration (filter resolved by ``resolve_filter_path``, loaded
    by ``load_filter``), listening on a loopback port. Returns (server,
    filter json path)."""
    from totton_tpu_torch import serve
    from totton_tpu_torch.control.wiring import resolve_startup_phase
    from totton_tpu_torch.engine.selector import resolve_filter_path
    from totton_tpu_torch.filters.sidecar import load_filter

    flags = config["serve_flags"]
    phase = resolve_startup_phase(flags.get("phase"), None)
    path = resolve_filter_path(
        filter_path=None, filter_dir=str(root / flags["filter_dir"]),
        phase=phase, ratio=flags["ratio"], input_rate=flags["rate"],
        latency=flags["latency"])
    loaded = load_filter(path)
    sc = loaded.sidecar
    if (os.path.basename(path) != config["filter"] + ".json"
            or (sc.taps, sc.fft_size, sc.block_size, sc.upsample_factor)
            != (config["taps"], config["fft_size"], config["block_size"],
                config["ratio"])):
        raise ValueError(f"the flags resolve to {path}, not the "
                         f"configuration's {config['filter']}")
    server = serve.StreamServer(
        loaded, f"tcp-listen://127.0.0.1:{port}", flags["rate"],
        max_streams=flags["max_streams"], channels=flags["channels"],
        eq_response=None, stats_path=None,
        max_blocks_per_step=flags["max_blocks_per_step"],
        max_input_backlog_blocks=flags["max_input_backlog"],
        swap_fade_frames=flags["swap_fade"],
        device_pcm=flags["device_pcm"], device=device)
    return server, path


def log_slots(server) -> None:
    """Each attached slot's state, where a stream did not finish."""
    from portbench import loadgen

    for slot in server.slots:
        if slot.sock is None and slot.detached:
            continue
        with slot.buf_lock:
            buf = slot.buf.shape[1]
        sock = slot.sock
        queues = loadgen.socket_queues(sock) if sock is not None else "closed"
        log(f"slot {slot.index}: socket {queues}; input {buf} frames, "
            f"eof {slot.eof}, "
            f"flushed {slot.flushed}, finished {slot.finished}, closing "
            f"{slot.closing.is_set()}, pending steps {slot.pending_steps}, "
            f"out blocks {slot.out_blocks}, out items {slot.out.qsize()}, "
            f"ready {slot.ready()}, detached {slot.detached}, "
            f"stats {slot.stats.to_json()}")
        frames = sys._current_frames()
        for role, t in (("reader", slot.reader), ("writer", slot.writer)):
            f = frames.get(t.ident) if t is not None else None
            where = ("not running" if f is None else " < ".join(
                f"{os.path.basename(x.f_code.co_filename)}:{x.f_lineno}"
                for x in _stack(f)))
            log(f"slot {slot.index} {role}: {where}")


def _stack(frame, depth: int = 6) -> list:
    out = []
    while frame is not None and len(out) < depth:
        out.append(frame)
        frame = frame.f_back
    return out


def snapshot(server) -> dict:
    """The server's counters now, the server-wide block latency histogram
    where the server keeps one, the time (``perf_counter_ns``) and the
    offset of the profiler's wall clock to it, read back to back."""
    st = server.stats
    with st.lock:
        snap = dict(steps=st.steps, steps_by_shape=dict(st.steps_by_shape),
                    drain_wall_s=st.drain_wall_s, frames_out=st.frames_out)
        if hasattr(st, "block_latency"):
            snap["block_latency"] = list(st.block_latency)
    snap["t_ns"] = time.perf_counter_ns()
    snap["clock_offset_ns"] = time.time_ns() - time.perf_counter_ns()
    return snap


def delta(a: dict, b: dict) -> dict:
    shapes = {k: v - a["steps_by_shape"].get(k, 0)
              for k, v in b["steps_by_shape"].items()}
    return dict(steps=b["steps"] - a["steps"],
                steps_by_shape={k: v for k, v in shapes.items() if v},
                drain_wall_s=b["drain_wall_s"] - a["drain_wall_s"],
                frames_out=b["frames_out"] - a["frames_out"])


# -- the load --------------------------------------------------------------


def pin_server(traffic: dict) -> list[int]:
    """Split this process's cores: the last ``loadgen_cores`` go to the
    load generators (returned), and this thread, with every thread it
    starts from now on (the server's), keeps the others, so that the
    clients stand apart from the host under test as remote clients would
    and the scheduler cannot trade one for the other."""
    cores = sorted(os.sched_getaffinity(0))
    n = int(traffic.get("loadgen_cores", 0))
    if not 0 < n < len(cores):
        return []
    os.sched_setaffinity(0, cores[:-n])
    return cores[-n:]


def drive(server, cell: dict, port: int, seed: int, seconds: float,
          clients: int, cores: list[int], after=None,
          after_s: float = 0.0) -> dict:
    """Run the cell's traffic with ``clients`` streams: connect, warm up,
    the window of ``seconds``, ``after_s`` more seconds of the same
    traffic in which ``after(we, end)`` runs on this thread (a traced
    run's profiler), then every stream ends its input and reads its reply
    to the end. Returns the streams' results, the window's bounds and the
    server's counters (and their snapshots at either end, ``measured``)
    and CPU time over the window."""
    from portbench import audio

    traffic, config = cell["traffic"], cell["config"]
    flags = config["serve_flags"]
    n_proc = max(1, min(int(traffic["processes"]), clients))
    plan = dict(host="127.0.0.1", port=port, wire=config["wire"],
                cores=cores,
                traffic=traffic, capture=traffic["capture"],
                drain_s=traffic["drain_s"],
                geometry=dict(channels=flags["channels"],
                              rate=flags["rate"], ratio=config["ratio"],
                              block_in=config["block_size"]
                              // config["ratio"],
                              block_size=config["block_size"]))
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(cell["pkg"].parent),
                    os.environ.get("PYTHONPATH", "")]))
    procs = []
    try:
        for g in range(n_proc):
            idx = list(range(g, clients, n_proc))
            p = subprocess.Popen(
                [sys.executable, "-m", "portbench.loadgen"],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                cwd=str(cell["pkg"].parent), env=env)
            procs.append(p)
            mine = dict(plan, name=f"{g}", indices=idx,
                        seeds=[audio.stream_seed(seed, i) for i in idx])
            p.stdin.write((json.dumps(mine) + "\n").encode())
            p.stdin.flush()
        for p in procs:
            line = p.stdout.readline()
            if line.strip() != b"READY":
                raise RuntimeError(f"load generator failed to start: {line!r}")
        start = time.monotonic() + 0.05
        ws = start + float(traffic["warmup_s"])
        we = ws + seconds
        end = we + after_s
        for p in procs:
            p.stdin.write((json.dumps(dict(start=start, ws=ws, we=we,
                                           end=end)) + "\n").encode())
            p.stdin.flush()
        time.sleep(max(0.0, ws - time.monotonic()))
        t_ws = time.monotonic()
        s0, cpu0 = snapshot(server), os.times()
        time.sleep(max(0.0, we - time.monotonic()))
        s1, cpu1 = snapshot(server), os.times()
        t_we = time.monotonic()
        extra = after(we, end) if after is not None else None
        streams = []
        for p in procs:
            raw = p.stdout.read()
            if p.wait() != 0 or not raw:
                raise RuntimeError(f"load generator exited {p.returncode}")
            streams.extend(pickle.loads(raw))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return dict(streams=streams, ws=ws, we=we, late_start_s=t_ws - ws,
                late_end_s=t_we - we, window=delta(s0, s1),
                measured=(s0, s1),
                cpu_s=(cpu1.user + cpu1.system) - (cpu0.user + cpu0.system),
                extra=extra)


# -- one run ---------------------------------------------------------------


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", control: bool = False, fault=None,
             t0: float = T_START, out: dict | None = None) -> dict:
    """One run of ``cell``; returns the result line's object. ``t0`` is
    when the run's process started; ``fault`` (tests, ``spanrun``) is
    called with the server before it starts; ``out``, where given, is
    filled with the run's ``ctx``, what the metric readers read."""
    traffic = cell["traffic"]
    clients = clients_of(traffic, cell["workload"]["config"])
    all_cores = os.sched_getaffinity(0)
    cores = pin_server(traffic)
    try:
        return _run_cell(cell, seed, seconds, trace, device, control, fault,
                         t0, clients, cores, out)
    finally:
        os.sched_setaffinity(0, all_cores)


def _run_cell(cell, seed, seconds, trace, device, control, fault, t0,
              clients, cores, out) -> dict:
    import torch

    from portbench import compare, reference, spans, trace as tr

    config, traffic = cell["config"], cell["traffic"]
    flags = config["serve_flags"]
    port = free_port()
    server, path = build_server(config, cell["root"], device, port)
    if fault is not None:
        fault(server)
    server.start()
    traced = trace and device in PROFILED
    sp = getattr(server, "spans", None)
    if traced:
        tr.warm_profiler()
    if device == "cuda":
        torch.cuda.synchronize()

    def after(we, end):
        # The profiler and the spans run after the window, under the same
        # traffic, so that the window's counters are read untraced; the
        # first of its windows that kept every record is read. Spans
        # switched on before the server started (``spanrun``) stay on.
        started = sp is not None and not sp.on
        if started:
            sp.start()
        try:
            return tr.take_windows(TRACE_WINDOW_S, 3,
                                   lambda: snapshot(server), end - 0.1)
        finally:
            if started:
                sp.stop()

    try:
        run = drive(server, cell, port, seed, seconds, clients, cores,
                    after if traced else None,
                    TRACE_AFTER_S if traced else 0.0)
        if any(s["error"] is not None for s in run["streams"]):
            log_slots(server)
        span_snap = sp.snapshot() if traced and sp is not None else None
    finally:
        memory_peak = (torch.cuda.max_memory_allocated()
                       if device == "cuda" else 0)
        server.stop()
        del server
        if device == "cuda":
            torch.cuda.empty_cache()
    setup_s = run["ws"] - t0
    if run["extra"] is not None:
        run["extra"] = tr.pick_window(run["extra"], log)
    t_check = time.monotonic()
    taps, meta = reference.read_taps(path)
    paced = traffic["mode"] == "paced"
    ref = reference.Reference(taps, meta["upsample_factor"],
                              flags["channels"], config["wire"], device)
    checks, n_seg = compare.judge(run["streams"], ref, config["check"], paced)
    control_checks = None
    if control:
        tf32 = reference.Reference(taps, meta["upsample_factor"],
                                   flags["channels"], config["wire"], device,
                                   precision="tf32")
        control_checks, _ = compare.judge(run["streams"], ref,
                                          config["check"], paced,
                                          candidate=tf32)
    streams = run["streams"]
    out_samples = sum(s["window_samples"] for s in streams)
    ctx = dict(cell=cell, config=config, traffic=traffic, seconds=seconds,
               setup_s=setup_s, streams=streams, window=run["window"],
               cpu_s=run["cpu_s"], out_samples=out_samples,
               trace=run["extra"], paced=paced, spans=span_snap,
               measured=run["measured"])
    if out is not None:
        out.update(ctx)
    metrics = {}
    for m in metrics_of(cell, trace):
        value = load_reader(cell["pkg"], m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if paced:
        attempted = sum(len(s["block_lat_s"]) for s in streams)
        failed = checks["blocks_lost"]["value"] + sum(
            1 for s in streams if s["error"] is not None)
    else:
        attempted = len(streams)
        failed = checks["lost_streams"]["value"]
    for s in streams:
        if s["error"] is not None:
            log(f"stream {s['index']}: {s['error']}")
    dev = dict(platform="gpu" if device == "cuda" else device,
               kind=(torch.cuda.get_device_name(0) if device == "cuda"
                     else "cpu"),
               count=1, memory_peak_bytes=int(memory_peak))
    result = dict(correct=compare.passed(checks), attempted=attempted,
                  failed=failed, metrics=metrics, device=dev)
    t = run["extra"]
    if trace and t is not None:
        dev.update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = dict(device_ops=t["device_ops"],
                                   idle_gaps=t["idle_gaps"])
    info = dict(out_samples_per_s=out_samples / seconds)
    if paced:
        info["offered_samples_per_s"] = offered_samples_per_s(config,
                                                              clients)
    info.update(segments=n_seg, check_s=time.monotonic() - t_check,
                steps=run["window"]["steps"],
                steps_by_shape=run["window"]["steps_by_shape"],
                late_start_s=run["late_start_s"],
                late_end_s=run["late_end_s"])
    if span_snap is not None:
        info["spans"] = dict(dropped=span_snap["dropped"],
                             records=int(span_snap["num"].size))
        win = spans.window_of(ctx)
        idle = None if win is None else win.idle_by_span()
        if idle is not None:
            info["idle_by_span"] = {k: v / 1e6 for k, v in sorted(
                idle.items(), key=lambda kv: -kv[1])}
    if control_checks is not None:
        info["control"] = control_checks
    result["info"] = info
    result["checks"] = {k: dict(v) for k, v in checks.items()}
    return result


def banned_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def sweep(cell: dict, seed: int, seconds: float, counts: list[int]) -> None:
    """The cell's traffic at each stream count against one server, each
    count with the next seed: one JSON line each (the knee of a live
    cell: the most streams sustained on every seed)."""
    import torch

    cores = pin_server(cell["traffic"])
    port = free_port()
    server, _path = build_server(cell["config"], cell["root"], "cuda", port)
    server.start()
    torch.cuda.synchronize()
    try:
        for i, n in enumerate(counts):
            run = drive(server, cell, port, seed + i, seconds, n, cores)
            streams = run["streams"]
            lat = np.concatenate([s["block_lat_s"] for s in streams]) * 1e3
            due = np.concatenate([s["block_due"] for s in streams])
            half = due < (run["ws"] + run["we"]) / 2
            quarter = (due - run["ws"]) / seconds * 4
            first, last = lat[quarter < 1], lat[quarter >= 3]
            late = np.concatenate([s["late_s"] for s in streams]) * 1e3
            w = run["window"]
            flags = cell["config"]["serve_flags"]
            offered = offered_samples_per_s(cell["config"], n)
            delivered = sum(s["window_samples"] for s in streams) / seconds
            # Sustained: the offered load delivered, the median block
            # within one block period, and no growing backlog (the blocks
            # due in the window's last quarter wait longer, at the median,
            # than those of its first, by a period or more).
            growth = float(np.median(last) - np.median(first))
            period_ms = cell["config"]["block_size"] \
                / cell["config"]["ratio"] / flags["rate"] * 1e3
            print(json.dumps(dict(
                streams=n, seed=seed + i,
                errors=sum(s["error"] is not None for s in streams),
                sustained=bool(delivered >= 0.99 * offered
                               and float(np.median(lat)) < period_ms
                               and growth < period_ms
                               and not np.isinf(lat).any()),
                delivered_share=delivered / offered,
                p50_growth_ms=growth,
                out_samples_per_s=delivered,
                offered_samples_per_s=offered,
                block_p50_ms=float(np.percentile(lat, 50)),
                block_p95_ms=float(np.percentile(lat, 95)),
                block_p95_first_half_ms=float(np.percentile(lat[half], 95)),
                block_p95_second_half_ms=float(np.percentile(lat[~half], 95)),
                block_max_ms=float(lat.max()),
                blocks=int(lat.size), blocks_lost=int(np.isinf(lat).sum()),
                loadgen_late_p95_ms=float(np.percentile(late, 95)),
                steps=w["steps"], steps_by_shape=w["steps_by_shape"])),
                flush=True)
    finally:
        server.stop()


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="portbench.run", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=[0, 1], default=0)
    p.add_argument("--control", action="store_true",
                   help="also read the control (calibration only)")
    p.add_argument("--sweep", help="stream counts, comma-separated "
                                   "(calibration only)")
    args = p.parse_args(argv)
    # The kernels' build cache lives at a fixed path inside the checkout,
    # so that only a checkout's first run builds them.
    os.environ["TOTTON_TORCH_BUILD_DIR"] = str(ROOT / "build"
                                               / "totton_tpu_torch")
    cell = load_cell(args.workload)
    import torch

    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"error: the cell needs {chips} CUDA device(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}")
        return 3
    if args.sweep:
        sweep(cell, args.seed, args.seconds,
              [int(v) for v in args.sweep.split(",")])
        return 0
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      control=args.control)
    found = banned_modules()
    if found:
        log(f"error: loaded in this process: {', '.join(found)}")
        return 4
    info = result.pop("info")
    log("run: " + json.dumps(info))
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
