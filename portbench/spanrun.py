"""A cell's run with the serve plane's spans read in detail.

    python3 -m portbench.spanrun --workload <cell> --seed <n> \\
        --seconds <s> [--trace 0|1] [--spans after|all] \\
        [--traffic <mix>] [--chrome <path>]

from the root of a checkout on a machine with an NVIDIA card. The run is
``run.run_cell``'s, the harness unchanged; this module takes the server
and the run's ``ctx`` from it (``fault`` and ``out``).

- ``--spans after`` (the default): the spans as ``run.py`` itself
  switches them, on over the profiler windows that follow the measured
  window of a ``--trace 1`` run; read over the window
  ``trace.pick_window`` chose, device trace and all (``window``).
- ``--spans all``: on from before the server's first step; the span
  metrics also read the measured window (``measured``, host spans only).
  Against ``run.py``'s own run of the same cell (spans off over the
  measured window) it gives the cost of recording spans.

``--traffic`` runs another mix of ``traffic/`` in the cell's place (the
bulk mix). Prints one JSON line: the run's result line under ``result``
(its ``info`` under ``info``) and the span readings under ``spans``: each
span metric, each span's time a step and self time a step (ms), the
device's idle time by the dispatcher's span (ms), ``dropped`` and the
quantize's reading method, for each window read. Exit codes as
``run.py``'s.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402

from portbench import run, spans  # noqa: E402

#: the span metrics (``metrics/<name>.py``), each read from ``ctx["spans"]``
#: and ``ctx["trace"]``
METRICS = ("serve.gather_ms", "serve.enqueue_ms", "serve.drain_host_ms",
           "serve.input_wait_share", "serve.dispatcher_offcpu_share",
           "serve.server_block_p95_ms", "serve.reader_ms_per_block",
           "serve.writer_ms_per_block", "device.idle_on_host_share",
           "device.quantize_us_per_step")
#: records the ring holds when the spans are on for a whole run
ALL_RUN_CAPACITY = 1 << 20


def readings(cell: dict, snap: dict, window: dict) -> dict:
    """Every span metric, each span's time and self time a step, and the
    device's idle time by span, over ``window`` (``ctx["trace"]``'s
    form)."""
    ctx = dict(config=cell["config"], spans=snap, trace=window)
    metrics = {}
    for name in METRICS:
        value = run.load_reader(cell["pkg"], name)(ctx)
        if value is not None:
            metrics[name] = value
    w = spans.window_of(ctx)
    out = dict(metrics=metrics, steps=w.steps, blocks=w.blocks,
               window_s=(w.hi - w.lo) / 1e9, per_step_ms=w.per_step_ms())
    if w.steps:
        names = sorted(set(w.name.tolist()))
        out["cpu_per_step_ms"] = {n: w.cpu_total(n) / w.steps / 1e6
                                  for n in names}
        out["self_per_step_ms"] = {k: v / w.steps / 1e6
                                   for k, v in sorted(w.self_time().items())}
    idle = w.idle_by_span()
    if idle is not None:
        out["idle_by_span_ms"] = {k: v / 1e6 for k, v in sorted(
            idle.items(), key=lambda kv: -kv[1])}
        out["offset_from"] = window.get("offset_from")
        out["marker_delay_ns"] = window.get("marker_delay_ns")
        out["launch_records"] = window.get("launch_records")
        for method in ("correlation", "stream order"):
            q = w.quantize_ns_per_step(method)
            if q is not None:
                out[f"quantize_{method.replace(' ', '_')}"] = dict(
                    us_per_step=q[0] / 1e3, kernels=q[2])
        q = w.quantize_ns_per_step()
        out["quantize_method"] = None if q is None else q[1]
    return out


def run_with_spans(cell: dict, seed: int, seconds: float, trace: bool,
                   mode: str, device: str = "cuda",
                   chrome: str | None = None, t0: float = T_START) -> dict:
    """One run of ``cell`` with the spans switched as ``mode`` says;
    returns the printed object."""
    if mode not in ("after", "all"):
        raise ValueError(f"spans mode {mode!r}")
    seen: dict = dict(server=None)

    def capture(server):
        seen["server"] = server
        if mode == "all":
            from totton_tpu_torch.utils.profiling import Spans

            server.spans = Spans(ALL_RUN_CAPACITY)
            server.spans.start()

    ctx: dict = {}
    result = run.run_cell(cell, seed, seconds, trace, device=device,
                          fault=capture, t0=t0, out=ctx)
    server = seen["server"]
    server.spans.stop()
    snap = server.spans.snapshot()
    out = dict(result=result, info=result.pop("info"),
               spans=dict(mode=mode, dropped=snap["dropped"],
                          records=int(snap["num"].size)))
    if mode == "all":
        s0, s1 = ctx["measured"]
        out["spans"]["measured"] = readings(cell, snap, dict(
            bounds_ns=(s0["t_ns"], s1["t_ns"]), before=s0, after=s1))
    if ctx["trace"] is not None:
        out["spans"]["window"] = readings(cell, snap, ctx["trace"])
    if chrome:
        server.spans.write_chrome(chrome)
    return out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="portbench.spanrun", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=[0, 1], default=1)
    p.add_argument("--spans", choices=["after", "all"], default="after")
    p.add_argument("--traffic", help="a mix of traffic/ in the cell's place")
    p.add_argument("--chrome", help="write the spans as a Chrome trace here")
    args = p.parse_args(argv)
    os.environ["TOTTON_TORCH_BUILD_DIR"] = str(run.ROOT / "build"
                                               / "totton_tpu_torch")
    cell = run.load_cell(args.workload)
    if args.traffic:
        cell["traffic"] = json.loads(
            (cell["pkg"] / "traffic" / f"{args.traffic}.json").read_text())
    import torch

    if not torch.cuda.is_available():
        run.log("error: no CUDA device")
        return 3
    out = run_with_spans(cell, args.seed, args.seconds, bool(args.trace),
                         args.spans, chrome=args.chrome)
    found = run.banned_modules()
    if found:
        run.log(f"error: loaded in this process: {', '.join(found)}")
        return 4
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
