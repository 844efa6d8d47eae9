"""The server's start, cut into five phases at the program's start marks.

The program marks its start on ``perf_counter_ns`` (``Spans.mark`` of
``totton_tpu_torch.utils.profiling``, ``StreamServer.spans``; in a spans
snapshot under ``marks``): ``serve.setup.import`` from the package's first
line to the end of ``serve.py``'s import, ``serve.setup.init`` over the
constructor and ``serve.setup.start`` over ``start()``. The run's process
start is its window's start (``ctx["measured"][0]["t_ns"]``, the same
clock) less ``setup_s``; the phases meet end to end, so they sum to
``setup_s``:

- ``torch``: process start to the package's first line (the interpreter,
  numpy, torch, the harness's own imports);
- ``import``: the package's import, up to ``serve.py``'s last line;
- ``server_init``: the import's end to the constructor's return (the
  filter's resolve and load, the CUDA context, the fold, the plan, the
  slots);
- ``server_start``: the constructor's return to ``start()``'s return
  (every step shape run once, the kernels' load);
- ``after_start``: ``start()``'s return to the window (a traced run's
  profiler warm-up, the load generators' start, the traffic's warm-up).

A run whose snapshot has no such marks (a program that records none) gives
None.
"""

from __future__ import annotations

PHASES = ("torch", "import", "server_init", "server_start", "after_start")
#: the marks whose bounds cut the phases
IMPORT, INIT, START = ("serve.setup.import", "serve.setup.init",
                       "serve.setup.start")


def phases(ctx: dict) -> dict[str, float] | None:
    """Each phase's seconds, or None without the marks."""
    snap = ctx.get("spans")
    marks = {m["name"]: m for m in (snap or {}).get("marks", ())}
    if any(n not in marks for n in (IMPORT, INIT, START)):
        return None
    window = ctx["measured"][0]["t_ns"]
    cuts = (window - ctx["setup_s"] * 1e9, marks[IMPORT]["t0"],
            marks[IMPORT]["t1"], marks[INIT]["t1"], marks[START]["t1"],
            window)
    return {p: (b - a) / 1e9 for p, a, b in zip(PHASES, cuts, cuts[1:])}


def phase(ctx: dict, name: str) -> float | None:
    """One phase's seconds, or None without the marks."""
    got = phases(ctx)
    return None if got is None else got[name]
