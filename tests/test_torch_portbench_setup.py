"""The benchmark's five start phases (``portbench/startmarks.py`` and the
``setup.*`` readers) on hand-made runs whose answers are known: they cut
``setup_s`` at the program's import, constructor and start() marks and sum
to it; they read None where the snapshot has no marks (a program that
records none) or no spans; their entries in ``BENCHMARK.json``; and a tiny
run on the CPU in a fresh interpreter, its spans snapshot taken from the
server, reads all five, each >= 0, summing to its ``setup_s``."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from portbench import run, startmarks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MS = 1_000_000
NAMES = [f"setup.{p}_s" for p in startmarks.PHASES]
CELLS = ["serve8k.live", "serve80k.live", "serve4x192k.live"]


def _mark(name, a_ms, b_ms, key=-1, gen=-1):
    return dict(name=name, t0=int(a_ms * MS), t1=int(b_ms * MS), cpu=0,
                key=key, gen=gen, tid=1)


def _ctx(marks, setup_s=12.5, window_ms=13_000.0):
    """A run's ctx: process start at 500 ms, the window at 13 s."""
    snap = dict(names=[], dropped=0, open=0)
    if marks is not None:
        snap["marks"] = marks
    return dict(setup_s=setup_s, spans=snap,
                measured=(dict(t_ns=int(window_ms * MS), steps=0),
                          dict(t_ns=int((window_ms + 30e3) * MS), steps=9)))


MARKS = [
    _mark("serve.setup.import", 4_500, 6_300),
    _mark("serve.setup.init", 6_900, 7_700),
    _mark("serve.setup.fold.upload", 7_000, 7_400),
    _mark("serve.setup.start", 7_700, 9_100),
    _mark("serve.setup.warm", 7_710, 7_800, key=8, gen=1),
]


def _read(name, ctx):
    return run.load_reader(run.PKG, name)(ctx)


def test_the_phases_cut_setup_s_at_the_marks():
    ctx = _ctx(MARKS)
    got = {n: _read(n, ctx) for n in NAMES}
    want = {"setup.torch_s": 4.0, "setup.import_s": 1.8,
            "setup.server_init_s": 1.4, "setup.server_start_s": 1.4,
            "setup.after_start_s": 3.9}
    assert got == pytest.approx(want, abs=1e-9)
    assert startmarks.phases(ctx) == pytest.approx(
        {n[len("setup."):-len("_s")]: v for n, v in want.items()}, abs=1e-9)


@pytest.mark.parametrize("setup_s,window_ms", [(12.5, 13_000.0),
                                               (8.25, 9_200.0),
                                               (30.0, 31_000.0)])
def test_the_phases_sum_to_setup_s(setup_s, window_ms):
    ctx = _ctx(MARKS, setup_s, window_ms)
    values = [_read(n, ctx) for n in NAMES]
    assert abs(sum(values) - setup_s) < 0.010
    assert all(v >= 0 for v in values)


@pytest.mark.parametrize("case", ["no spans", "no marks key", "no marks",
                                  "no init mark"])
def test_the_phases_read_none_without_marks(case):
    ctx = {"no spans": dict(_ctx(None), spans=None),
           "no marks key": _ctx(None),
           "no marks": _ctx([]),
           "no init mark": _ctx([m for m in MARKS
                                 if m["name"] != "serve.setup.init"])}[case]
    for n in NAMES:
        assert _read(n, ctx) is None, n


def test_benchmark_lists_the_five_phases():
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    entries = [m for m in bench["per_layer"] if m["name"].startswith(
        "setup.")]
    assert [m["name"] for m in entries] == NAMES
    assert bench["per_layer"][-5:] == entries
    for m in entries:
        assert m == {"name": m["name"], "unit": "s", "better": "lower",
                     "source": "program_span", "layer": "Start path",
                     "moves": "setup_s", "workloads": CELLS}


SCRIPT = textwrap.dedent("""
    import time
    T0 = time.monotonic()
    import copy, json
    from portbench import run
    cell = copy.deepcopy(run.load_cell("serve8k.live"))
    cell["config"]["serve_flags"]["max_streams"] = 2
    cell["traffic"].update(clients=2, processes=1, loadgen_cores=0,
                           warmup_s=0.5, drain_s=60.0,
                           capture={"frames": 2048, "every_s": 0.3})
    seen, ctx = {}, {}
    r = run.run_cell(cell, 2**31 + 4051, 1.0, False, device="cpu",
                     fault=lambda s: seen.update(server=s), t0=T0, out=ctx)
    ctx["spans"] = seen["server"].spans.snapshot()
    names = [f"setup.{p}_s" for p in
             ("torch", "import", "server_init", "server_start",
              "after_start")]
    print(json.dumps(dict(
        steps=r["info"]["steps"], setup_s=ctx["setup_s"],
        values={n: run.load_reader(run.PKG, n)(ctx) for n in names})))
""")


def test_a_tiny_cpu_run_reads_the_five_phases():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    values = out["values"]
    assert sorted(values) == sorted(NAMES)
    assert all(v is not None and v >= 0 for v in values.values()), values
    assert abs(sum(values.values()) - out["setup_s"]) < 0.010
    # The server's start ran every shape; the traffic's warm-up of 0.5 s
    # lies after it.
    assert values["setup.after_start_s"] >= 0.5
