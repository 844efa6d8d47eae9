"""The server's start marks, on the CPU with the 8k bank: a
StreamServer(device="cpu") at 16x/8k with device PCM marks its import,
each phase of its constructor and of start() in order, one step a (width,
depth) shape with its three legs end to end; a kernel library's first load
is marked apart, inside the enqueue of the step that loaded it; the marks
survive the spans' start() and stop() and appear in snapshot() and
write_chrome; and a stream served with the spans off adds no ring record
and no mark."""

import ctypes.util
import json
import os
import socket
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import totton_tpu_torch
from totton_tpu_torch import serve
from totton_tpu_torch.filters.sidecar import load_filter
from totton_tpu_torch.io.pcm import PcmFormat
from totton_tpu_torch.io.serve_client import ServeClient
from totton_tpu_torch.ops import _build
from totton_tpu_torch.utils.profiling import Spans

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANK_8K = os.path.join(REPO, "data", "coefficients",
                       "filter_44k_16x_8000_min_phase.json")
RATE = 44100
MAX_STREAMS, MAX_BLOCKS = 16, 4
#: the shapes start() runs: slot widths 8 and 16 at 1, 2 and 4 blocks
SHAPES = [(w, k) for w in (8, 16) for k in (1, 2, 4)]
LEGS = ("serve.setup.warm.upload", "serve.setup.warm.enqueue",
        "serve.setup.warm.fetch")
INIT = ("serve.setup.device", "serve.setup.kernel_plan",
        "serve.setup.fold.upload", "serve.setup.fold.bundle",
        "serve.setup.block_step", "serve.setup.slots")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _server(port):
    return serve.StreamServer(
        load_filter(BANK_8K), f"tcp-listen://127.0.0.1:{port}", RATE,
        max_streams=MAX_STREAMS, channels=2, max_blocks_per_step=MAX_BLOCKS,
        device_pcm=True, device="cpu")


@pytest.fixture(scope="module")
def started():
    """A server after start(), with a library load recorded inside its
    first step (the CPU path loads none): (server, marks, the load's
    (start, end) readings)."""
    saved = _build.loads
    _build.loads = {}
    port = _free_port()
    srv = _server(port)
    step = srv._step
    probe = {}

    def loading_step(*args):
        if "probe" not in _build.loads:
            since = Spans.clock()
            time.sleep(0.002)
            probe["at"] = _build.loads["probe"] = (since, Spans.clock())
        return step(*args)

    srv._step = loading_step
    try:
        srv.start()
    finally:
        _build.loads = saved
    yield srv, srv.spans.snapshot()["marks"], probe["at"], port
    srv.stop()


def _named(marks, name):
    return [m for m in marks if m["name"] == name]


def test_marks_cover_the_constructor_and_start_in_order(started):
    _srv, marks, _probe, _port = started
    one = {n: _named(marks, n) for n in ("serve.setup.import",
                                         "serve.setup.init",
                                         "serve.setup.listen",
                                         "serve.setup.threads",
                                         "serve.setup.start") + INIT}
    assert all(len(v) == 1 for v in one.values()), one
    m = {n: v[0] for n, v in one.items()}
    imp, init, start = (m["serve.setup.import"], m["serve.setup.init"],
                        m["serve.setup.start"])
    first = totton_tpu_torch._IMPORT_START
    assert (imp["t0"], imp["t1"]) == (first[0], serve._IMPORT_END[0])
    assert imp["t1"] <= init["t0"] < init["t1"] <= start["t0"] < start["t1"]
    # The constructor's phases, in order and inside it.
    bounds = [(m[n]["t0"], m[n]["t1"]) for n in INIT]
    assert bounds == sorted(bounds)
    for (a0, a1), (b0, _b1) in zip(bounds, bounds[1:]):
        assert a1 <= b0
    assert init["t0"] <= bounds[0][0] and bounds[-1][1] <= init["t1"]
    # start(): the listen, the steps and the threads meet end to end.
    steps = _named(marks, "serve.setup.warm")
    chain = [m["serve.setup.listen"]] + steps + [m["serve.setup.threads"]]
    assert chain[0]["t0"] == start["t0"] and chain[-1]["t1"] == start["t1"]
    for a, b in zip(chain, chain[1:]):
        assert a["t1"] == b["t0"]
    for x in marks:
        assert 0 <= x["t1"] - x["t0"] and x["cpu"] >= 0
        assert x["tid"] == threading.get_ident()


def test_one_mark_per_shape_with_three_legs(started):
    _srv, marks, _probe, _port = started
    steps = _named(marks, "serve.setup.warm")
    assert [(s["key"], s["gen"]) for s in steps] == SHAPES
    for s in steps:
        legs = [x for x in marks if x["name"] in LEGS
                and (x["key"], x["gen"]) == (s["key"], s["gen"])]
        assert [x["name"] for x in legs] == list(LEGS)
        assert legs[0]["t0"] == s["t0"] and legs[-1]["t1"] == s["t1"]
        for a, b in zip(legs, legs[1:]):
            assert a["t1"] == b["t0"]


def test_a_librarys_first_load_is_marked_apart(started):
    _srv, marks, (since, until), _port = started
    load = _named(marks, "serve.setup.load.probe")
    assert len(load) == 1
    assert (load[0]["t0"], load[0]["t1"]) == (since[0], until[0])
    assert load[0]["t1"] - load[0]["t0"] >= 2_000_000
    enqueue = [x for x in marks if x["name"] == "serve.setup.warm.enqueue"
               and (x["key"], x["gen"]) == SHAPES[0]][0]
    assert enqueue["t0"] <= load[0]["t0"] < load[0]["t1"] <= enqueue["t1"]


def test_build_load_records_each_librarys_first_load(monkeypatch):
    libc = ctypes.util.find_library("c")
    if libc is None:
        pytest.skip("no C library to load by name on this host")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "loads", {})
    monkeypatch.setattr(_build, "build", lambda name: libc)
    lib = _build.load("probe")
    (t0, c0), (t1, c1) = _build.loads["probe"]
    assert t0 <= t1 and c0 <= c1
    assert _build.load("probe") is lib
    assert _build.loads["probe"] == ((t0, c0), (t1, c1))


def test_marks_survive_the_spans_switch_and_reach_chrome(started,
                                                         tmp_path):
    srv, marks, _probe, _port = started
    sp = srv.spans
    sp.start()
    sp.close(sp.open("serve.gather", 1))
    sp.stop()
    snap = sp.snapshot()
    assert snap["marks"] == marks and snap["num"].size == 1
    sp.start()
    assert sp.snapshot()["marks"] == marks
    sp.stop()
    trace = json.loads(open(sp.write_chrome(str(tmp_path / "s.json"))).read())
    got = [e for e in trace["traceEvents"] if e.get("cat") == "mark"]
    assert [e["name"] for e in got] == [m["name"] for m in marks]
    assert trace["tottonSpans"]["marks"] == len(marks)
    warm = [e for e in got if e["name"] == "serve.setup.warm"]
    assert [(e["args"]["key"], e["args"]["gen"]) for e in warm] == SHAPES


def test_spans_off_a_served_stream_adds_no_record(started):
    srv, marks, _probe, port = started
    sp = srv.spans
    sp.start()  # forget the record of the test above, if it ran first
    sp.stop()
    steps = srv.stats.steps
    x = (np.random.default_rng(4).normal(size=(2, 3000)) * 0.3).astype(
        np.float32)
    parts = []
    with ServeClient(f"tcp://127.0.0.1:{port}", 2, RATE,
                     fmt=PcmFormat.S16_LE, timeout_s=60) as c:
        c.send(x)
        c.end_input()
        while (y := c.read_frames()) is not None:
            parts.append(y)
    assert sum(p.shape[1] for p in parts) == 3000 * 16
    assert srv.stats.steps > steps
    snap = sp.snapshot()
    assert snap["num"].size == 0 and snap["open"] == 0
    assert snap["marks"] == marks and not sp.marking
