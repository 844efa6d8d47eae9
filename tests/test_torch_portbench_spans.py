"""The benchmark's reading of the serve plane's spans (``portbench/spans.py``
and the span metrics' readers) on hand-made windows whose answers are
known: clipping, self time, the dispatcher's innermost span, the device's
idle time by span, the quantize's device time by correlation and by
stream order; the benchmark's existing readers read the same values with
and without the new keys; and a tiny run on the CPU through
``portbench.spanrun`` reads every host span metric, leaving the harness's
functions as they were."""

import copy
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from portbench import run, spanrun, spans, trace
from totton_tpu_torch.serve import LATENCY_EDGES_MS

MS = 1_000_000
EXISTING = ("block_p95_ms", "loadgen.late_p95_ms", "serve.frames_per_step",
            "serve.drain_wait_ms", "host.cpu_ns_per_sample",
            "devstep_roofline", "fused_frames_roofline", "device.idle_share",
            "out_samples_per_s", "setup_s")


def _snap(rows, names):
    """A Spans.snapshot() from rows of (name, t0 ms, t1 ms, cpu ms, tid,
    parent row or -1, key)."""
    ids = {n: i for i, n in enumerate(names)}
    cols = dict(num=[], name=[], t0=[], t1=[], cpu=[], parent=[], key=[],
                gen=[], tid=[])
    for i, (name, a, b, cpu, tid, parent, key) in enumerate(rows):
        cols["num"].append(100 + i)
        cols["name"].append(ids[name])
        cols["t0"].append(int(a * MS))
        cols["t1"].append(int(b * MS))
        cols["cpu"].append(int(cpu * MS))
        cols["parent"].append(-1 if parent < 0 else 100 + parent)
        cols["key"].append(key)
        cols["gen"].append(-1 if tid == 1 else 1)
        cols["tid"].append(tid)
    out = {k: np.asarray(v, np.int64) for k, v in cols.items()}
    out["name"] = out["name"].astype(np.int32)
    out.update(names=list(names), dropped=0, open=0)
    return out


NAMES = ["serve.gather", "serve.enqueue", "serve.upload", "serve.launch",
         "serve.quantize", "serve.download", "serve.drain",
         "serve.drain_wait", "serve.housekeeping", "serve.wait_input",
         "serve.read", "serve.write", "serve.send"]
# The dispatcher (thread 1) over a window of [10, 50] ms, two steps; a
# reader and a writer on thread 2.
ROWS = [
    ("serve.wait_input", 0, 12, 0, 1, -1, 0),       # 0: cut to [10, 12]
    ("serve.gather", 12, 14, 2, 1, -1, 0),          # 1
    ("serve.enqueue", 14, 20, 4, 1, -1, 0),         # 2
    ("serve.upload", 14, 15, 1, 1, 2, 0),           # 3
    ("serve.launch", 15, 18, 2, 1, 2, 0),           # 4
    ("serve.quantize", 18, 19, 1, 1, 2, 0),         # 5
    ("serve.download", 19, 20, 0, 1, 2, 0),         # 6
    ("serve.drain", 24, 30, 1, 1, -1, 0),           # 7
    ("serve.drain_wait", 24, 28, 0, 1, 7, 0),       # 8
    ("serve.housekeeping", 30, 31, 1, 1, -1, 1),    # 9
    ("serve.wait_input", 31, 40, 0, 1, -1, 1),      # 10
    ("serve.gather", 40, 42, 1, 1, -1, 1),          # 11
    ("serve.enqueue", 42, 46, 2, 1, -1, 1),         # 12
    ("serve.drain", 46, 60, 2, 1, -1, 1),           # 13: cut to [46, 50]
    ("serve.read", 11, 13, 1, 2, -1, 0),            # 14
    ("serve.write", 30, 34, 3, 2, -1, 0),           # 15
    ("serve.send", 31, 33, 1, 2, 15, 0),            # 16
]
# The device busy over [15, 18] and [26, 32] ms, two kernels of the
# quantize launched at 18.2 and 18.6 ms, and a copy.
KERNELS = [("fft_resident<512,8192>", 15 * MS, 18 * MS, 15 * MS),
           ("clamp_kernel", int(18.5 * MS), int(18.6 * MS), int(18.2 * MS)),
           ("cast_kernel", int(18.7 * MS), int(18.8 * MS), int(18.6 * MS)),
           ("Memcpy DtoH (Device -> Pinned)", 26 * MS, 32 * MS, None)]


def _config():
    return dict(block_size=8384, fft_size=16384, ratio=16,
                serve_flags=dict(channels=2, device_pcm=True))


def _counters(steps, frames_out, lat=()):
    hist = [0] * (len(LATENCY_EDGES_MS) + 1)
    for v in lat:
        hist[int(np.searchsorted(LATENCY_EDGES_MS, v, side="right"))] += 1
    return dict(steps=steps, steps_by_shape={"8x1": steps},
                drain_wall_s=0.0, frames_out=frames_out, block_latency=hist)


def _ctx(kernels=KERNELS, busy=((15 * MS, 18 * MS), (26 * MS, 32 * MS))):
    window = dict(bounds_ns=(10 * MS, 50 * MS), busy_ns=list(busy),
                  kernels=list(kernels),
                  before=_counters(10, 0, [1.0] * 10),
                  after=_counters(12, 4 * 8384, [1.0] * 10 + [2.0] * 19
                                  + [9.0]))
    return dict(config=_config(), spans=_snap(ROWS, NAMES), trace=window)


def _read(name, ctx):
    return run.load_reader(run.PKG, name)(ctx)


def test_clipping_self_time_and_per_step():
    w = spans.window_of(_ctx())
    assert (w.steps, w.blocks) == (2, 4.0)
    assert w.total("serve.wait_input") == 11 * MS   # 2 + 9
    assert w.total("serve.drain") == 10 * MS        # 6 + 4 (cut)
    assert w.cpu_total("serve.drain") == pytest.approx(1 * MS + 2 * MS * 4
                                                       / 14)
    self_ms = {k: v / MS for k, v in w.self_time().items()}
    assert self_ms["serve.enqueue"] == 4.0          # 6 + 4 less 6 of children
    assert self_ms["serve.drain"] == 6.0            # 10 less the 4 ms wait
    assert self_ms["serve.write"] == 2.0
    assert w.per_step_ms()["serve.gather"] == 2.0


def test_innermost_span_and_idle_by_span():
    w = spans.window_of(_ctx())
    segs = w.dispatcher_segments()
    assert segs[0] == (10 * MS, 12 * MS, "serve.wait_input")
    assert (20 * MS, 24 * MS, spans.NONE) in segs
    assert (24 * MS, 28 * MS, "serve.drain_wait") in segs
    assert (28 * MS, 30 * MS, "serve.drain") in segs
    assert segs[-1] == (46 * MS, 50 * MS, "serve.drain")
    assert sum(b - a for a, b, _ in segs) == 40 * MS
    idle = {k: v / MS for k, v in w.idle_by_span().items()}
    # Idle: [10, 15], [18, 26], [32, 50].
    assert idle == {"serve.wait_input": 2 + 8, "serve.gather": 2 + 2,
                    "serve.upload": 1, "serve.quantize": 1,
                    "serve.download": 1, spans.NONE: 4,
                    "serve.drain_wait": 2, "serve.enqueue": 4,
                    "serve.drain": 4}
    assert sum(idle.values()) == 40 - 9


def test_span_metrics_read_known_values():
    ctx = _ctx()
    assert _read("serve.gather_ms", ctx) == 2.0            # 4 ms / 2 steps
    assert _read("serve.enqueue_ms", ctx) == 5.0           # 10 / 2
    assert _read("serve.drain_host_ms", ctx) == 3.0        # (10 - 4) / 2
    assert _read("serve.input_wait_share", ctx) == pytest.approx(27.5)
    # Host work: gather 4, enqueue 10, housekeeping 1, drain 10 less the
    # wait's 4: wall 21 ms; CPU 3 + 6 + 1 + (1 + 8/14) less 0.
    cpu = 3 + 6 + 1 + 1 + 2 * 4 / 14
    assert _read("serve.dispatcher_offcpu_share", ctx) == pytest.approx(
        (1 - cpu / 21) * 100)
    assert _read("serve.reader_ms_per_block", ctx) == 0.5  # 2 ms / 4
    assert _read("serve.writer_ms_per_block", ctx) == 1.0  # 4 ms / 4
    # Device idle outside serve.wait_input: 31 - 10 ms of 40.
    assert _read("device.idle_on_host_share", ctx) == pytest.approx(52.5)
    # Two kernels launched inside the one serve.quantize span.
    assert _read("device.quantize_us_per_step", ctx) == pytest.approx(200.0)
    # 19 of the window's 20 blocks at 2 ms, one at 9 ms: p95 within the
    # 2 ms bucket and the 9 ms one.
    p95 = _read("serve.server_block_p95_ms", ctx)
    assert 2.0 <= p95 <= 9.0 * 1.02
    assert p95 == pytest.approx(np.percentile([2.0] * 19 + [9.0], 95),
                                rel=0.03)


def test_quantize_by_stream_order_without_launch_records():
    kernels = [(n, a, b, None) for n, a, b, _l in KERNELS]
    w = spans.window_of(_ctx(kernels=kernels))
    assert w.quantize_ns_per_step() == (
        200_000.0, "stream order", {"clamp_kernel": 1, "cast_kernel": 1})
    # With launch records, the same two kernels by correlation.
    w = spans.window_of(_ctx())
    assert w.quantize_ns_per_step() == (
        200_000.0, "correlation", {"clamp_kernel": 1, "cast_kernel": 1})
    assert w.quantize_ns_per_step("stream order")[:2] == (200_000.0,
                                                          "stream order")


def test_span_metrics_read_nothing_without_spans():
    ctx = _ctx()
    ctx["spans"] = None
    del ctx["trace"]["before"]["block_latency"]
    for name in spanrun.METRICS:
        assert _read(name, ctx) is None, name
    assert _read("serve.gather_ms", dict(config=_config(), spans=None,
                                         trace=None)) is None


def _run_ctx():
    """A run's ctx as run.py builds it, with a device window."""
    rng = np.random.default_rng(3)
    streams = [dict(block_lat_s=rng.uniform(0.001, 0.01, 500),
                    late_s=rng.uniform(0, 0.002, 500), window_samples=9000)
               for _ in range(3)]
    before = dict(steps=100, steps_by_shape={"8x1": 100}, drain_wall_s=0.1,
                  frames_out=10 * 8384)
    after = dict(steps=400, steps_by_shape={"8x1": 400}, drain_wall_s=0.3,
                 frames_out=600 * 8384)
    tr = dict(window_s=2.5, busy_s=0.04, kernel_s=0.02, frame_kernel_s=0.01,
              last_launches=300, device_ops=[], idle_gaps=[], attempt=1,
              dispatched=300, before=before, after=after)
    return dict(cell=None, config=dict(_config(), serve_flags=dict(
        channels=2, device_pcm=True)), traffic={}, seconds=30.0,
        setup_s=12.5, streams=streams,
        window=dict(steps=3000, steps_by_shape={"8x1": 3000},
                    drain_wall_s=0.4, frames_out=6000 * 8384),
        cpu_s=3.2, out_samples=8_000_000, trace=tr, paced=True)


def test_existing_readers_read_the_same_with_the_new_keys():
    plain = _run_ctx()
    values = {n: _read(n, copy.deepcopy(plain)) for n in EXISTING}
    assert all(v is not None for v in values.values())
    more = copy.deepcopy(plain)
    hist = [0] * (len(LATENCY_EDGES_MS) + 1)
    for snap in (more["trace"]["before"], more["trace"]["after"]):
        snap.update(block_latency=hist, t_ns=123)
    more["trace"].update(bounds_ns=(0, 2_500_000_000), busy_ns=[(1, 2)],
                         kernels=[("k", 1, 2, None)], launch_records=0)
    more["spans"] = _snap(ROWS, NAMES)
    assert {n: _read(n, more) for n in EXISTING} == values


class _Event:
    def __init__(self, name, device, start, dur, corr):
        self._v = (name, device, start, dur, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


@pytest.mark.parametrize("marker_launch,clock", [(False, False),
                                                  (True, False),
                                                  (True, True)])
def test_device_window_maps_the_trace_onto_the_host_clock(marker_launch,
                                                          clock):
    from torch.autograd import DeviceType

    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    off = 5_000_000_000_000          # trace ns = host ns + off
    host = lambda ms: int(ms * MS)   # noqa: E731
    events = [
        _Event("void at::native::FillFunctor<float>", cuda, host(10.01) + off,
               1000, 1),
        _Event("cudaLaunchKernel", cpu, host(12) + off, 500, 2),
        _Event("fft_resident<512,8192>", cuda, host(12.5) + off, host(1), 2),
        _Event("Memcpy DtoH (Device -> Pinned)", cuda, host(14) + off,
               host(2), 3),
        _Event("late_kernel", cuda, host(49) + off, host(5), 4),
        _Event("void at::native::FillFunctor<float>", cuda, host(50.01) + off,
               1000, 5),
    ]
    if marker_launch:
        events.append(_Event("cudaLaunchKernel", cpu, host(10) + off, 300, 1))
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    w = dict(prof=prof, marks=[0.010, 0.050], t0=0.011, t1=0.050)
    if clock:
        # The marker's launch trailed its host time by 3 us; the clock
        # offset read back to back is exact.
        for e in events:
            if e.name() == "cudaLaunchKernel" and e.correlation_id() == 1:
                e._v = (e._v[0], e._v[1], e._v[2] + 3000, e._v[3], 1)
        w["before"] = dict(clock_offset_ns=off)
    dev = spans.device_window(w)
    # By the marker kernel, which runs 10 us after its launch, the device
    # reads 10 us early; by its launch record or the clock, exactly.
    shift = 0 if marker_launch else -10_000
    assert dev["offset_ns"] == off - shift
    assert dev["offset_from"] == ("clock" if clock else "launch"
                                  if marker_launch else "kernel")
    if clock:
        assert dev["marker_delay_ns"] == 3000
    assert dev["bounds_ns"] == (host(11), host(50))
    assert dev["busy_ns"] == [(host(12.5) + shift, host(13.5) + shift),
                              (host(14) + shift, host(16) + shift),
                              (host(49) + shift, host(50))]
    names = [k[0] for k in dev["kernels"]]
    assert names[0].startswith("fft_resident") and len(names) == 3
    assert dev["kernels"][0][3] == host(12) + shift   # its launch
    assert dev["kernels"][1][3] is None
    assert dev["launch_records"] == 1 + marker_launch


def _tiny(name):
    cell = copy.deepcopy(run.load_cell(name))
    cell["config"]["serve_flags"]["max_streams"] = 2
    cell["traffic"].update(clients=2, processes=1, loadgen_cores=0,
                           warmup_s=0.5, drain_s=60.0,
                           capture={"frames": 2048, "every_s": 0.3})
    return cell


@pytest.mark.parametrize("mode", ["all", "after"])
def test_spanrun_on_a_tiny_cpu_cell(mode, tmp_path):
    chrome = tmp_path / "spans.json"
    snapshot, take_windows = run.snapshot, trace.take_windows
    out = spanrun.run_with_spans(_tiny("serve8k.live"), 2**31 + 77, 1.5,
                                 trace=True, mode=mode, device="cpu",
                                 chrome=str(chrome) if mode == "all"
                                 else None)
    assert (run.snapshot, trace.take_windows) == (snapshot, take_windows)
    assert out["result"]["correct"] is True
    assert out["info"]["steps"] > 0
    if mode == "after":
        # The CPU has no profiler windows to switch the spans on around.
        assert out["spans"]["records"] == 0
        assert not {"measured", "window"} & set(out["spans"])
        return
    got = out["spans"]["measured"]
    assert out["spans"]["dropped"] == 0 and got["steps"] > 0
    host = [n for n in spanrun.METRICS if not n.startswith("device.")]
    assert sorted(got["metrics"]) == sorted(host)
    assert 0 <= got["metrics"]["serve.input_wait_share"] <= 100
    assert got["per_step_ms"]["serve.quantize"] > 0
    events = json.loads(chrome.read_text())["traceEvents"]
    assert {"serve.gather", "serve.quantize", "serve.read"} <= {
        e["name"] for e in events}
