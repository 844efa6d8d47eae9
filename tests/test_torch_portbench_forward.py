"""The benchmark's readers of the frame kernel's forward and of the serve
plane's halo (``portbench/forward.py``,
``metrics/fused_frames.forward_roofline.py``, ``metrics/serve.halo_ms.py``)
on hand-made windows whose answers are counted by hand; each reads None
where its records or spans are absent, as on a program that lacks them;
and every other per-layer reader of ``BENCHMARK.json`` reads the same value
with the halo's child spans in the window as without them."""

import copy
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from portbench import forward, run
from totton_tpu_torch.serve import LATENCY_EDGES_MS

MS = 1_000_000
NEW = ("fused_frames.forward_roofline", "serve.halo_ms")
F1 = ("void (anonymous namespace)::fft_stage<256, false, (anonymous "
      "namespace)::FwdStage1Load, (anonymous namespace)::FwdStage1Store>"
      "(long, int, float2 const*)")
F2 = ("void (anonymous namespace)::fft_stage<128, false, (anonymous "
      "namespace)::FwdStage2Load, (anonymous namespace)::FwdStage2Store>"
      "(long, int, float2 const*)")
I1 = ("void (anonymous namespace)::fft_stage<256, true, (anonymous "
      "namespace)::InvStage1Load, (anonymous namespace)::InvStage1Store>"
      "(long, int, float2 const*)")
I2 = ("void (anonymous namespace)::fft_stage<256, true, (anonymous "
      "namespace)::InvStage2Load, (anonymous namespace)::OutStore>"
      "(long, int, float2 const*)")
F = ("void (anonymous namespace)::fft_stage<4096, false, (anonymous "
     "namespace)::FrameLoad, (anonymous namespace)::SpecStore>"
     "(long, int, float2 const*)")
R = "void (anonymous namespace)::fft_resident<512, 8192>(...)"

# The dispatcher (thread 1) over a window of [10, 50] ms, two steps, with
# every span it records; a reader and a writer on thread 2. Rows: (name,
# t0 ms, t1 ms, cpu ms, thread, parent row or -1, step).
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
    ("serve.gather", 40, 43, 1, 1, -1, 1),          # 11
    ("serve.enqueue", 43, 46, 2, 1, -1, 1),         # 12
    ("serve.upload", 43, 44, 1, 1, 12, 1),          # 13
    ("serve.drain", 46, 60, 2, 1, -1, 1),           # 14: cut to [46, 50]
    ("serve.read", 11, 13, 1, 2, -1, 0),            # 15
    ("serve.write", 30, 34, 3, 2, -1, 0),           # 16
    ("serve.send", 31, 33, 1, 2, 16, 0),            # 17
]
# The halo's spans, each inside its parent: 1 + 2 ms of gather, 0.4 + 0.5
# ms of upload; the rest of each upload is the new input's.
HALO = [
    ("serve.gather_halo", 13, 14, 0.5, 1, 1, 0),
    ("serve.upload_halo", 14, 14.4, 0.2, 1, 3, 0),
    ("serve.upload_input", 14.4, 15, 0.3, 1, 3, 0),
    ("serve.gather_halo", 41, 43, 1, 1, 11, 1),
    ("serve.upload_halo", 43, 43.5, 0.5, 1, 13, 1),
    ("serve.upload_input", 43.5, 44, 0.5, 1, 13, 1),
]
BUSY = ((15 * MS, 18 * MS), (26 * MS, 32 * MS))
# 4x: F1 2 us and F2 1 us of forward in all; 16x: F 0.6 us.
KERNELS_4X = [(F1, 15 * MS, 15 * MS + 1200, 15 * MS),
              (F2, 15 * MS + 1200, 15 * MS + 1800, None),
              (I1, 15 * MS + 1800, 16 * MS, None),
              (I2, 16 * MS, 17 * MS, None),
              (F1, 17 * MS, 17 * MS + 800, None),
              (F2, 17 * MS + 800, 17 * MS + 1200, None),
              ("clamp_kernel", int(18.5 * MS), int(18.6 * MS),
               int(18.2 * MS)),
              ("Memcpy DtoH (Device -> Pinned)", 26 * MS, 32 * MS, None)]
KERNELS_16X = [(F, 15 * MS, 15 * MS + 600, 15 * MS),
               (I1, 15 * MS + 600, 16 * MS, None),
               (I2, 16 * MS, 17 * MS, None)]


def _snap(rows):
    """A Spans.snapshot() of ``rows``."""
    names = sorted({r[0] for r in rows})
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
    out.update(names=names, dropped=0, open=0)
    return out


def _counters(steps, frames_out, lat=()):
    hist = [0] * (len(LATENCY_EDGES_MS) + 1)
    for v in lat:
        hist[int(np.searchsorted(LATENCY_EDGES_MS, v, side="right"))] += 1
    return dict(steps=steps, steps_by_shape={"8x1": steps},
                drain_wall_s=0.0, frames_out=frames_out, block_latency=hist,
                t_ns=0, clock_offset_ns=0)


def _config(name="serve4x192k.live"):
    return copy.deepcopy(run.load_cell(name)["config"])


def _ctx(rows=ROWS, kernels=KERNELS_4X, cell="serve4x192k.live"):
    """A traced run's ctx as run.py builds it: the streams, the measured
    window's counters, and the chosen profiler window with its device
    records and spans. The window served 6 blocks a slot, 12 frames."""
    config = _config(cell)
    block = config["block_size"]
    rng = np.random.default_rng(3)
    streams = [dict(block_lat_s=rng.uniform(0.001, 0.01, 500),
                    late_s=rng.uniform(0, 0.002, 500), window_samples=9000)
               for _ in range(3)]
    kernel_s = sum(b - a for n, a, b, _l in kernels
                   if not n.startswith("Memcpy")) * 1e-9
    frame_s = sum(b - a for n, a, b, _l in kernels
                  if "fft_" in n) * 1e-9
    trace = dict(bounds_ns=(10 * MS, 50 * MS), busy_ns=list(BUSY),
                 kernels=list(kernels), window_s=0.040,
                 busy_s=0.009, kernel_s=kernel_s, frame_kernel_s=frame_s,
                 before=_counters(10, 0, [1.0] * 10),
                 after=_counters(12, 6 * block, [1.0] * 10 + [2.0] * 19
                                 + [9.0]))
    return dict(config=config, seconds=30.0, setup_s=12.5, streams=streams,
                window=dict(steps=3000, steps_by_shape={"8x1": 3000},
                            drain_wall_s=0.4, frames_out=6000 * block),
                cpu_s=3.2, out_samples=8_000_000, trace=trace, paced=True,
                spans=_snap(list(rows)))


def _read(name, ctx):
    return run.load_reader(run.PKG, name)(ctx)


@pytest.mark.parametrize("m,side,ns", [
    (32768, "bytes", 8 * 32768 / 3.35e12 * 1e9),     # 78.25 ns
    (8192, "bytes", 8 * 8192 / 3.35e12 * 1e9),       # 19.56 ns
    (65536, "bytes", 8 * 65536 / 3.35e12 * 1e9),     # 156.50 ns (2x)
])
def test_forward_least_time_by_hand(m, side, ns):
    assert forward.forward_flops(m) == 2.5 * m * np.log2(m)
    assert forward.forward_bytes(m) == 8 * m
    least, got_side = forward.forward_least_seconds(m, 3)
    assert got_side == side
    assert least == pytest.approx(3 * ns * 1e-9, rel=1e-12)
    if m == 32768:
        assert ns == pytest.approx(78.25, abs=0.01)


@pytest.mark.parametrize("cell,kernels,spent_ns,m", [
    ("serve4x192k.live", KERNELS_4X, 1200 + 600 + 800 + 400, 32768),
    ("serve80k.live", KERNELS_16X, 600, 8192),
])
def test_forward_roofline_by_hand(cell, kernels, spent_ns, m):
    ctx = _ctx(kernels=kernels, cell=cell)
    # 6 blocks of each of 2 channels: 12 frames, 8m bytes each.
    want = 12 * 8 * m / 3.35e12 / (spent_ns * 1e-9) * 100
    assert _read("fused_frames.forward_roofline", ctx) == pytest.approx(
        want, rel=1e-12)
    assert forward.forward_kernel_s(kernels) == pytest.approx(
        spent_ns * 1e-9, rel=1e-12)


def test_halo_ms_by_hand():
    # (1 + 2 ms of gather_halo + 0.4 + 0.5 of upload_halo) / 2 steps.
    assert _read("serve.halo_ms", _ctx(ROWS + HALO)) == pytest.approx(1.95)


def test_new_readers_read_nothing_without_their_records():
    # A program without the halo spans (its parent), or without spans.
    assert _read("serve.halo_ms", _ctx()) is None
    ctx = _ctx(ROWS + HALO)
    ctx["spans"] = None
    assert _read("serve.halo_ms", ctx) is None
    # The resident plan has no forward of its own; a window without
    # device records; an untraced run; no frame served.
    resident = [(R, 15 * MS, 18 * MS, None)]
    assert _read("fused_frames.forward_roofline",
                 _ctx(kernels=resident, cell="serve8k.live")) is None
    ctx = _ctx()
    del ctx["trace"]["kernels"]
    assert _read("fused_frames.forward_roofline", ctx) is None
    for name in NEW:
        ctx = _ctx(ROWS + HALO)
        ctx["trace"] = None
        assert _read(name, ctx) is None, name
    ctx = _ctx(ROWS + HALO)
    ctx["trace"]["after"]["frames_out"] = 0
    assert _read("fused_frames.forward_roofline", ctx) is None


def _existing():
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    return [m["name"] for m in bench["per_layer"] if m["name"] not in NEW]


def test_every_other_reader_reads_the_same_with_the_halo_spans():
    names = _existing()
    plain = {n: _read(n, _ctx()) for n in names}
    # Readers of the spans the halo's children nest in read this window,
    # so the comparison holds values and not only Nones.
    for n in ("serve.gather_ms", "serve.enqueue_ms",
              "device.idle_on_host_share"):
        assert n not in names or plain[n] is not None, plain
    assert {n: _read(n, _ctx(ROWS + HALO)) for n in names} == plain
