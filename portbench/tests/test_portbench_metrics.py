"""The end-to-end block latency's reader on streams whose answer is known,
the device window's reduction on the host's clock, and every entry of
``BENCHMARK.json`` against the files and cells it names."""

from __future__ import annotations

import json
import types

import numpy as np
import pytest

from portbench import loadgen, run, trace

MS = 1_000_000


def _read(name, ctx):
    return run.load_reader(run.PKG, name)(ctx)


def _streams(*lats_ms):
    return [dict(block_lat_s=np.asarray(v, float) / 1e3) for v in lats_ms]


def test_block_p50_ms_is_the_median_of_every_block():
    streams = _streams([1.0, 2.0, 9.0], [3.0, 4.0], [])
    assert _read("block_p50_ms", dict(streams=streams, paced=True)) == 3.0
    assert loadgen.block_p50_ms(streams) == 3.0
    # The tail is read from the same blocks, in the same units.
    assert loadgen.block_p95_ms(streams) == pytest.approx(
        np.percentile([1, 2, 9, 3, 4], 95))


def test_block_p50_ms_counts_a_lost_block_late():
    # Three of five blocks never came: the median is a lost one, 1e3 s.
    streams = _streams([1.0, np.inf, np.inf], [np.inf, 2.0])
    assert _read("block_p50_ms", dict(streams=streams, paced=True)) == 1e6
    streams = _streams([1.0, 2.0, np.inf])
    assert _read("block_p50_ms", dict(streams=streams, paced=True)) == 2.0


def test_block_p50_ms_reads_nothing_for_bulk_or_no_block():
    streams = _streams([1.0, 2.0])
    assert _read("block_p50_ms", dict(streams=streams, paced=False)) is None
    assert _read("block_p50_ms", dict(streams=_streams([], []),
                                      paced=True)) is None


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


@pytest.mark.parametrize("delay_ms", [0.003, 9.81])
def test_reduce_window_takes_the_offset_from_the_clock(delay_ms):
    """The marker's launch record trails its host time (by the Python
    dispatch of one op, or a wait for the GIL); the window's numbers are
    placed by ``clock_offset_ns`` all the same, and the idle gaps are
    named by the samples that fall in them."""
    from torch.autograd import DeviceType

    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    off = 7_000_000_000_000          # trace ns = host ns + off
    delay = int(delay_ms * MS)

    def at(ms):
        return int(ms * MS) + off

    events = [
        _Event("void at::native::FillFunctor<float>", cuda, at(10) + delay
               + 5000, 1000, 1),
        _Event("cudaLaunchKernel", cpu, at(10) + delay, 300, 1),
        _Event("cudaLaunchKernel", cpu, at(19), 500, 2),
        _Event("fft_resident<512,8192>", cuda, at(20), 2 * MS, 2),
        _Event("Memcpy DtoH (Device -> Pinned)", cuda, at(24), 1 * MS, 3),
        _Event("fft_resident<512,8192>", cuda, at(40), 2 * MS, 4),
        _Event("void at::native::FillFunctor<float>", cuda, at(50) + delay
               + 5000, 1000, 5),
    ]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    samples = [(0.012, "serve.py:_gather"), (0.030, "threading.py:wait"),
               (0.031, "threading.py:wait"), (0.032, "serve.py:_gather")]
    w = dict(prof=prof, marks=[0.010, 0.050], t0=0.011, t1=0.050,
             samples=samples, before=dict(clock_offset_ns=off))
    got = trace.reduce_window(w)
    assert (got["offset_ns"], got["offset_from"]) == (off, "clock")
    assert got["marker_delay_ns"] == delay
    assert got["bounds_ns"] == (11 * MS, 50 * MS)
    assert got["busy_ns"] == [(20 * MS, 22 * MS), (24 * MS, 25 * MS),
                              (40 * MS, 42 * MS)]
    assert [k[0] for k in got["kernels"]] == [
        "fft_resident<512,8192>", "Memcpy DtoH (Device -> Pinned)",
        "fft_resident<512,8192>"]
    assert got["kernels"][0][3] == 19 * MS          # its launch, host ns
    assert got["window_s"] == pytest.approx(0.039)
    assert got["busy_s"] == pytest.approx(0.005)
    assert got["kernel_s"] == got["frame_kernel_s"] == pytest.approx(0.004)
    assert got["last_launches"] == 2
    # Idle: [11, 20], [22, 24], [25, 40], [42, 50] ms, longest first.
    assert [g[1] for g in got["idle_gaps"]] == pytest.approx(
        [0.015, 0.009, 0.008, 0.002])
    assert got["idle_gaps"][0][0] == \
        "dispatcher in threading.py:wait (67% of samples)"
    assert got["idle_gaps"][1][0] == \
        "dispatcher in serve.py:_gather (100% of samples)"
    assert got["idle_gaps"][2][0] == "dispatcher not sampled"


def _bench():
    return json.loads((run.ROOT / "BENCHMARK.json").read_text())


def _metrics():
    b = _bench()
    return [(kind, m) for kind in ("end_to_end", "per_layer")
            for m in b[kind]]


@pytest.mark.parametrize("kind,entry", _metrics(),
                         ids=lambda v: v if isinstance(v, str)
                         else v["name"])
def test_every_metric_has_its_reader_and_existing_cells(kind, entry):
    bench = _bench()
    cells = {w["name"] for w in bench["workloads"]}
    assert callable(run.load_reader(run.PKG, entry["name"]))
    listed = entry.get("workloads")
    if listed is not None:
        assert listed and set(listed) <= cells
        assert len(set(listed)) == len(listed)
    if kind == "per_layer":
        # The end-to-end metric it moves is reported in each of its cells.
        moved = {m["name"]: m for m in bench["end_to_end"]}[entry["moves"]]
        assert set(listed or cells) <= set(moved.get("workloads", cells))
