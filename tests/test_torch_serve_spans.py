"""The serve plane's spans and its block latency histogram, on the CPU: a
StreamServer(device="cpu") serves two clients with spans on; every step
has its gather, enqueue and drain under one step number, each child inside
its parent (the halo's gather and upload inside the step's gather and
upload); the drain waits sum to the drain_wall_s counter; the readers
and writers record under their slot and generation; and the histogram's
quantiles stay within one bucket of numpy's over the same latencies."""

import bisect
import socket
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from totton_tpu_torch import serve
from totton_tpu_torch.filters.sidecar import FilterSidecar, LoadedFilter
from totton_tpu_torch.io.serve_client import ServeClient

torch.set_num_threads(2)

RATE = 44100
CHILDREN = {"serve.upload": "serve.enqueue", "serve.launch": "serve.enqueue",
            "serve.download": "serve.enqueue",
            "serve.drain_wait": "serve.drain", "serve.send": "serve.write",
            "serve.gather_halo": "serve.gather",
            "serve.upload_halo": "serve.upload",
            "serve.upload_input": "serve.upload"}


def _filter(taps=33, fft=256, ratio=4, seed=5):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=taps) * np.exp(-np.arange(taps) * 3.0 / taps)
    return LoadedFilter(
        taps=h.astype(np.float32),
        sidecar=FilterSidecar(
            coefficients_bin="<test>", taps=taps, fft_size=fft,
            block_size=fft - (taps - 1), upsample_factor=ratio))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _roundtrip(port, x, out, i):
    with ServeClient(f"tcp://127.0.0.1:{port}", 2, RATE,
                     timeout_s=60) as c:
        def pump():
            for k in range(0, x.shape[1], 997):
                c.send(x[:, k:k + 997])
            c.end_input()

        t = threading.Thread(target=pump)
        t.start()
        parts = []
        while (y := c.read_frames()) is not None:
            parts.append(y)
        t.join(timeout=60)
    out[i] = np.concatenate(parts, axis=1)


@pytest.fixture(scope="module")
def served():
    """Two clients served with spans on from before the first step:
    (server, spans snapshot, the slots' latencies, replies)."""
    port = _free_port()
    srv = serve.StreamServer(_filter(), f"tcp-listen://127.0.0.1:{port}",
                             RATE, max_streams=4, channels=2, device="cpu")
    srv.start()
    try:
        srv.spans.start()
        rng = np.random.default_rng(1)
        xs = [(rng.normal(size=(2, 12000 + 3000 * i)) * 0.3)
              .astype(np.float32) for i in range(2)]
        out = [None, None]
        threads = [threading.Thread(target=_roundtrip, args=(port, x, out, i))
                   for i, x in enumerate(xs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert all(o is not None for o in out)
    finally:
        srv.stop()
    srv.spans.stop()
    lat = np.concatenate([np.asarray(s.lat_ms) for s in srv.slots])
    return srv, srv.spans.snapshot(), lat, (xs, out)


def _named(snap):
    return np.array([snap["names"][i] for i in snap["name"]])


def test_every_step_has_gather_enqueue_and_drain(served):
    srv, snap, _lat, _io = served
    names = _named(snap)
    assert snap["dropped"] == 0 and snap["open"] == 0
    steps = set(snap["key"][names == "serve.enqueue"].tolist())
    assert len(steps) == srv.stats.steps > 0
    for name in ("serve.gather", "serve.drain", "serve.upload",
                 "serve.launch", "serve.download", "serve.drain_wait",
                 "serve.gather_halo", "serve.upload_halo",
                 "serve.upload_input"):
        assert steps <= set(snap["key"][names == name].tolist()), name
    # No device PCM here: nothing quantizes on the device.
    assert "serve.quantize" not in set(names.tolist())
    assert {"serve.wait_input", "serve.housekeeping"} <= set(names.tolist())


def test_children_lie_inside_their_parents(served):
    _srv, snap, _lat, _io = served
    names = _named(snap)
    at = {int(n): i for i, n in enumerate(snap["num"])}
    for i, name in enumerate(names):
        parent = int(snap["parent"][i])
        if name not in CHILDREN:
            assert parent == -1, name
            continue
        p = at[parent]
        assert names[p] == CHILDREN[name]
        assert snap["tid"][p] == snap["tid"][i]
        assert (snap["key"][p], snap["gen"][p]) == (snap["key"][i],
                                                    snap["gen"][i])
        assert snap["t0"][p] <= snap["t0"][i] <= snap["t1"][i] \
            <= snap["t1"][p]
    wall = snap["t1"] - snap["t0"]
    assert (snap["cpu"] <= wall).all()


def test_drain_waits_sum_to_the_drain_counter(served):
    srv, snap, _lat, _io = served
    names = _named(snap)
    waits = snap["t1"][names == "serve.drain_wait"] \
        - snap["t0"][names == "serve.drain_wait"]
    assert int(waits.sum()) * 1e-9 == pytest.approx(srv.stats.drain_wall_s,
                                                    rel=1e-9, abs=1e-12)


def test_readers_and_writers_record_their_slot(served):
    _srv, snap, _lat, (xs, out) = served
    names = _named(snap)
    for name in ("serve.read", "serve.write", "serve.send"):
        keys = snap["key"][names == name]
        gens = snap["gen"][names == name]
        assert keys.size and (keys >= 0).all() and (gens >= 1).all(), name
    # Each stream's threads run on their own slot.
    assert len(set(snap["key"][names == "serve.write"].tolist())) == 2
    for x, y in zip(xs, out):
        assert y.shape == (2, x.shape[1] * 4)


def test_histogram_counts_every_block_within_a_bucket(served):
    srv, _snap, lat, _io = served
    counts = srv.stats.block_latency
    assert sum(counts) == lat.size > 0
    edges = serve.LATENCY_EDGES_MS
    for q in (50, 95, 99):
        got = serve.latency_quantile(counts, q / 100, float(lat.max()))
        want = float(np.percentile(lat, q))
        assert abs(bisect.bisect_right(edges, got * (1 - 1e-12))
                   - bisect.bisect_right(edges, want)) <= 1, q
    j = srv.stats.to_json(0, [])["block_latency_ms"]
    assert j["count"] == lat.size
    assert j["max"] == round(float(lat.max()), 3)
    assert j["p50"] <= j["p95"] <= j["p99"] <= j["max"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_quantiles_against_numpy(seed):
    rng = np.random.default_rng(seed)
    lat = rng.lognormal(mean=1.0 + seed, sigma=1.0 + 0.5 * seed, size=5000)
    stats = serve.ServeStats()
    stats.add_block_latencies(lat.tolist())
    edges = np.asarray(serve.LATENCY_EDGES_MS)
    assert edges[0] == pytest.approx(0.05) and edges[-1] == pytest.approx(6e4)
    assert (edges[1:] / edges[:-1]).max() <= 1.02
    assert sum(stats.block_latency) == lat.size
    assert stats.block_latency_max_ms == lat.max()
    for q in (50, 95, 99):
        got = serve.latency_quantile(stats.block_latency, q / 100,
                                     stats.block_latency_max_ms)
        want = float(np.percentile(lat, q))
        assert abs(np.searchsorted(edges, got * (1 - 1e-12), side="right")
                   - np.searchsorted(edges, want, side="right")) <= 1, q


def test_histogram_edges_and_empty():
    stats = serve.ServeStats()
    stats.add_block_latencies([0.01, 0.05, 59999.0, 7e4])
    counts = stats.block_latency
    assert counts[0] == 1 and counts[1] == 1 and counts[-1] == 1
    assert sum(counts) == 4
    assert serve.latency_quantile(counts, 1.0, 7e4) == 7e4
    empty = serve.ServeStats().to_json(0, [])["block_latency_ms"]
    assert empty == {"count": 0, "p50": None, "p95": None, "p99": None,
                     "max": None}
