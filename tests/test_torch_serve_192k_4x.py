"""192 kHz input served 4x to 768 kHz on the 48k family's 80k bank
(``portbench/configs/serve_4x_80k_192k_f32.json``, the benchmark's
``serve4x192k.live``), on the CPU: the flags resolve to the bank through
``cli/serve.py``'s own path and its replies agree with the benchmark's
float64 reference; the frame kernel takes its four-launch plan there, with
16x/80k's inverse; the cell offers the load its configuration says."""

import copy
import socket
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from portbench import audio, reference, run
from totton_tpu_torch import serve
from totton_tpu_torch.engine.selector import resolve_filter_path
from totton_tpu_torch.filters.sidecar import (
    FilterSidecar,
    LoadedFilter,
    load_filter,
)
from totton_tpu_torch.io.serve_client import ServeClient
from totton_tpu_torch.ops import fused_frames
from totton_tpu_torch.ops.overlap_save import OverlapSaveConfig

torch.set_num_threads(2)

CELL = "serve4x192k.live"
#: the configuration's comparison limit: on the card the program reads
#: 5.3e-07-6.5e-07 of the peak at this bank, and the reference with its
#: operands rounded to TF32 (10 mantissa bits) 6.6e-04 (PERF.md section
#: 2), so the limit lies two orders above the one and an order below the
#: other; the random bank's shorter FFTs round less
MAX_REL = 5e-05


def _config() -> dict:
    return copy.deepcopy(run.load_cell(CELL)["config"])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _bank_server(port: int):
    """The configuration's own server (``run.build_server``: the filter
    resolved from rate, ratio and latency, then loaded) on the CPU, at
    two slots and two blocks a step: its warm-up runs every step shape,
    and 64 slots of 16 blocks at fft 131072 do not fit a test."""
    config = _config()
    config["serve_flags"].update(max_streams=2, max_blocks_per_step=2)
    srv, path = run.build_server(config, run.ROOT, "cpu", port)
    taps, meta = reference.read_taps(path)
    return srv, taps, meta["block_size"] // meta["upsample_factor"]


def _random_server(port: int):
    """A ratio-4 bank of 2001 seeded random taps (fft 4096) under the
    configuration's flags: every block and halo boundary of the 80k
    bank's path, a hundred times faster."""
    taps, fft = 2001, 4096
    rng = np.random.default_rng(192)
    h = (rng.normal(size=taps) * np.exp(-np.arange(taps) * 4.0 / taps)
         ).astype(np.float32)
    loaded = LoadedFilter(taps=h, sidecar=FilterSidecar(
        coefficients_bin="<test>", taps=taps, fft_size=fft,
        block_size=fft - (taps - 1), upsample_factor=4))
    flags = _config()["serve_flags"]
    srv = serve.StreamServer(
        loaded, f"tcp-listen://127.0.0.1:{port}", flags["rate"],
        max_streams=2, channels=flags["channels"], max_blocks_per_step=2,
        max_input_backlog_blocks=flags["max_input_backlog"],
        swap_fade_frames=flags["swap_fade"], device_pcm=flags["device_pcm"],
        device="cpu")
    return srv, h.astype(np.float64), (fft - (taps - 1)) // 4


def _stream(port, seed, n, out, i):
    """One client: the stream's seeded audio in 1024-frame periods, then
    EOF, its whole reply read."""
    x = audio.frames(seed, 0, n, 2)
    with ServeClient(f"tcp://127.0.0.1:{port}", 2, 192000,
                     timeout_s=120) as c:
        def pump():
            for k in range(0, n, 1024):
                c.send(x[:, k:k + 1024])
            c.end_input()

        t = threading.Thread(target=pump)
        t.start()
        parts = []
        while (y := c.read_frames()) is not None:
            parts.append(y)
        t.join(timeout=120)
    out[i] = np.concatenate(parts, axis=1)


@pytest.mark.parametrize("make", [_bank_server, _random_server],
                         ids=["filter_48k_4x_80000_min_phase", "random_2001"])
def test_two_streams_match_the_reference(make):
    port = _free_port()
    srv, taps, block_in = make(port)
    srv.start()
    seeds = [audio.stream_seed(2**31 + 192, i) for i in range(2)]
    # Two whole blocks and an EOF partial block each, of other lengths.
    sizes = [2 * block_in + block_in // 3, 2 * block_in + block_in // 2 + 7]
    out = [None, None]
    try:
        threads = [threading.Thread(target=_stream,
                                    args=(port, s, n, out, i))
                   for i, (s, n) in enumerate(zip(seeds, sizes))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    finally:
        srv.stop()
    ref = reference.Reference(taps, 4, 2, "f32")
    control = reference.Reference(taps, 4, 2, "f32", precision="tf32")
    items = [(s, 0, 4 * n) for s, n in zip(seeds, sizes)]
    want, tf32 = ref.segments(items), control.segments(items)
    for got, w in zip(out, want):
        assert got.shape == (2, w.shape[0])
    got_rel = max(float(np.abs(g.T - w).max()) for g, w in zip(out, want)) \
        / max(float(np.abs(w).max()) for w in want)
    tf32_rel = max(float(np.abs(c - w).max()) for c, w in zip(tf32, want)) \
        / max(float(np.abs(w).max()) for w in want)
    assert got_rel < MAX_REL
    # The limit is tight enough that one precision below float32 fails it.
    assert tf32_rel > MAX_REL
    assert srv.stats.steps > 0


def test_flags_resolve_to_the_bank_and_its_four_launch_plan():
    flags = _config()["serve_flags"]
    path = resolve_filter_path(
        filter_path=None, filter_dir=str(run.ROOT / flags["filter_dir"]),
        phase="minimum", ratio=flags["ratio"], input_rate=flags["rate"],
        latency=flags["latency"])
    assert path.endswith("filter_48k_4x_80000_min_phase.json")
    cfg = OverlapSaveConfig.from_sidecar(load_filter(path).sidecar)
    assert (cfg.frame_in, cfg.block_in, cfg.halo_in) == (32768, 12768, 20000)
    plan = fused_frames.kernel_plan(cfg)
    assert plan["resident"] is False and plan["fused"] is False
    assert plan["P"] * plan["Q"] == 32768
    assert all(fused_frames.STAGE_MIN <= s <= fused_frames.STAGE_MAX
               for s in (plan["P"], plan["Q"]))
    assert plan["P2"] * plan["Q2"] == 65536
    main = fused_frames.kernel_plan(OverlapSaveConfig.from_sidecar(
        load_filter(str(run.ROOT / flags["filter_dir"]
                        / "filter_44k_16x_80000_min_phase.json")).sidecar))
    assert main["fused"] is True
    inverse = ("h", "P2", "Q2", "kept", "k2_0", "j0", "block")
    assert {k: plan[k] for k in inverse} == {k: main[k] for k in inverse}


def test_cell_offers_its_load():
    cell = run.load_cell(CELL)
    assert cell["workload"]["chips"] == 1
    clients = run.clients_of(cell["traffic"], cell["workload"]["config"])
    assert clients >= 1
    # Each stream sends 192 kHz of two channels, answered 4x.
    assert run.offered_samples_per_s(cell["config"], clients) \
        == clients * 2 * 192_000 * 4
    assert cell["traffic"]["period_frames"] == 1024
    names = {m["name"] for m in run.metrics_of(cell, trace=True)}
    assert {"fused_frames.forward_roofline", "serve.halo_ms"} <= names
