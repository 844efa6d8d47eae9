"""The port's serving plane under tests/test_serve_chaos.py's adversarial
client mix: both seeds, the same mix, duration and gates, on the port's
StreamServer(device="cpu"). Normal streams, mid-stream aborts, header-only
connects, wrong-rate rejects and non-reading floods run under live EQ swaps
and a soft reset; afterwards every slot is released, the stats add up, and
a fresh stream is exact against the port's offline upsample_signal, which
is itself held to the JAX package's on the same input (rel < 1e-5)."""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from totton_tpu.engine.upsampler import upsample_signal as jax_upsample
from totton_tpu_torch.engine.upsampler import upsample_signal
from totton_tpu_torch.filters.sidecar import FilterSidecar, LoadedFilter
from totton_tpu_torch.serve import StreamServer

from test_serve import RATE, _client_roundtrip
from test_serve_chaos import (
    _behave_abort,
    _behave_flood,
    _behave_silent,
    _behave_wrong_rate,
)
from test_torch_stream_cli import _port_below_ephemeral

torch.set_num_threads(2)


def _filter(taps=33, fft=256, ratio=4, seed=5):
    """tests/test_serve.py's toy serve filter, as the port's LoadedFilter."""
    rng = np.random.default_rng(seed)
    h = (rng.normal(size=taps) * np.exp(-np.arange(taps) * 3.0 / taps))
    return LoadedFilter(
        taps=h.astype(np.float32),
        sidecar=FilterSidecar(
            coefficients_bin="<test>", taps=taps, fft_size=fft,
            block_size=fft - (taps - 1), upsample_factor=ratio,
        ),
    )


def _offline(x, lf):
    """The port's offline output, held to the JAX package's."""
    y = upsample_signal(x, lf, device="cpu")
    ref = np.asarray(jax_upsample(x, lf))
    assert np.abs(y - ref).max() / np.abs(ref).max() < 1e-5
    return y


def _behave_normal(port, lf, rng, errors, check_content=True):
    x = (rng.normal(size=(2, int(rng.integers(500, 4000)))) * 0.3
         ).astype(np.float32)
    try:
        y, _ = _client_roundtrip(port, x)
    except AssertionError:
        return  # rejected (all slots busy) — legitimate under chaos load
    if y.shape != (2, x.shape[1] * lf.ratio) or not np.all(np.isfinite(y)):
        errors.append(("normal stream structural failure", x.shape, y.shape))
        return
    if check_content:
        ref = upsample_signal(x, lf, device="cpu")
        if not np.allclose(y, ref, rtol=1e-5, atol=1e-6):
            errors.append(("normal stream mismatch", x.shape))


def test_chaos_mix_leaves_server_consistent(rng):
    lf = _filter()
    port = _port_below_ephemeral()
    srv = StreamServer(lf, f"tcp-listen://127.0.0.1:{port}", RATE,
                       max_streams=6, channels=2, swap_fade_frames=200,
                       max_input_backlog_blocks=16,
                       header_timeout_s=2.0, device="cpu")
    srv.start()
    errors: list = []
    try:
        seed = np.random.default_rng(42)
        threads = []
        behaviors = []
        for i in range(22):
            r = np.random.default_rng(1000 + i)
            kind = seed.integers(0, 10)
            if kind < 4:
                # Live swaps run concurrently, so mid-chaos content is
                # spectrum-dependent by design; check structure only.
                t = threading.Thread(target=_behave_normal,
                                     args=(port, lf, r, errors, False))
                behaviors.append("normal")
            elif kind < 6:
                t = threading.Thread(target=_behave_abort,
                                     args=(port, r, errors))
                behaviors.append("abort")
            elif kind < 7:
                t = threading.Thread(target=_behave_silent,
                                     args=(port, errors))
                behaviors.append("silent")
            elif kind < 8:
                t = threading.Thread(target=_behave_wrong_rate,
                                     args=(port, errors))
                behaviors.append("wrong_rate")
            else:
                t = threading.Thread(target=_behave_flood,
                                     args=(port, r, errors))
                behaviors.append("flood")
            threads.append(t)

        controls_done = threading.Event()

        def control_chaos():
            r = np.random.default_rng(7)
            for _ in range(4):
                time.sleep(float(r.uniform(0.3, 0.8)))
                srv.set_eq(np.linspace(float(r.uniform(0.5, 0.9)),
                                       float(r.uniform(1.0, 1.4)),
                                       srv.config.n_bins))
            srv.soft_reset()
            controls_done.set()

        ct = threading.Thread(target=control_chaos)
        ct.start()
        for i, t in enumerate(threads):
            t.start()
            time.sleep(float(seed.uniform(0.0, 0.12)))
        for t in threads:
            t.join(timeout=120)
        ct.join(timeout=120)
        assert controls_done.is_set()
        assert not errors, (errors, behaviors)

        # Every slot must eventually recycle (no leaked pending steps,
        # no stuck detached slots).
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            with srv._slot_lock:
                free = len(srv._free)
            if free == 6:
                break
            time.sleep(0.1)
        with srv._slot_lock:
            assert len(srv._free) == 6, (
                len(srv._free),
                [(s.index, s.detached, s.pending_steps, s.sock is not None)
                 for s in srv.slots])
        for s in srv.slots:
            assert s.pending_steps == 0

        # Restore the clean spectrum, then a fresh stream must be EXACT
        # (new attachments start unfaded on the current spectrum).
        swaps_before = srv.stats.spectrum_swaps
        srv.set_eq(None)
        deadline = time.monotonic() + 30
        while (srv.stats.spectrum_swaps <= swaps_before
               and time.monotonic() < deadline):
            time.sleep(0.02)
        x = (rng.normal(size=(2, 2500)) * 0.3).astype(np.float32)
        y, _ = _client_roundtrip(port, x)
        np.testing.assert_allclose(y, _offline(x, lf), rtol=1e-5, atol=1e-6)
        # Stats coherent: accepted streams all finished or were cut.
        assert srv.stats.accepted >= behaviors.count("normal")
        assert srv.stats.rejected >= behaviors.count("wrong_rate")
    finally:
        srv.stop()


def test_chaos_repeat_different_seed(rng):
    """Second mix, different interleaving — chaos tests earn their keep
    through variety."""
    lf = _filter()
    port = _port_below_ephemeral()
    srv = StreamServer(lf, f"tcp-listen://127.0.0.1:{port}", RATE,
                       max_streams=4, channels=2,
                       max_input_backlog_blocks=16, device="cpu")
    srv.start()
    errors: list = []
    try:
        threads = []
        for i in range(16):
            r = np.random.default_rng(5000 + i)
            t = threading.Thread(
                target=[_behave_normal, _behave_abort, _behave_flood][i % 3],
                args=((port, lf, r, errors) if i % 3 == 0
                      else (port, r, errors)))
            threads.append(t)
            t.start()
            time.sleep(0.05)
        for t in threads:
            t.join(timeout=120)
        assert not errors, errors
        # Wait for cut/aborted slots to recycle before the final client.
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            with srv._slot_lock:
                if len(srv._free) == 4:
                    break
            time.sleep(0.1)
        x = (rng.normal(size=(2, 1800)) * 0.3).astype(np.float32)
        y, _ = _client_roundtrip(port, x)
        np.testing.assert_allclose(y, _offline(x, lf), rtol=1e-5, atol=1e-6)
    finally:
        srv.stop()


def test_cut_stream_leaves_no_pre_swap_bundle():
    """A stream cut while its swap fade is armed (no step ran for it after
    the swap) holds no reference to the pre-swap bundle once its slot is
    released, so a cut stream leaves no device buffer behind
    (chip_smoke.chaos_run holds device memory to within one bundle of its
    start; ROADMAP C21)."""
    import socket
    import struct

    from totton_tpu_torch.io.pcm import interleave
    from totton_tpu_torch.io.sockets import HEADER_BYTES, pack_header

    lf = _filter()
    port = _port_below_ephemeral()
    srv = StreamServer(lf, f"tcp-listen://127.0.0.1:{port}", RATE,
                       max_streams=2, channels=2, swap_fade_frames=200,
                       device="cpu")
    srv.start()
    try:
        s = socket.create_connection(("127.0.0.1", port), timeout=30)
        s.sendall(pack_header(None, 2, RATE))
        hdr = b""
        while len(hdr) < HEADER_BYTES:
            hdr += s.recv(HEADER_BYTES - len(hdr))
        # Less than one block: no step runs for this stream.
        s.sendall(interleave(np.zeros((2, 10), np.float32)).astype(
            "<f4").tobytes())
        deadline = time.monotonic() + 30
        while not any(slot.sock is not None for slot in srv.slots):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        srv.set_eq(np.linspace(0.5, 1.2, srv.config.n_bins))
        while srv.stats.spectrum_swaps < 1:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert any(slot.fade_from is not None for slot in srv.slots)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                     struct.pack("ii", 1, 0))
        s.close()  # RST: the stream is cut
        while True:
            with srv._slot_lock:
                if len(srv._free) == 2:
                    break
            assert time.monotonic() < deadline, "the slot was never freed"
            time.sleep(0.01)
        assert [slot.fade_from for slot in srv.slots] == [None, None]
    finally:
        srv.stop()
