"""The port's serve plane (totton_tpu_torch.serve) against the JAX
package's, on the CPU: each test starts the JAX StreamServer and the port's
StreamServer(device="cpu") on free ports and sends both the same seeded
client bytes. f32 replies agree at rel < 1e-5 and with the port's offline
upsample_signal; the s16 wire within one LSB. One cuda-marked test serves
on the card and skips here."""

import contextlib
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from totton_tpu.filters.sidecar import FilterSidecar, LoadedFilter, load_filter
from totton_tpu.io.pcm import (
    PcmFormat,
    deinterleave,
    float_to_pcm,
    interleave,
    pcm_to_float,
)
from totton_tpu.io.serve_client import ServeClient
from totton_tpu.serve import StreamServer as JaxStreamServer
from totton_tpu_torch.engine.upsampler import upsample_signal
from totton_tpu_torch.serve import StreamServer

torch.set_num_threads(2)

RATE = 44100
REL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S16 = PcmFormat.S16_LE


def _filter(taps=33, fft=256, ratio=4, seed=5):
    rng = np.random.default_rng(seed)
    h = (rng.normal(size=taps) * np.exp(-np.arange(taps) * 3.0 / taps))
    return LoadedFilter(
        taps=h.astype(np.float32),
        sidecar=FilterSidecar(
            coefficients_bin="<test>", taps=taps, fft_size=fft,
            block_size=fft - (taps - 1), upsample_factor=ratio,
        ),
    )


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def _servers(lf, **kw):
    """The JAX server and the port's, started on free ports with the same
    settings: yields [(server, port), (server, port)], JAX first."""
    pair = []
    try:
        for cls, extra in ((JaxStreamServer, {}),
                           (StreamServer, {"device": "cpu"})):
            port = _free_port()
            srv = cls(lf, f"tcp-listen://127.0.0.1:{port}", RATE,
                      channels=2, **kw, **extra)
            srv.start()
            pair.append((srv, port))
        yield pair
    finally:
        for srv, _ in pair:
            srv.stop()


def _roundtrip(port, x, fmt=None, chunk=997, stagger_s=0.0, eq_text=None):
    """Send [2, n] frames in chunks from a pump thread, half-close, and
    return the whole reply."""
    with ServeClient(f"tcp://127.0.0.1:{port}", x.shape[0], RATE, fmt=fmt,
                     eq_text=eq_text, timeout_s=60) as c:
        def pump():
            for i in range(0, x.shape[1], chunk):
                c.send(x[:, i:i + chunk])
                if stagger_s:
                    time.sleep(stagger_s)
            c.end_input()

        t = threading.Thread(target=pump)
        t.start()
        parts = []
        while (y := c.read_frames()) is not None:
            parts.append(y)
        t.join(timeout=60)
        assert not t.is_alive()
    return np.concatenate(parts, axis=1)


def _concurrent(port, signals, delays=None, **kw):
    """Round trips of every signal at once (stream i starts after
    delays[i] seconds); returns the replies in order."""
    out = [None] * len(signals)
    errors = []

    def run(i):
        try:
            if delays is not None:
                time.sleep(delays[i])
            out[i] = _roundtrip(port, signals[i], **kw)
        except Exception as e:  # re-raised below
            errors.append((i, e))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(signals))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    return out


def _rel(a, b) -> float:
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _s16_roundtrip(a):
    return deinterleave(pcm_to_float(float_to_pcm(interleave(a), S16), S16),
                        a.shape[0])


def _wait(get, target, timeout=30):
    deadline = time.monotonic() + timeout
    while get() < target:
        assert time.monotonic() < deadline, f"never reached {target}"
        time.sleep(0.01)


@pytest.mark.parametrize("n_blocks, extra", [(0, 5000), (3, 0)])
def test_round_trip_f32_matches_jax_and_offline(rng, n_blocks, extra):
    lf = _filter()
    with _servers(lf, max_streams=4) as pair:
        n = n_blocks * pair[1][0].config.block_in + extra
        x = (rng.normal(size=(2, n)) * 0.3).astype(np.float32)
        yj, yp = (_roundtrip(port, x) for _, port in pair)
    assert _rel(yp, yj) < REL
    assert _rel(yp, upsample_signal(x, lf, device="cpu")) < REL


def test_s16_wire_within_one_lsb(rng):
    lf = _filter()
    x = (rng.normal(size=(2, 2000)) * 0.3).astype(np.float32)
    with _servers(lf, max_streams=4) as pair:
        yj, yp = (_roundtrip(port, x, fmt=S16) for _, port in pair)
    ref = _s16_roundtrip(upsample_signal(_s16_roundtrip(x), lf,
                                         device="cpu"))
    assert yp.shape == yj.shape == ref.shape
    assert np.abs(yp - yj).max() <= 1.01 / 32768
    assert np.abs(yp - ref).max() <= 1.01 / 32768


def test_concurrent_streams_isolated_and_bursty_batches(rng):
    """8 concurrent streams of different lengths on 8 slots, plus a
    bursty client afterwards: every reply equals the JAX server's and its
    own offline reference, and the burst ran multi-block steps."""
    lf = _filter()
    signals = [(rng.normal(size=(2, 3000 + 417 * i)) * 0.3)
               .astype(np.float32) for i in range(8)]
    with _servers(lf, max_streams=8, max_blocks_per_step=8) as pair:
        block_in = pair[1][0].config.block_in
        burst = (rng.normal(size=(2, 64 * block_in)) * 0.3).astype(np.float32)
        replies = []
        for srv, port in pair:
            ys = _concurrent(port, signals, stagger_s=0.002)
            ys.append(_roundtrip(port, burst, chunk=burst.shape[1]))
            replies.append(ys)
        port_srv = pair[1][0]
        with port_srv.stats.lock:
            shapes = dict(port_srv.stats.steps_by_shape)
        assert port_srv.stats.accepted == 9
    for i, x in enumerate(signals + [burst]):
        assert _rel(replies[1][i], replies[0][i]) < REL, i
        assert _rel(replies[1][i], upsample_signal(x, lf, device="cpu")) < REL
    assert any(int(key.split("x")[1]) > 1 for key in shapes), shapes


def test_width_transitions_stay_isolated(rng):
    """12 staggered clients on 16 slots cross the 8/16 slot widths."""
    lf = _filter()
    signals = [(rng.normal(size=(2, 2500 + 311 * i)) * 0.3)
               .astype(np.float32) for i in range(12)]
    delays = [0.015 * i for i in range(12)]
    with _servers(lf, max_streams=16, max_blocks_per_step=4) as pair:
        replies = [_concurrent(port, signals, delays, chunk=701,
                               stagger_s=0.002) for _, port in pair]
        assert pair[1][0]._slot_widths == [8, 16]
    for i, x in enumerate(signals):
        assert _rel(replies[1][i], replies[0][i]) < REL, i
        assert _rel(replies[1][i], upsample_signal(x, lf, device="cpu")) < REL


def test_per_stream_eq_matches_sos_oracle(rng):
    from scipy.signal import sosfilt

    from totton_tpu_torch.eq.apo import parse_eq_string
    from totton_tpu_torch.serve import _profile_to_sos

    lf = _filter()
    eq = "Preamp: -3 dB\nFilter 1: ON PK Fc 1000 Hz Gain 6 dB Q 1.0\n"
    x = (rng.normal(size=(2, 4000)) * 0.2).astype(np.float32)
    with _servers(lf, max_streams=4) as pair:
        yj, yp = (_roundtrip(port, x, eq_text=eq) for _, port in pair)
    sos, preamp = _profile_to_sos(parse_eq_string(eq), RATE)
    xf, _ = sosfilt(sos, x, axis=1, zi=np.zeros((sos.shape[0], 2, 2)))
    ref = upsample_signal(xf.astype(np.float32) * np.float32(preamp), lf,
                          device="cpu")
    assert _rel(yp, yj) < REL
    assert _rel(yp, ref) < REL


def _staged(srv, port, p1, p2, between, fmt=None):
    """Send p1, read its whole reply, run between(), send p2, half-close;
    returns (reply to p1, reply to p2)."""
    ratio = srv.config.ratio
    with ServeClient(f"tcp://127.0.0.1:{port}", 2, RATE, fmt=fmt,
                     timeout_s=60) as c:
        c.send(p1)
        first, got = [], 0
        while got < p1.shape[1] * ratio:
            y = c.read_frames()
            assert y is not None, "server closed early"
            first.append(y)
            got += y.shape[1]
        between(srv)
        c.send(p2)
        c.end_input()
        rest = []
        while (y := c.read_frames()) is not None:
            rest.append(y)
    return np.concatenate(first, axis=1), np.concatenate(rest, axis=1)


FADE = 500


@pytest.mark.parametrize("swap", ["set_eq", "load_filter"])
def test_live_swap_crossfades_exactly(rng, swap):
    lf, lf2 = _filter(), _filter(seed=11)
    with _servers(lf, max_streams=4, swap_fade_frames=FADE) as pair:
        block_in = pair[1][0].config.block_in
        n_bins = pair[1][0].config.n_bins
        eq = np.linspace(0.4, 1.2, n_bins)
        p1 = (rng.normal(size=(2, 4 * block_in)) * 0.3).astype(np.float32)
        p2 = (rng.normal(size=(2, 6 * block_in)) * 0.3).astype(np.float32)

        def between(srv):
            if swap == "set_eq":
                srv.set_eq(eq)
            else:
                srv.load_filter(lf2)
            _wait(lambda: srv.stats.spectrum_swaps, 1)

        (j1, j2), (y1, y2) = (_staged(srv, port, p1, p2, between)
                              for srv, port in pair)
        if swap == "load_filter":
            assert pair[1][0].filter is lf2
    x = np.concatenate([p1, p2], axis=1)
    n1 = p1.shape[1] * lf.ratio
    old = upsample_signal(x, lf, device="cpu")
    new = (upsample_signal(x, lf, eq_response=eq, device="cpu")
           if swap == "set_eq" else upsample_signal(x, lf2, device="cpu"))
    ramp = np.arange(FADE, dtype=np.float32) / FADE
    expect = new[:, n1:].copy()
    expect[:, :FADE] = (old[:, n1:n1 + FADE] * (1.0 - ramp)
                        + new[:, n1:n1 + FADE] * ramp)
    assert _rel(y1, old[:, :n1]) < REL
    assert _rel(y2, expect) < REL
    assert _rel(y1, j1) < REL and _rel(y2, j2) < REL
    assert not np.allclose(old[:, n1 + FADE:], new[:, n1 + FADE:])


def test_geometry_mismatch_rejected_live():
    with _servers(_filter(), max_streams=4) as pair:
        other = _filter(taps=17, fft=128, ratio=2, seed=3)
        for srv, _ in pair:
            with pytest.raises(ValueError, match="geometry"):
                srv.load_filter(other)


def test_soft_reset_zeroes_stream_history(rng):
    lf = _filter()
    with _servers(lf, max_streams=4) as pair:
        block_in = pair[1][0].config.block_in
        p1 = (rng.normal(size=(2, 3 * block_in)) * 0.3).astype(np.float32)
        p2 = (rng.normal(size=(2, 2 * block_in)) * 0.3).astype(np.float32)

        def between(srv):
            srv.soft_reset()
            _wait(lambda: srv.stats.soft_resets, 1)

        (_, j2), (_, y2) = (_staged(srv, port, p1, p2, between)
                            for srv, port in pair)
    assert _rel(y2, upsample_signal(p2, lf, device="cpu")) < REL
    assert _rel(y2, j2) < REL


def test_device_pcm_fade_step_bit_exact_with_host_twin(rng):
    """Device PCM through a live swap: the port's replies equal, byte for
    byte, the same server's replies with host quantization (device_pcm
    off, s16 wire) — the device quantize on plain steps and the host twin
    on fade steps — and stay within one LSB of the JAX server's."""
    lf = _filter()
    p1 = (rng.normal(size=(2, 2 * 56)) * 0.3).astype(np.float32)
    p2 = (rng.normal(size=(2, 4 * 56)) * 0.3).astype(np.float32)
    eq = np.linspace(0.5, 1.4, 129)

    def between(srv):
        srv.set_eq(eq)
        _wait(lambda: srv.stats.spectrum_swaps, 1)

    replies = {}
    for device_pcm in (True, False):
        with _servers(lf, max_streams=4, swap_fade_frames=300,
                      device_pcm=device_pcm) as pair:
            assert pair[1][0].config.block_in == 56
            for name, (srv, port) in zip(("jax", "port"), pair):
                replies[name, device_pcm] = np.concatenate(
                    _staged(srv, port, p1, p2, between, fmt=S16), axis=1)
    assert np.array_equal(replies["port", True], replies["port", False])
    assert np.abs(replies["port", True]
                  - replies["jax", True]).max() <= 1.01 / 32768


def test_persistent_step_fault_stops_server(rng):
    lf = _filter()
    port = _free_port()
    srv = StreamServer(lf, f"tcp-listen://127.0.0.1:{port}", RATE,
                       max_streams=2, channels=2, device="cpu")
    srv.start()
    try:
        def always_failing(t, x, b):
            raise RuntimeError("injected persistent fault")

        srv._step = always_failing
        x = (rng.normal(size=(2, 5 * srv.config.block_in)) * 0.3
             ).astype(np.float32)
        for _ in range(5):
            try:
                with ServeClient(f"tcp://127.0.0.1:{port}", 2, RATE,
                                 timeout_s=5) as c:
                    c.send(x)
                    c.end_input()
                    while c.read_frames() is not None:
                        pass
            except OSError:
                pass
            if srv.stopped:
                break
        assert srv._stop.wait(timeout=30), "server never stopped"
        assert srv.failed
    finally:
        srv.stop()


def test_low_latency_bank_serves_exact(rng):
    lf = load_filter(os.path.join(REPO, "data", "coefficients",
                                  "filter_44k_16x_8000_min_phase.json"))
    with _servers(lf, max_streams=2, max_blocks_per_step=2) as pair:
        n = 3 * pair[1][0].config.block_in + 101
        x = (rng.normal(size=(2, n)) * 0.3).astype(np.float32)
        yj, yp = (_roundtrip(port, x) for _, port in pair)
    assert _rel(yp, yj) < REL
    assert _rel(yp, upsample_signal(x, lf, device="cpu")) < REL


def test_cuda_server_refused_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamServer(_filter(), "tcp-listen://127.0.0.1:0", RATE,
                     device="cuda")


@pytest.mark.cuda
def test_cuda_serves_two_streams_through_the_kernel(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the frame kernel has no CPU mode")
    from totton_tpu_torch.ops import fused_frames as ff

    lf = load_filter(os.path.join(REPO, "data", "coefficients",
                                  "filter_44k_16x_8000_min_phase.json"))
    port = _free_port()
    srv = StreamServer(lf, f"tcp-listen://127.0.0.1:{port}", RATE,
                       max_streams=8, channels=2, device="cuda")
    srv.start()
    try:
        before = ff.LAUNCHES
        signals = [(rng.normal(size=(2, 20000 + 3001 * i)) * 0.3)
                   .astype(np.float32) for i in range(2)]
        replies = _concurrent(port, signals, chunk=4096)
        assert ff.LAUNCHES > before
        assert not srv.failed
    finally:
        srv.stop()
    for x, y in zip(signals, replies):
        assert _rel(y, upsample_signal(x, lf, device="cuda")) < REL
