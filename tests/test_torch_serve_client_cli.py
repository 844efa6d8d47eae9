"""The port's totton-serve-client CLI (a copy of the reference's,
``totton_tpu_torch/cli/serve_client.py``) against the port's StreamServer
on the CPU: the reference suite's CLI cases (tests/test_serve_client.py
TestCli), the same WAV through the reference CLI and the JAX server for
parity, and the repaired exit path: against a server that accepts, then
stops reading, the error exit returns well inside --timeout."""

import socket
import threading
import time

import numpy as np
import pytest

from totton_tpu.cli.serve_client import main as jax_main
from totton_tpu.serve import StreamServer as JaxStreamServer

torch = pytest.importorskip("torch")

from totton_tpu_torch.cli.serve_client import main
from totton_tpu_torch.engine.upsampler import upsample_signal
from totton_tpu_torch.filters.sidecar import FilterSidecar, LoadedFilter
from totton_tpu_torch.io.pcm import PcmFormat
from totton_tpu_torch.io.sockets import HEADER_BYTES, pack_header
from totton_tpu_torch.io.wav import read_wav, write_wav
from totton_tpu_torch.serve import StreamServer

RATE = 44100


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


@pytest.fixture()
def server():
    lf = _filter()
    port = _free_port()
    srv = StreamServer(lf, f"tcp-listen://127.0.0.1:{port}", RATE,
                       max_streams=4, channels=2, device="cpu")
    srv.start()
    yield srv, lf, port
    srv.stop()


def test_wav_through_server_to_wav(server, tmp_path):
    srv, lf, port = server
    x = (np.random.default_rng(0).normal(size=(2, 5000)) * 0.3).astype(
        np.float32)
    src = tmp_path / "in.wav"
    dst = tmp_path / "out.wav"
    write_wav(str(src), x, RATE, PcmFormat.S24_3LE)
    rc = main(["--server", f"tcp://127.0.0.1:{port}",
               "--in", str(src), "--out", str(dst), "--format", "s24"])
    assert rc == 0
    y, out_rate = read_wav(str(dst))
    assert out_rate == RATE * lf.ratio
    xs, _ = read_wav(str(src))
    ref = np.clip(upsample_signal(xs, lf, device="cpu"), -1.0,
                  PcmFormat.S24_3LE.clamp_hi)
    np.testing.assert_allclose(y, ref, rtol=1e-4, atol=2e-7 * 32)


def test_same_wav_as_the_reference_cli_and_server(tmp_path):
    """One s16 WAV through the port's CLI and server, and through the
    reference's: the same output file bytes but for at most one LSB."""
    lf = _filter()
    x = (np.random.default_rng(1).normal(size=(2, 3000)) * 0.2).astype(
        np.float32)
    src = tmp_path / "in.wav"
    write_wav(str(src), x, RATE, PcmFormat.S16_LE)
    outs = []
    for cls, run, kw in ((StreamServer, main, {"device": "cpu"}),
                         (JaxStreamServer, jax_main, {})):
        port = _free_port()
        srv = cls(lf, f"tcp-listen://127.0.0.1:{port}", RATE, max_streams=2,
                  channels=2, **kw)
        srv.start()
        try:
            dst = tmp_path / f"out_{len(outs)}.wav"
            assert run(["--server", f"tcp://127.0.0.1:{port}", "--in",
                        str(src), "--out", str(dst), "--format", "s16",
                        "--wire-format", "s16"]) == 0
        finally:
            srv.stop()
        outs.append(read_wav(str(dst)))
    (a, ra), (b, rb) = outs
    assert ra == rb == RATE * lf.ratio and a.shape == b.shape
    assert np.abs(a - b).max() * 32768 <= 1.0


def test_bad_server_exits_1(tmp_path):
    src = tmp_path / "in.wav"
    write_wav(str(src), (np.random.default_rng(2).normal(size=(2, 100))
                         * 0.3).astype(np.float32), RATE, PcmFormat.S16_LE)
    rc = main(["--server", f"tcp://127.0.0.1:{_free_port()}",
               "--in", str(src), "--out", str(tmp_path / "o.wav"),
               "--connect-window", "0.5"])
    assert rc == 1


def test_missing_rate_exits_2(server, tmp_path):
    srv, lf, port = server
    raw = tmp_path / "in.raw"
    raw.write_bytes(b"\x00" * 400)
    rc = main(["--server", f"tcp://127.0.0.1:{port}", "--in", str(raw),
               "--out", "null"])
    assert rc == 2


def _stalling_server(stop: threading.Event):
    """Accepts one stream, answers its header, sends 3 bytes (not a whole
    f32 stereo frame) and half-closes after 0.5 s, and never reads: the
    client's pump blocks in sendall once the socket buffers fill, and its
    read side fails on the trailing bytes. Returns the port."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)

    def run():
        srv.settimeout(20)
        try:
            conn, _ = srv.accept()
        except OSError:
            return
        finally:
            srv.close()
        with conn:
            got = b""
            while len(got) < HEADER_BYTES:
                got += conn.recv(HEADER_BYTES - len(got))
            conn.sendall(pack_header(None, 2, RATE * 4))
            time.sleep(0.5)
            conn.sendall(b"\x00\x01\x02")
            conn.shutdown(socket.SHUT_WR)
            stop.wait(90)

    threading.Thread(target=run, daemon=True).start()
    return srv.getsockname()[1]


def test_error_exit_does_not_wait_for_a_blocked_pump(tmp_path):
    """A server that stops reading: the read side fails at once, and the
    exit comes back in < 5 s with --timeout 60 (the reference's exit
    joins the pump first, which waits in sendall for the timeout)."""
    src = tmp_path / "in.wav"
    # 20 s of stereo: far more than the socket buffers hold.
    write_wav(str(src), np.zeros((2, 20 * RATE), np.float32), RATE,
              PcmFormat.S16_LE)
    stop = threading.Event()
    port = _stalling_server(stop)
    t0 = time.monotonic()
    try:
        rc = main(["--server", f"tcp://127.0.0.1:{port}", "--in", str(src),
                   "--out", "null", "--timeout", "60"])
    finally:
        stop.set()
    assert rc == 1
    assert time.monotonic() - t0 < 5.0
