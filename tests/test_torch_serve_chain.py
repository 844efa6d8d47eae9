"""The port's serve output piped into a crossfeed stage in another
process: tests/test_serve_chain.py's case with the port's StreamServer
(device="cpu") and a ``python -m totton_tpu_torch.cli.stream --device
cpu`` stage, at the same tolerance, and the oracle held to the JAX
package's offline upsample + crossfeed on the same seeded input
(rel < 1e-5)."""

import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from totton_tpu.engine.crossfeed import CrossfeedFilter as JaxCfFilter
from totton_tpu.engine.crossfeed import crossfeed_signal as jax_crossfeed
from totton_tpu.engine.upsampler import upsample_signal as jax_upsample
from totton_tpu_torch.engine.chain import CrossfeedChain
from totton_tpu_torch.engine.crossfeed import (
    CrossfeedFilter,
    CrossfeedProcessor,
    crossfeed_signal,
)
from totton_tpu_torch.engine.upsampler import StreamingUpsampler, upsample_signal
from totton_tpu_torch.filters.hrtf import generate_all
from totton_tpu_torch.filters.sidecar import FilterSidecar, LoadedFilter
from totton_tpu_torch.io.pcm import PcmFormat, interleave, pcm_to_float
from totton_tpu_torch.io.sockets import HEADER_BYTES, pack_header
from totton_tpu_torch.serve import StreamServer

from test_torch_serve_chaos import RATE, _filter
from test_torch_stream_cli import _port_below_ephemeral

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _identity_filter() -> LoadedFilter:
    """The ratio-1 passthrough cli/stream.py builds for --ratio 1."""
    taps = np.zeros(1025, dtype=np.float32)
    taps[0] = 1.0
    return LoadedFilter(
        taps=taps,
        sidecar=FilterSidecar(
            coefficients_bin="<identity>", taps=1025, fft_size=4096,
            block_size=4096 - 1024, upsample_factor=1))


def test_serve_output_chains_into_crossfeed_stage(tmp_path, rng):
    lf = _filter()  # ratio 4: serve 44100 -> 176400
    cf_path = generate_all(tmp_path, sizes=["M"], families=["44k"])[0]
    cf = CrossfeedFilter.load(cf_path)
    out_rate = RATE * lf.ratio

    serve_port = _port_below_ephemeral()
    srv = StreamServer(lf, f"tcp-listen://127.0.0.1:{serve_port}", RATE,
                       max_streams=2, channels=2, device="cpu")
    srv.start()
    stage_port = _port_below_ephemeral()
    out_raw = tmp_path / "crossfed.raw"
    env = {k: v for k, v in os.environ.items() if k != "TOTTON_PLATFORM"}
    stage = subprocess.Popen(
        [sys.executable, "-m", "totton_tpu_torch.cli.stream",
         "--device", "cpu",
         "--in", f"tcp-listen://127.0.0.1:{stage_port}",
         "--out-file", str(out_raw), "--rate", str(out_rate),
         "--ratio", "1", "--crossfeed", str(cf_path),
         "--swap-fade", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO)
    try:
        n = 5200
        x = (rng.normal(size=(2, n)) * 0.3).astype(np.float32)
        # Keep the chain inside PCM full scale: the stage's s32 file sink
        # clamps at +-1 (reference conversion semantics), while the toy
        # serve filter has arbitrary gain — scale the linear system's
        # input so the oracle peaks at 0.9.
        peak = float(np.max(np.abs(crossfeed_signal(
            upsample_signal(x, lf, device="cpu"), cf, device="cpu"))))
        x = (x * (0.9 / peak)).astype(np.float32)

        # Client leg: stream x through the serve plane.
        s = socket.create_connection(("127.0.0.1", serve_port), timeout=60)
        s.settimeout(60)
        s.sendall(pack_header(None, 2, RATE))

        def pump():
            s.sendall(interleave(x).astype("<f4").tobytes())
            s.shutdown(socket.SHUT_WR)

        t = threading.Thread(target=pump)
        t.start()
        reply = bytearray()
        while True:
            got = s.recv(65536)
            if not got:
                break
            reply += got
        t.join(timeout=60)
        s.close()
        assert len(reply) == HEADER_BYTES + n * lf.ratio * 2 * 4

        # Forward the serve reply VERBATIM (header included) into the
        # crossfeed stage — it is already a valid totton wire stream.
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            try:
                fwd = socket.create_connection(
                    ("127.0.0.1", stage_port), timeout=2)
                break
            except OSError:
                time.sleep(0.2)
        else:
            raise AssertionError(
                f"stage never listened: {stage.stdout.read()}")
        fwd.sendall(bytes(reply))
        fwd.shutdown(socket.SHUT_WR)
        fwd.close()
        assert stage.wait(timeout=300) == 0, stage.stdout.read()

        flat = pcm_to_float(out_raw.read_bytes(), PcmFormat.S32_LE)
        y = flat.reshape(-1, 2).T
        up = upsample_signal(x, lf, device="cpu")
        ref = crossfeed_signal(up, cf, device="cpu")
        # The oracle itself: the JAX package's offline upsample and
        # crossfeed on the same input.
        jax_ref = np.asarray(jax_crossfeed(
            np.asarray(jax_upsample(x, lf)), JaxCfFilter.load(cf_path)))
        assert (np.abs(ref - jax_ref).max() / np.abs(jax_ref).max()) < 1e-5
        # The ratio-1 chain carries the constant priming latency the
        # in-process chain reports.
        d = CrossfeedChain(
            StreamingUpsampler(_identity_filter(), channels=2, device="cpu"),
            CrossfeedProcessor(cf, device="cpu")).latency
        assert y.shape == up.shape
        np.testing.assert_allclose(y[:, :d], 0, atol=1e-7)
        np.testing.assert_allclose(y[:, d:], ref[:, : ref.shape[1] - d],
                                   rtol=1e-4, atol=1e-5)
    finally:
        srv.stop()
        if stage.poll() is None:
            stage.kill()
            stage.wait()
