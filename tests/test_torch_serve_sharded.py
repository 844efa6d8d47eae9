"""The port's serve plane on a mesh: a twin of tests/test_serve_sharded.py.

The step's slot rows split over an 8-cell mesh ([cpu] * 8 here); each
device steps its own rows and the rows are gathered back in order. The
JAX server runs the same settings on conftest's 8 virtual devices, and
both get the same client bytes: replies agree with each other and with
the port's offline upsample_signal at rel < 1e-5 (atol 1e-6), and the
live control plane (crossfaded swaps) works on the mesh as on one
device."""

import socket
import threading
import time

import numpy as np
import pytest
import torch

from totton_tpu.parallel import make_mesh as jax_make_mesh
from totton_tpu.serve import StreamServer as JaxStreamServer
from totton_tpu_torch.engine.upsampler import upsample_signal
from totton_tpu_torch.parallel import make_mesh
from totton_tpu_torch.serve import RowSplit, StreamServer

from test_serve import RATE, _client_roundtrip, _filter, _free_port

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture()
def mesh8():
    return make_mesh(n_channel=8, n_time=1,
                     devices=[torch.device("cpu")] * 8)


def _start(mesh, max_streams=16, fade=0, jax_too=False):
    """The port's server on ``mesh`` (and, with jax_too, the JAX server on
    the 8 virtual devices), started on free ports."""
    lf = _filter()
    out = []
    for cls, m in ((StreamServer, mesh),) + (
            ((JaxStreamServer, jax_make_mesh(n_channel=8, n_time=1)),)
            if jax_too else ()):
        port = _free_port()
        srv = cls(lf, f"tcp-listen://127.0.0.1:{port}", RATE,
                  max_streams=max_streams, channels=2, mesh=m,
                  swap_fade_frames=fade)
        srv.start()
        out.append((srv, port))
    return lf, out


def _stop(servers):
    for srv, _ in servers:
        srv.stop()


class TestShardedServe:
    def test_step_inputs_are_row_split(self, mesh8):
        lf, servers = _start(mesh8)
        srv = servers[0][0]
        try:
            z = srv._to_device(np.zeros((16, srv.config.halo_in),
                                        np.float32))
            assert isinstance(z, RowSplit) and len(z.parts) == 8
            # dim 0 (rows) split, dim 1 whole, each part on its device
            assert {tuple(p.shape) for p in z.parts} == {
                (2, srv.config.halo_in)}
            assert [p.device for p in z.parts] == mesh8.devices()
            assert srv._slot_widths == [8, 16]
        finally:
            _stop(servers)

    def test_single_stream_exact(self, mesh8, rng):
        lf, servers = _start(mesh8, jax_too=True)
        try:
            x = (rng.normal(size=(2, 5000)) * 0.3).astype(np.float32)
            (y, out_rate), (yj, _) = (_client_roundtrip(port, x)
                                      for _, port in servers)
            assert out_rate == RATE * lf.ratio
            np.testing.assert_allclose(y, yj, rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(y, upsample_signal(x, lf,
                                                          device="cpu"),
                                       rtol=RTOL, atol=ATOL)
        finally:
            _stop(servers)

    def test_concurrent_streams_isolated_on_mesh(self, mesh8, rng):
        """10 concurrent staggered clients on a 16-slot server on the mesh:
        every stream equals its own offline reference, width transitions
        included."""
        lf, servers = _start(mesh8)
        port = servers[0][1]
        try:
            signals = [(rng.normal(size=(2, 2200 + 301 * i)) * 0.3)
                       .astype(np.float32) for i in range(10)]
            results: dict[int, np.ndarray] = {}
            errors: list = []

            def run(i: int) -> None:
                try:
                    time.sleep(0.012 * i)
                    results[i] = _client_roundtrip(
                        port, signals[i], chunk=601, stagger_s=0.002)[0]
                except Exception as e:  # checked below
                    errors.append((i, e))

            threads = [threading.Thread(target=run, args=(i,))
                       for i in range(10)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            assert not any(t.is_alive() for t in threads)
            assert not errors, errors
            assert len(results) == 10
            for i, y in results.items():
                np.testing.assert_allclose(
                    y, upsample_signal(signals[i], lf, device="cpu"),
                    rtol=RTOL, atol=ATOL, err_msg=f"stream {i}")
        finally:
            _stop(servers)

    def test_live_swap_crossfades_on_mesh(self, mesh8, rng):
        """set_eq mid-stream crossfades exactly on the mesh (the fade
        prefix is dispatched on the same row split)."""
        from test_serve import _control_client, _wait_counter

        FADE = 500
        lf, servers = _start(mesh8, fade=FADE)
        srv, port = servers[0]
        try:
            block_in = srv.config.block_in
            ratio = srv.config.ratio
            p1 = (rng.normal(size=(2, 4 * block_in)) * 0.3).astype(np.float32)
            p2 = (rng.normal(size=(2, 6 * block_in)) * 0.3).astype(np.float32)
            x = np.concatenate([p1, p2], axis=1)
            eq = np.linspace(0.4, 1.2, srv.config.n_bins)

            s, send, read_exact, read_rest = _control_client(port)
            send(p1)
            y1 = read_exact(p1.shape[1] * ratio)
            srv.set_eq(eq)
            _wait_counter(lambda: srv.stats.spectrum_swaps, 1)
            send(p2)
            s.shutdown(socket.SHUT_WR)
            y2 = read_rest()
            s.close()

            n1 = p1.shape[1] * ratio
            ref_old = upsample_signal(x, lf, device="cpu")
            ref_new = upsample_signal(x, lf, eq_response=eq, device="cpu")
            np.testing.assert_allclose(y1, ref_old[:, :n1],
                                       rtol=RTOL, atol=ATOL)
            ramp = np.arange(FADE, dtype=np.float32) / FADE
            expect2 = ref_new[:, n1:].copy()
            expect2[:, :FADE] = (ref_old[:, n1:n1 + FADE] * (1.0 - ramp)
                                 + ref_new[:, n1:n1 + FADE] * ramp)
            np.testing.assert_allclose(y2, expect2, rtol=1e-4, atol=1e-5)
            assert isinstance(srv._bundle, dict) and len(srv._bundle) == 1
        finally:
            _stop(servers)

    def test_indivisible_width_rejected(self, mesh8):
        # 4 slots x 1 channel = 4 rows cannot split over 8 devices; the
        # JAX server refuses the same settings with the same message.
        with pytest.raises(ValueError, match="shards") as e:
            StreamServer(_filter(), "tcp-listen://127.0.0.1:0", RATE,
                         max_streams=4, channels=1, mesh=mesh8)
        with pytest.raises(ValueError) as ej:
            JaxStreamServer(_filter(), "tcp-listen://127.0.0.1:0", RATE,
                            max_streams=4, channels=1,
                            mesh=jax_make_mesh(n_channel=8, n_time=1))
        assert str(e.value) == str(ej.value)

    def test_one_cell_mesh_is_the_one_device_path(self, rng):
        """A 1x1 mesh serves on its cell's device with the plain step (no
        row split), exactly as a server without a mesh."""
        mesh = make_mesh(n_channel=1, n_time=1,
                         devices=[torch.device("cpu")])
        lf, servers = _start(mesh, max_streams=8)
        srv, port = servers[0]
        try:
            assert srv._devices is None and srv.device.type == "cpu"
            x = (rng.normal(size=(2, 3000)) * 0.3).astype(np.float32)
            y, _ = _client_roundtrip(port, x)
            np.testing.assert_allclose(y, upsample_signal(x, lf,
                                                          device="cpu"),
                                       rtol=RTOL, atol=ATOL)
        finally:
            _stop(servers)
