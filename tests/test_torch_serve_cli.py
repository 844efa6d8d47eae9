"""The port's serve CLI (totton-serve-torch) on the CPU, run in-process:
a served client (also on a two-cell mesh), the refusals (no CUDA, a
--shard-serve the slot rows do not split over), the RSS recycle
monitor that survives a failed read, a live RELOAD through the ZMQ
control endpoint, and exit 1 on a dispatcher that keeps failing."""

import json
import os
import signal
import socket
import threading
import time

import numpy as np
import torch

from totton_tpu.filters.sidecar import load_filter
from totton_tpu.io.serve_client import ServeClient
from totton_tpu_torch import serve as serve_mod
from totton_tpu_torch.cli import serve as serve_cli
from totton_tpu_torch.engine.upsampler import upsample_signal

torch.set_num_threads(2)

RATE = 44100


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _args(coefficients_dir, port, *extra):
    return ["--listen", f"tcp-listen://127.0.0.1:{port}", "--rate",
            str(RATE), "--ratio", "2", "--filter-dir", str(coefficients_dir),
            "--max-streams", "2", "--device", "cpu", *extra]


def _connect(port, timeout=60):
    """A ServeClient once the server accepts (it warms up first)."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            return ServeClient(f"tcp://127.0.0.1:{port}", 2, RATE,
                               timeout_s=30, connect_window_s=1.0)
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.1)


def _in_thread(fn):
    """Run fn() in a thread (main() must keep the main thread for its
    signal handlers); returns (thread, result dict)."""
    result = {}

    def run():
        try:
            result["value"] = fn()
        except Exception as e:  # checked by the test
            result["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, result


def test_cli_serves_a_client_and_exits_0(coefficients_dir, rng):
    port = _free_port()
    x = (rng.normal(size=(2, 6000)) * 0.3).astype(np.float32)

    def client():
        try:
            with _connect(port) as c:
                return c.upsample(x)
        finally:
            # Graceful stop: the CLI's SIGINT handler drains, then stops.
            os.kill(os.getpid(), signal.SIGINT)

    t, result = _in_thread(client)
    rc = serve_cli.main(_args(coefficients_dir, port, "--duration", "120"))
    t.join(timeout=30)
    assert rc == 0
    assert "error" not in result, result
    lf = load_filter(str(next(coefficients_dir.glob("filter_44k_2x_*.json"))))
    ref = upsample_signal(x, lf, device="cpu")
    y = result["value"]
    assert y.shape == ref.shape
    assert np.abs(y - ref).max() / np.abs(ref).max() < 1e-5


def test_shard_serve_exits_2(coefficients_dir, capsys):
    """--shard-serve exits 2 where no step width splits the slot rows
    evenly over the mesh (the JAX server's message): every width is a
    power of two, so 3 devices never divide them."""
    rc = serve_cli.main(_args(coefficients_dir, _free_port(),
                              "--shard-serve", "3"))
    assert rc == 2
    assert "shards 2-channel slot rows evenly over 3 devices" in (
        capsys.readouterr().err)


def test_shard_serve_serves_a_client(coefficients_dir, rng, capsys):
    """--shard-serve 2 on the CPU: the step's rows split over two CPU
    cells, and a client's reply equals the offline upsample."""
    port = _free_port()
    x = (rng.normal(size=(2, 5000)) * 0.3).astype(np.float32)

    def client():
        try:
            with _connect(port) as c:
                return c.upsample(x)
        finally:
            os.kill(os.getpid(), signal.SIGINT)

    t, result = _in_thread(client)
    rc = serve_cli.main(_args(coefficients_dir, port, "--shard-serve", "2",
                              "--duration", "120"))
    t.join(timeout=30)
    assert rc == 0
    assert "error" not in result, result
    assert "Sharded serving: slot rows over 2 devices" in (
        capsys.readouterr().err)
    lf = load_filter(str(next(coefficients_dir.glob("filter_44k_2x_*.json"))))
    ref = upsample_signal(x, lf, device="cpu")
    y = result["value"]
    assert y.shape == ref.shape
    assert np.abs(y - ref).max() / np.abs(ref).max() < 1e-5


def test_device_cuda_without_cuda_exits_2(coefficients_dir, monkeypatch,
                                          capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _args(coefficients_dir, _free_port())
    rc = serve_cli.main(args[:-2] + ["--device", "cuda"])
    assert rc == 2
    assert "CUDA is not available" in capsys.readouterr().err


def test_rss_monitor_survives_a_failed_read(coefficients_dir, monkeypatch,
                                            capsys):
    """One None read (no /proc value this poll) skips that poll; the next
    read over the cap still recycles, and the CLI exits 3."""
    reads = []

    def rss():
        reads.append(None if not reads else 10 ** 6)
        return reads[-1]

    monkeypatch.setattr(serve_mod, "process_rss_mb", rss)
    rc = serve_cli.main(_args(coefficients_dir, _free_port(),
                              "--recycle-rss-mb", "100",
                              "--recycle-check-s", "0.05",
                              "--duration", "60"))
    assert rc == 3
    assert reads[0] is None and len(reads) >= 2
    assert "recycling" in capsys.readouterr().err


def test_control_endpoint_reload_swaps_live(coefficients_dir, tmp_path,
                                            capsys):
    from totton_tpu.control.client import DaemonClient

    endpoint = f"ipc://{tmp_path}/ctl.sock"
    stats_path = tmp_path / "stats.json"

    def control():
        client = DaemonClient(endpoint=endpoint, timeout_ms=30000)
        deadline = time.monotonic() + 60
        while not client.ping():
            assert time.monotonic() < deadline, "no PING reply"
            time.sleep(0.1)
        try:
            reply = client.reload_config()
            swaps = None
            deadline = time.monotonic() + 30
            while swaps != 1 and time.monotonic() < deadline:
                try:
                    swaps = json.loads(
                        stats_path.read_text())["spectrum_swaps"]
                except (OSError, ValueError, KeyError):
                    pass
                time.sleep(0.1)
            return reply, swaps, client.stats()
        finally:
            client.shutdown()

    t, result = _in_thread(control)
    rc = serve_cli.main(_args(coefficients_dir, _free_port(),
                              "--control-endpoint", endpoint,
                              "--stats-path", str(stats_path),
                              "--duration", "120"))
    t.join(timeout=30)
    assert rc == 0
    assert "error" not in result, result
    reply, swaps, st = result["value"]
    assert reply.ok, reply
    assert swaps == 1
    assert st.ok and st.data["reloads"] == 1
    assert "Live serve reload" in capsys.readouterr().err


def test_persistent_dispatcher_failure_exits_1(coefficients_dir, rng,
                                               monkeypatch):
    start = serve_mod.StreamServer.start

    def start_then_fail(self):
        start(self)

        def failing(tail, x, bundle):
            raise RuntimeError("injected persistent fault")

        self._step = failing

    monkeypatch.setattr(serve_mod.StreamServer, "start", start_then_fail)
    port = _free_port()
    x = (rng.normal(size=(2, 20000)) * 0.3).astype(np.float32)

    def clients():
        # Each failed step cuts its stream; keep reconnecting until the
        # three-strike breaker stops the server.
        for _ in range(10):
            try:
                c = _connect(port, timeout=5)
            except OSError:
                return  # the server stopped
            try:
                c.send(x)
                c.end_input()
                while c.read_frames() is not None:
                    pass
            except OSError:
                pass  # this stream was cut
            finally:
                c.close()

    t, _ = _in_thread(clients)
    rc = serve_cli.main(_args(coefficients_dir, port, "--duration", "60"))
    t.join(timeout=30)
    assert rc == 1
