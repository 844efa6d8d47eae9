"""The port's serving-plane control e2e: tests/test_serve_control.py's
cases on ``python -m totton_tpu_torch.cli.serve --device cpu``
subprocesses, with the same gates and tolerances.

8 concurrent streams on totton-serve-torch with the ZMQ control endpoint
attached; a web-style RELOAD (config phaseType flip) lands mid-stream;
every client's output is gated against the exact fade model on the port's
offline output for both filters; STATS shows the swap; PHASE_TYPE_SET
persists; SHUTDOWN exits 0. A fleet: a follower serve process replays the
leader's phase flip over PUB. The fade model's references are held to the
JAX package's offline upsample_signal on the same seeded input
(rel < 1e-5)."""

import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from totton_tpu.engine.upsampler import upsample_signal as jax_upsample
from totton_tpu_torch.control.client import DaemonClient
from totton_tpu_torch.engine.upsampler import upsample_signal
from totton_tpu_torch.filters.generate import generate_one
from totton_tpu_torch.filters.sidecar import load_filter
from totton_tpu_torch.io.sockets import HEADER_BYTES, pack_header

from test_serve_control import FADE, _fade_expectation, _stream_client
from test_torch_stream_cli import _port_below_ephemeral

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RATE = 44100
# The dispatcher rewrites the serve stats file at most every 0.5 s
# (serve.py's run loop, on its busy and its idle path), so a STATS reply
# right after the last stream ends may merge a file written before the
# swap; the twin waits (up to this long) for a rewrite after it.
STATS_REFRESH_WAIT_S = 5.0


@pytest.fixture(scope="module")
def phase_filter_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("serve_phase_coeff")
    generate_one("44k_2x", 2000, 25.0, 140.0, "minimum", str(out))
    generate_one("44k_2x", 2000, 25.0, 140.0, "linear", str(out))
    return out


def _serve(args):
    env = {k: v for k, v in os.environ.items() if k != "TOTTON_PLATFORM"}
    return subprocess.Popen(
        [sys.executable, "-m", "totton_tpu_torch.cli.serve",
         "--device", "cpu", *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO)


def _offline_pair(x, lf_min, lf_lin):
    """The port's offline output for both filters, each held to the JAX
    package's on the same input."""
    out = []
    for lf in (lf_min, lf_lin):
        y = upsample_signal(x, lf, device="cpu")
        ref = np.asarray(jax_upsample(x, lf))
        assert np.abs(y - ref).max() / np.abs(ref).max() < 1e-5
        out.append(y)
    return out


def test_follower_fleet_replays_leader_phase_flip(phase_filter_dir,
                                                  tmp_path):
    """Fleet deployment: a follower serve process replays the leader's
    published PHASE_TYPE event on its own serving plane — one control
    surface for N serve hosts, each with its own per-stream crossfades."""
    lead_port, fol_port = _port_below_ephemeral(), _port_below_ephemeral()
    endpoint = f"ipc://{tmp_path}/lead_ctl.sock"
    pub = f"ipc://{tmp_path}/lead_pub.sock"
    fol_stats = tmp_path / "fol_stats.json"
    common = ["--rate", str(RATE), "--ratio", "2",
              "--filter-dir", str(phase_filter_dir),
              "--max-streams", "4", "--swap-fade", str(FADE),
              "--duration", "600"]
    leader = _serve(
        common + ["--listen", f"tcp-listen://127.0.0.1:{lead_port}",
                  "--control-endpoint", endpoint,
                  "--control-pub-endpoint", pub])
    follower = _serve(
        common + ["--listen", f"tcp-listen://127.0.0.1:{fol_port}",
                  "--control-follow", pub,
                  "--stats-path", str(fol_stats)])
    try:
        client = DaemonClient(endpoint=endpoint, timeout_ms=30000)
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            if client.ping():
                break
            time.sleep(0.2)
        else:
            pytest.fail("leader never served PING")
        # Follower ready = its listener answers the stream header.
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            try:
                probe = socket.create_connection(
                    ("127.0.0.1", fol_port), timeout=1)
                probe.settimeout(10)
                probe.sendall(pack_header(None, 2, RATE))
                if probe.recv(HEADER_BYTES):
                    probe.close()
                    break
                probe.close()
            except OSError:
                pass
            time.sleep(0.3)
        else:
            pytest.fail("follower never accepted")

        lf_min = load_filter(str(
            phase_filter_dir / "filter_44k_2x_2000_min_phase.json"))
        lf_lin = load_filter(str(
            phase_filter_dir / "filter_44k_2x_2000_linear_phase.json"))
        block_size = lf_min.sidecar.fft_size - lf_min.sidecar.taps + 1
        block_in = block_size // 2
        rng = np.random.default_rng(11)
        x = (rng.normal(size=(2, 60 * block_in)) * 0.3).astype(np.float32)

        swap_gate = threading.Event()
        results: dict[int, np.ndarray] = {}
        errors: list = []
        t = threading.Thread(target=_stream_client, args=(
            fol_port, x, swap_gate, results, errors, 0))
        t.start()
        time.sleep(1.0)  # client mid-stream on the FOLLOWER
        assert client.set_phase_type("linear").ok
        time.sleep(1.0)  # PUB delivery + follower reload
        swap_gate.set()
        t.join(timeout=300)
        assert not errors, errors

        y = results[0]
        assert y.shape == (2, x.shape[1] * 2)
        ref_old, ref_new = _offline_pair(x, lf_min, lf_lin)
        best_err, best_p = np.inf, None
        for p in range(0, y.shape[1] + 1, block_size):
            expect = _fade_expectation(ref_old, ref_new, p)
            err = float(np.max(np.abs(expect - y)))
            if err < best_err:
                best_err, best_p = err, p
        assert best_err < 5e-4, (best_p, best_err)
        assert 0 < best_p < y.shape[1], best_p

        st = json.loads(fol_stats.read_text())
        assert st["spectrum_swaps"] == 1
        # Leader SHUTDOWN propagates to the follower over PUB.
        assert client.shutdown().ok
        assert leader.wait(timeout=120) == 0
        assert follower.wait(timeout=120) == 0
        assert "Live serve reload" in follower.stdout.read()
    finally:
        for proc in (leader, follower):
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def test_live_reload_under_8_concurrent_streams(phase_filter_dir, tmp_path):
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps({"filter": {"phaseType": "minimum"}}))
    stats_path = tmp_path / "serve_stats.json"
    endpoint = f"ipc://{tmp_path}/serve_ctl.sock"
    port = _port_below_ephemeral()
    proc = _serve(
        ["--listen", f"tcp-listen://127.0.0.1:{port}",
         "--rate", str(RATE), "--ratio", "2",
         "--filter-dir", str(phase_filter_dir),
         "--max-streams", "8", "--swap-fade", str(FADE),
         "--control-endpoint", endpoint,
         "--config", str(cfg),
         "--stats-path", str(stats_path),
         "--duration", "600"])
    try:
        client = DaemonClient(endpoint=endpoint, timeout_ms=30000)
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            if client.ping():
                break
            time.sleep(0.2)
        else:
            proc.kill()
            pytest.fail(f"serve never served PING: {proc.stdout.read()}")

        lf_min = load_filter(str(
            phase_filter_dir / "filter_44k_2x_2000_min_phase.json"))
        lf_lin = load_filter(str(
            phase_filter_dir / "filter_44k_2x_2000_linear_phase.json"))
        block_size = (lf_min.sidecar.fft_size - lf_min.sidecar.taps + 1)
        block_in = block_size // 2

        rng = np.random.default_rng(7)
        sigs = [(rng.normal(size=(2, (40 + 4 * i) * block_in)) * 0.3)
                .astype(np.float32) for i in range(8)]
        swap_gate = threading.Event()
        results: dict[int, np.ndarray] = {}
        errors: list = []
        threads = [threading.Thread(
            target=_stream_client,
            args=(port, sigs[i], swap_gate, results, errors, i))
            for i in range(8)]
        for t in threads:
            t.start()

        # Wait until every stream has drained its first half (all 8
        # attached and mid-stream), then flip the phase the web way:
        # PATCH config.json + RELOAD.
        # Every stream's first half drains at least this much output
        # (slots map to clients in arbitrary order, so gate on the min).
        out_floor = min(
            (x.shape[1] // 2 // block_in) * block_in * 2 for x in sigs)
        deadline = time.monotonic() + 240
        while time.monotonic() < deadline and not errors:
            try:
                st = json.loads(stats_path.read_text())
                active = st["streams"]["active"]
                drained = (bool(st["per_stream"]) and all(
                    ps["frames_out"] >= out_floor
                    for ps in st["per_stream"]))
            except (OSError, json.JSONDecodeError, KeyError):
                active, drained = 0, False
            if active == 8 and drained:
                break
            time.sleep(0.1)
        cfg.write_text(json.dumps({"filter": {"phaseType": "linear"}}))
        r = client.reload_config()
        assert r.ok, r
        swap_gate.set()

        for t in threads:
            t.join(timeout=300)
        assert not errors, errors
        assert len(results) == 8

        for i, y in results.items():
            x = sigs[i]
            # No dropped sample: exact output length.
            assert y.shape == (2, x.shape[1] * 2), (i, y.shape)
            # The swap lands at SOME post-swap dispatch boundary of this
            # stream (a block_size multiple); gate the whole output
            # against the exact fade model at that boundary.
            ref_old, ref_new = _offline_pair(x, lf_min, lf_lin)
            best_err, best_p = np.inf, None
            for p in range(0, y.shape[1] + 1, block_size):
                expect = _fade_expectation(ref_old, ref_new, p)
                err = float(np.max(np.abs(expect - y)))
                if err < best_err:
                    best_err, best_p = err, p
            assert best_err < 5e-4, (i, best_p, best_err)
            # The swap really happened mid-stream for this client (not
            # before its first block, not after its last).
            assert 0 < best_p < y.shape[1], (i, best_p)

        # STATS shows the swap: daemon counters + merged serve stats.
        # Every stream has ended, so a stats file written from now on
        # counts the swap; wait for one by the file's own uptime_ms.
        st = client.stats()
        assert st.ok
        written = st.data["stream"]["uptime_ms"]
        deadline = time.monotonic() + STATS_REFRESH_WAIT_S
        while (st.data["stream"]["uptime_ms"] <= written
               and time.monotonic() < deadline):
            time.sleep(0.1)
            st = client.stats()
            assert st.ok
        assert st.data["stream"]["uptime_ms"] > written, (
            "the serve stats file was not rewritten within "
            f"{STATS_REFRESH_WAIT_S:g} s")
        assert st.data["reloads"] == 1
        assert st.data["phase_type"] == "linear"
        assert st.data["stream"]["spectrum_swaps"] == 1
        assert st.data["stream"]["streams"]["accepted"] == 8
        # PHASE_TYPE_SET persists into config.json (restart-safe).
        assert client.set_phase_type("minimum").ok
        assert json.loads(cfg.read_text())["filter"]["phaseType"] == "minimum"

        assert client.shutdown().ok
        assert proc.wait(timeout=120) == 0
        out = proc.stdout.read()
        assert "Live serve reload" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.mark.parametrize("p_true", [0, 3 * 96, 7 * 96 + 40])
def test_chip_fade_search_equals_the_brute_force(p_true):
    """chip_smoke.fade_point, the card's linear search for the swap point,
    gives this file's brute-force search's point and error exactly."""
    import chip_smoke

    r = np.random.default_rng(p_true)
    old, new = (r.normal(size=(2, 1000)).astype(np.float32)
                for _ in range(2))
    y = (_fade_expectation(old, new, p_true)
         + r.normal(size=old.shape).astype(np.float32) * 1e-3)
    best_err, best_p = np.inf, None
    for p in range(0, y.shape[1] + 1, 96):
        err = float(np.max(np.abs(_fade_expectation(old, new, p) - y)))
        if err < best_err:
            best_err, best_p = err, p
    assert chip_smoke.fade_point(y, old, new, 96, FADE) == (best_p, best_err)
