"""The port's live control plane: totton-stream-torch serving the ZMQ
protocol in-process (leader role), with RELOAD / PHASE_TYPE_SET /
SOFT_RESET acting on the running engine. Mirrors tests/test_live_control.py
with ``python -m totton_tpu_torch.cli.stream --device cpu`` subprocesses
and a small 2x filter pair generated by generate_one."""

import json
import os
import subprocess
import sys
import time

import pytest

from totton_tpu.control.client import DaemonClient

torch = pytest.importorskip("torch")

from totton_tpu_torch.filters.generate import generate_one

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def phase_filter_dir(tmp_path_factory):
    """Both phases of one geometry (hot-swappable)."""
    out = tmp_path_factory.mktemp("phase_coeff")
    generate_one("44k_2x", 2000, 25.0, 140.0, "minimum", str(out))
    generate_one("44k_2x", 2000, 25.0, 140.0, "linear", str(out))
    return out


def _start(args):
    env = {k: v for k, v in os.environ.items() if k != "TOTTON_PLATFORM"}
    env["TOTTON_COMPILE_CACHE"] = "0"
    return subprocess.Popen(
        [sys.executable, "-m", "totton_tpu_torch.cli.stream",
         "--device", "cpu", *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO)


def _wait_ping(client, proc, deadline_s=120):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if client.ping():
            return
        if proc.poll() is not None:
            break
        time.sleep(0.2)
    proc.kill()
    pytest.fail(f"streamer never served PING: {proc.stdout.read()}")


def _finish(client, proc):
    assert client.shutdown().ok
    assert proc.wait(timeout=60) == 0
    return proc.stdout.read()


def _kill(proc):
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def test_config_eq_tracked_across_reload(phase_filter_dir, tmp_path):
    """The web 'apply EQ -> RELOAD' flow: config.json's eqEnabled /
    eqProfilePath, alsa.dither and filter.phaseType are re-read on every
    RELOAD; PHASE_TYPE_SET persists back into config.json."""
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps({"eqEnabled": False}))
    profile = tmp_path / "boost.txt"
    profile.write_text("Preamp: -3 dB\n"
                       "Filter 1: ON PK Fc 1000 Hz Gain 3 dB Q 1.0\n")
    endpoint = f"ipc://{tmp_path}/cfg_eq.sock"
    proc = _start(["--in", "null", "--out", str(tmp_path / "out.wav"),
                   "--rate", "352800", "--ratio", "2", "--filter-dir",
                   str(phase_filter_dir), "--config", str(cfg),
                   "--control-endpoint", endpoint, "--duration", "120"])
    try:
        client = DaemonClient(endpoint=endpoint, timeout_ms=15000)
        _wait_ping(client, proc)
        cfg.write_text(json.dumps({"eqEnabled": True, "eqProfile": "boost",
                                   "eqProfilePath": str(profile)}))
        assert client.reload_config().ok
        cfg.write_text(json.dumps({"eqEnabled": True, "eqProfilePath":
                                   str(tmp_path / "gone.txt")}))
        assert client.reload_config().ok  # survives a missing profile
        cfg.write_text(json.dumps({"eqEnabled": False,
                                   "alsa": {"dither": True}}))
        assert client.reload_config().ok
        cfg.write_text(json.dumps({"eqEnabled": False,
                                   "filter": {"phaseType": "linear"}}))
        assert client.reload_config().ok
        assert client.get_phase_type().data["phase_type"] == "linear"
        assert client.set_phase_type("minimum").ok
        assert json.loads(cfg.read_text())["filter"]["phaseType"] == "minimum"
        assert client.reload_config().ok
        assert client.get_phase_type().data["phase_type"] == "minimum"
        out = _finish(client, proc)
        assert "+ EQ" in out and "boost.txt" in out
        assert "EQ skipped" in out
        assert "Live dither: on" in out
        last = [ln for ln in out.splitlines()
                if ln.startswith("Live reload:")][-1]
        assert "+ EQ" not in last and "skipped" not in last
    finally:
        _kill(proc)


def test_startup_phase_from_config(phase_filter_dir, tmp_path):
    """Without --phase the streamer boots with config.json's
    filter.phaseType, so a persisted PHASE_TYPE_SET survives a restart."""
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps({"filter": {"phaseType": "linear"}}))
    endpoint = f"ipc://{tmp_path}/boot_phase.sock"
    proc = _start(["--in", "null", "--out", "null", "--rate", "352800",
                   "--ratio", "2", "--filter-dir", str(phase_filter_dir),
                   "--config", str(cfg), "--control-endpoint", endpoint,
                   "--duration", "60"])
    try:
        client = DaemonClient(endpoint=endpoint, timeout_ms=15000)
        _wait_ping(client, proc)
        assert client.get_phase_type().data["phase_type"] == "linear"
        out = _finish(client, proc)
        assert "linear_phase" in out.splitlines()[0]
    finally:
        _kill(proc)


@pytest.mark.parametrize("threaded", [False, True])
def test_streamer_with_live_control(phase_filter_dir, tmp_path, threaded):
    """PING, a live phase swap (same geometry: a bundle swap, nothing
    rebuilt), RELOAD, SOFT_RESET, STATS and SHUTDOWN, under the
    synchronous and the threaded session."""
    endpoint = f"ipc://{tmp_path}/live.sock"
    proc = _start(["--in", "null", "--out", "null", "--rate", "352800",
                   "--ratio", "2", "--filter-dir", str(phase_filter_dir),
                   "--control-endpoint", endpoint,
                   "--stats-path", str(tmp_path / "stats.json"),
                   "--duration", "60"]
                  + (["--threaded"] if threaded else []))
    try:
        client = DaemonClient(endpoint=endpoint, timeout_ms=15000)
        _wait_ping(client, proc)
        r = client.set_phase_type("linear")
        assert r.ok, r.raw
        assert client.get_phase_type().data["phase_type"] == "linear"
        assert client.reload_config().ok
        assert client.soft_reset().ok
        stats = client.stats()
        assert stats.ok and stats.data["reloads"] >= 1
        out = _finish(client, proc)
        assert "Live reload:" in out
        assert "linear_phase" in out
        assert "Streaming stopped" in out
    finally:
        _kill(proc)
