"""The port's entrypoint (deploy/torch/entrypoint.sh) in its service modes,
and the port's e2e scripts, on the CPU (TOTTON_DEVICE=cpu): dsp answers
PING, takes PHASE_TYPE_SET and RELOAD live; control answers PING; web
answers GET /api/status; each stops on SIGTERM with its children. Every
entrypoint runs in its own process group, killed when the test ends."""

import os
import re
import subprocess
import time

import pytest

torch = pytest.importorskip("torch")

from test_torch_deploy import REPO, deploy  # noqa: F401 (fixture)
import chip_smoke
from totton_tpu_torch.control.client import DaemonClient


def _start(env, mode, log_path):
    return chip_smoke.start_entry([chip_smoke.ENTRYPOINT, mode], env,
                                  str(log_path))


def _stop(proc, log_path, module):
    """SIGTERM to the entrypoint: it and its CLI child are gone within
    chip_smoke.STOP_LIMIT_S."""
    child = chip_smoke.child_pid(proc.pid, module)
    chip_smoke.stop_entry(proc, timeout=chip_smoke.STOP_LIMIT_S)
    assert not chip_smoke.alive(child), log_path.read_text()


def _wait_ping(client, proc, log_path, timeout_s=120):
    deadline = time.monotonic() + timeout_s
    while not client.ping():
        assert proc.poll() is None and time.monotonic() < deadline, (
            log_path.read_text())


def test_dsp_mode_takes_live_control(deploy):  # noqa: F811
    """The streamer on the null devices with its control endpoint: PING,
    PHASE_TYPE_SET linear (the live filter swaps), RELOAD (config.json,
    where the phase was persisted), STATS."""
    env, tmp = deploy
    endpoint = f"ipc://{tmp}/dsp.sock"
    env.update(TOTTON_DEVICE="cpu", TOTTON_IN="null", TOTTON_OUT="null",
               TOTTON_RATIO="16", TOTTON_ZMQ_ENDPOINT=endpoint)
    log = tmp / "dsp.log"
    proc = _start(env, "dsp", log)
    try:
        client = DaemonClient(endpoint=endpoint, timeout_ms=30000)
        _wait_ping(client, proc, log)
        r = client.set_phase_type("linear")
        assert r.ok and r.data["phase_type"] == "linear", r.data
        r = client.reload_config()
        assert r.ok, r.data
        r = client.stats()
        assert r.ok and r.data["phase_type"] == "linear", r.data
        assert r.data["reloads"] >= 1, r.data
        _stop(proc, log, "totton_tpu_torch.cli.stream")
    finally:
        chip_smoke.kill_group(proc)
    out = log.read_text()
    assert re.search(r"Live reload: \S+_16x_8000_linear_phase\.json", out)
    assert "fused_frames_launches=0" in out  # the plain path, no kernel


def test_control_mode_answers_ping(deploy):  # noqa: F811
    env, tmp = deploy
    endpoint = f"ipc://{tmp}/ctl.sock"
    env.update(TOTTON_ZMQ_ENDPOINT=endpoint)
    log = tmp / "control.log"
    proc = _start(env, "control", log)
    try:
        _wait_ping(DaemonClient(endpoint=endpoint, timeout_ms=30000), proc,
                   log)
        _stop(proc, log, "totton_tpu_torch.cli.control")
    finally:
        chip_smoke.kill_group(proc)


def test_web_mode_answers_status(deploy):  # noqa: F811
    env, tmp = deploy
    port = chip_smoke.free_port()
    env.update(TOTTON_WEB_PORT=str(port),
               TOTTON_ZMQ_ENDPOINT=f"ipc://{tmp}/none.sock")
    log = tmp / "web.log"
    proc = _start(env, "web", log)
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                status, body = chip_smoke.http(
                    f"http://127.0.0.1:{port}/api/status")
                break
            except OSError:
                assert proc.poll() is None and time.monotonic() < deadline, (
                    log.read_text())
                time.sleep(0.1)
        assert status == 200 and "daemon_running" in body
        _stop(proc, log, "totton_tpu_torch.cli.webserver")
    finally:
        chip_smoke.kill_group(proc)


def _script(rel, env, timeout):
    proc = subprocess.Popen(["bash", os.path.join(REPO, rel)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        out = proc.communicate(timeout=timeout)[0]
    finally:
        chip_smoke.kill_group(proc)
    return proc.returncode, out


def test_e2e_local_file_script_passes_on_the_cpu(deploy):  # noqa: F811
    env, _ = deploy
    env["TOTTON_DEVICE"] = "cpu"
    rc, out = _script("scripts/torch/e2e_local_file_test.sh", env, 300)
    assert rc == 0 and "[e2e] PASS" in out, out


def test_e2e_docker_script_skips_without_docker(deploy):  # noqa: F811
    env, _ = deploy
    env["DOCKER_HOST"] = "unix:///nonexistent/docker.sock"
    rc, out = _script("scripts/torch/e2e_docker_test.sh", env, 120)
    assert rc == 2 and "SKIP" in out, out


def test_run_tests_script_runs_only_the_port_tests():
    """scripts/torch/run_tests.sh runs tests/test_torch_*.py and nothing
    else (it is not run here: it would run this file)."""
    with open(os.path.join(REPO, "scripts/torch/run_tests.sh")) as f:
        commands = [line for line in f if line.strip()
                    and not line.lstrip().startswith(("#", "set ", "cd "))]
    assert [c.split("#")[0].strip() for c in commands] == [
        "python -m pytest tests/test_torch_*.py -q",
        'echo "port tests passed"']
