"""The port's totton-control CLI (``totton_tpu_torch/cli/control.py``, a
copy of the JAX package's) end to end, as tests/test_control.py's
subprocess case runs the reference's: a real process on a real socket,
driven by the port's DaemonClient, SHUTDOWN -> a clean exit, and the
same replies as the reference's process gives; no jax loaded."""

import os
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

from totton_tpu_torch.control.client import DaemonClient


def _drive(module: str, endpoint: str, env) -> tuple[list, str]:
    code = ("import runpy, sys; sys.argv = ['totton-control', '--endpoint', "
            f"{endpoint!r}]\n"
            "try:\n"
            f"    runpy.run_module({module!r}, run_name='__main__')\n"
            "finally:\n"
            "    print('JAX', 'jax' in sys.modules, flush=True)\n")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        client = DaemonClient(endpoint=endpoint, timeout_ms=500)
        deadline = time.monotonic() + 20
        while not client.ping():
            if time.monotonic() > deadline:
                pytest.fail(f"{module} never answered PING")
            time.sleep(0.1)
        replies = [client.set_phase_type("linear").data,
                   client.get_phase_type().data,
                   client.set_phase_type("warped").error_code,
                   client.soft_reset().ok,
                   sorted(client.stats().data)]
        assert client.shutdown().ok
        assert proc.wait(timeout=10) == 0
        return replies, proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_control_cli_subprocess_matches_the_reference(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "TOTTON_PLATFORM"}
    port, out = _drive("totton_tpu_torch.cli.control",
                       f"ipc://{tmp_path}/port.sock", env)
    ref, ref_out = _drive("totton_tpu.cli.control",
                          f"ipc://{tmp_path}/ref.sock", env)
    assert port == ref
    assert port[1]["phase_type"] == "linear"
    for text in (out, ref_out):
        assert "ZMQ server listening" in text
        assert "ZMQ server stopped" in text
    assert "JAX False" in out
