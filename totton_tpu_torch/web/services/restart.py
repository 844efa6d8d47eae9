"""Deployment restart hooks for the web layer.

POST /api/daemon/restart needs a deployment-level action for when a live
RELOAD cannot reach the streamer (reference behavior: restart the DSP
container over the Docker socket, web/services/docker_control.py:34-64).
``resolve_restart_fn`` picks a strategy from the environment, in order:

1. ``TOTTON_RESTART_CMD`` — run an arbitrary shell command (systemd unit
   restart, ``docker compose restart dsp``, a k8s rollout, ...). Success =
   exit code 0.
2. Docker Engine API over the unix socket — when ``TOTTON_DSP_CONTAINER``
   is set, or the default socket path exists. POSTs
   ``/containers/<name>/restart`` via an HTTP client bound to the socket.
3. Neither available -> returns None; the route answers 501.

The resolved callable returns True on success and raises RestartError with
a human-readable message otherwise (the route maps it to a 502).
"""

from __future__ import annotations

import http.client
import os
import socket
import subprocess
import urllib.parse
from typing import Callable

DOCKER_SOCKET_ENV = "TOTTON_DOCKER_SOCKET"
CONTAINER_ENV = "TOTTON_DSP_CONTAINER"
RESTART_CMD_ENV = "TOTTON_RESTART_CMD"
DEFAULT_DOCKER_SOCKET = "/var/run/docker.sock"
DEFAULT_CONTAINER = "totton-dsp"


class RestartError(RuntimeError):
    """A restart strategy was configured but failed to execute."""


class _UnixSocketConnection(http.client.HTTPConnection):
    """HTTPConnection whose transport is an AF_UNIX stream socket."""

    def __init__(self, socket_path: str, timeout: float) -> None:
        super().__init__("localhost", timeout=timeout)
        self._socket_path = socket_path

    def connect(self) -> None:  # pragma: no cover - trivial
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(self.timeout)
        s.connect(self._socket_path)
        self.sock = s


def restart_container(
    name: str | None = None,
    socket_path: str | None = None,
    timeout_s: float = 10.0,
) -> bool:
    """Restart a container through the Docker Engine API on a unix socket."""
    name = name or os.environ.get(CONTAINER_ENV, DEFAULT_CONTAINER)
    socket_path = socket_path or os.environ.get(
        DOCKER_SOCKET_ENV, DEFAULT_DOCKER_SOCKET
    )
    conn = _UnixSocketConnection(socket_path, timeout_s)
    try:
        conn.request(
            "POST", f"/containers/{urllib.parse.quote(name, safe='')}/restart"
        )
        resp = conn.getresponse()
        body = resp.read(4096)
    except OSError as e:
        raise RestartError(f"docker socket {socket_path}: {e}") from e
    finally:
        conn.close()
    if resp.status not in (200, 204):
        detail = body.decode("utf-8", "replace").strip()
        raise RestartError(
            f"docker restart of {name!r} answered {resp.status}: {detail}"
        )
    return True


def restart_via_command(cmd: str, timeout_s: float = 30.0) -> bool:
    """Run a configured restart command; success = exit code 0."""
    try:
        proc = subprocess.run(
            cmd, shell=True, capture_output=True, timeout=timeout_s
        )
    except subprocess.TimeoutExpired as e:
        raise RestartError(f"restart command timed out after {timeout_s}s") from e
    if proc.returncode != 0:
        err = proc.stderr.decode("utf-8", "replace").strip()
        raise RestartError(
            f"restart command exited {proc.returncode}: {err or '<no stderr>'}"
        )
    return True


def resolve_restart_fn(env: dict | None = None) -> Callable[[], bool] | None:
    """Pick the restart strategy for this deployment (None if unconfigured)."""
    env = os.environ if env is None else env
    cmd = env.get(RESTART_CMD_ENV)
    if cmd:
        return lambda: restart_via_command(cmd)
    socket_path = env.get(DOCKER_SOCKET_ENV, DEFAULT_DOCKER_SOCKET)
    if env.get(CONTAINER_ENV) or os.path.exists(socket_path):
        name = env.get(CONTAINER_ENV, DEFAULT_CONTAINER)
        return lambda: restart_container(name, socket_path)
    return None
