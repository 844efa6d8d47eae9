"""ZMQ REQ client for the control daemon.

Parity with the reference web layer's DaemonClient
(web/services/daemon_client.py:31-101): short-timeout REQ socket per call,
JSON envelope parsing with legacy plain-text tolerance.
"""

from __future__ import annotations

import dataclasses
import json
import os

import zmq

from totton_tpu_torch.control.daemon import DEFAULT_ENDPOINT, ENDPOINT_ENV


@dataclasses.dataclass
class DaemonResponse:
    ok: bool
    data: dict | None = None
    error_code: str | None = None
    message: str | None = None
    raw: str = ""


class DaemonClient:
    def __init__(self, endpoint: str | None = None,
                 timeout_ms: int = 2000) -> None:
        self.endpoint = endpoint or os.environ.get(ENDPOINT_ENV,
                                                   DEFAULT_ENDPOINT)
        self.timeout_ms = timeout_ms

    def request(self, command: str | dict) -> DaemonResponse:
        payload = command if isinstance(command, str) else json.dumps(command)
        ctx = zmq.Context.instance()
        sock = ctx.socket(zmq.REQ)
        sock.setsockopt(zmq.RCVTIMEO, self.timeout_ms)
        sock.setsockopt(zmq.SNDTIMEO, self.timeout_ms)
        sock.setsockopt(zmq.LINGER, 0)
        try:
            sock.connect(self.endpoint)
            sock.send_string(payload)
            raw = sock.recv_string()
        except zmq.ZMQError as e:
            return DaemonResponse(ok=False, error_code="TIMEOUT",
                                  message=str(e))
        finally:
            sock.close(0)
        try:
            obj = json.loads(raw)
        except json.JSONDecodeError:
            # Legacy plain-text response tolerance.
            return DaemonResponse(ok=bool(raw), raw=raw,
                                  data={"text": raw})
        if obj.get("status") == "ok":
            return DaemonResponse(ok=True, data=obj.get("data"), raw=raw)
        return DaemonResponse(
            ok=False,
            error_code=obj.get("error_code"),
            message=obj.get("message"),
            raw=raw,
        )

    # -- convenience wrappers --------------------------------------------

    def ping(self) -> bool:
        return self.request("PING").ok

    def stats(self) -> DaemonResponse:
        return self.request("STATS")

    def reload_config(self) -> DaemonResponse:
        return self.request("RELOAD")

    def soft_reset(self) -> DaemonResponse:
        return self.request("SOFT_RESET")

    def get_phase_type(self) -> DaemonResponse:
        return self.request("PHASE_TYPE_GET")

    def set_phase_type(self, phase: str) -> DaemonResponse:
        return self.request({"cmd": "PHASE_TYPE_SET", "phase": phase})

    def list_devices(self) -> DaemonResponse:
        return self.request("LIST_ALSA_DEVICES")

    def shutdown(self) -> DaemonResponse:
        return self.request("SHUTDOWN")
