"""ZeroMQ REQ/REP command server library.

Parity with the reference's ZmqCommandServer (src/zmq/command_server.cpp):
handler registry keyed by command string; accepts a raw token or a
{"cmd": ...} JSON object; standard ok/error JSON envelopes; optional PUB
socket; ipc:// socket-file cleanup; 100 ms recv poll so Stop() is prompt.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from typing import Callable

import zmq


@dataclasses.dataclass
class ZmqRequest:
    raw: str
    cmd: str = ""
    is_json: bool = False
    payload: dict = dataclasses.field(default_factory=dict)
    parse_error: str | None = None

    def param(self, *keys: str) -> str | None:
        """First present key from the JSON payload (e.g. 'phase',
        'phase_type')."""
        for k in keys:
            v = self.payload.get(k)
            if v not in (None, ""):
                return v
        return None


def build_ok(data: dict | str | None = None) -> str:
    if data is None:
        return '{"status":"ok"}'
    if isinstance(data, str):
        return '{"status":"ok","data":' + data + "}"
    return json.dumps({"status": "ok", "data": data})


def build_error(code: str, message: str) -> str:
    return json.dumps({"status": "error", "error_code": code,
                       "message": message})


def parse_request(raw: str) -> ZmqRequest:
    req = ZmqRequest(raw=raw)
    stripped = raw.strip()
    if stripped.startswith("{"):
        req.is_json = True
        try:
            payload = json.loads(stripped)
            if not isinstance(payload, dict):
                req.parse_error = "invalid json object"
                return req
            req.payload = payload
            cmd = payload.get("cmd", "")
            if not cmd:
                req.parse_error = "cmd is required"
            req.cmd = str(cmd)
        except json.JSONDecodeError:
            req.parse_error = "invalid json object"
    else:
        req.cmd = stripped
    return req


class ZmqCommandServer:
    """REQ/REP server with a background thread and optional PUB socket."""

    def __init__(self, endpoint: str, pub_endpoint: str | None = None) -> None:
        self.endpoint = endpoint
        self.pub_endpoint = pub_endpoint
        self._handlers: dict[str, Callable[[ZmqRequest], str]] = {}
        self._ctx: zmq.Context | None = None
        self._pub: zmq.Socket | None = None
        self._pub_lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._running = threading.Event()

    def register(self, command: str, handler: Callable[[ZmqRequest], str]) -> None:
        """handler(request) -> response JSON string (use build_ok/build_error)."""
        self._handlers[command] = handler

    def dispatch(self, raw: str) -> str:
        req = parse_request(raw)
        if req.parse_error:
            return build_error("INVALID_JSON", req.parse_error)
        handler = self._handlers.get(req.cmd)
        if handler is None:
            return build_error("UNKNOWN_CMD", "unknown command")
        try:
            return handler(req)
        except Exception as e:  # handler bug must not kill the server loop
            return build_error("INTERNAL", f"{type(e).__name__}: {e}")

    def start(self) -> None:
        if self._thread is not None:
            return
        self._ctx = zmq.Context.instance()
        self._running.set()
        ready = threading.Event()
        self._thread = threading.Thread(
            target=self._serve, args=(ready,), daemon=True, name="zmq-server"
        )
        self._thread.start()
        if not ready.wait(timeout=5.0):
            raise RuntimeError(f"ZMQ server failed to bind {self.endpoint}")

    def _serve(self, ready: threading.Event) -> None:
        rep = self._ctx.socket(zmq.REP)
        rep.setsockopt(zmq.RCVTIMEO, 100)
        rep.setsockopt(zmq.LINGER, 0)
        rep.bind(self.endpoint)
        if self.pub_endpoint:
            with self._pub_lock:
                self._pub = self._ctx.socket(zmq.PUB)
                self._pub.setsockopt(zmq.LINGER, 0)
                self._pub.bind(self.pub_endpoint)
        ready.set()
        try:
            while self._running.is_set():
                try:
                    raw = rep.recv_string()
                except zmq.Again:
                    continue
                rep.send_string(self.dispatch(raw))
        finally:
            rep.close(0)
            with self._pub_lock:
                if self._pub is not None:
                    self._pub.close(0)
                    self._pub = None
            self._cleanup_ipc()

    def publish(self, message: str) -> str | None:
        """Fire-and-forget PUB; returns an error string or None."""
        with self._pub_lock:
            if self._pub is None:
                return "pub socket not configured"
            try:
                self._pub.send_string(message, flags=zmq.DONTWAIT)
            except zmq.ZMQError as e:
                return str(e)
        return None

    def stop(self) -> None:
        self._running.clear()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _cleanup_ipc(self) -> None:
        import os

        for ep in (self.endpoint, self.pub_endpoint):
            if ep and ep.startswith("ipc://"):
                try:
                    os.unlink(ep[len("ipc://"):])
                except OSError:
                    pass
