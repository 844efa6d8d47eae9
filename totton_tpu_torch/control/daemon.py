"""Control daemon: the command set on top of ZmqCommandServer.

Parity with the reference's zmq_control_server binary
(src/zmq/zmq_server_main.cpp:144-226): PING, STATS (uptime/phase/counters),
RELOAD, SOFT_RESET, PHASE_TYPE_GET/SET (minimum|linear), LIST_ALSA_DEVICES,
SHUTDOWN. Unlike the shipped reference stub (which only tracks counters —
SURVEY.md L1 note), the daemon takes optional callbacks so RELOAD /
PHASE_TYPE_SET / SOFT_RESET can drive a live engine (hot filter swap without
restart), and STATS merges the streaming stats file when present.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable

from totton_tpu_torch.control.server import ZmqCommandServer, ZmqRequest, build_error, build_ok

DEFAULT_ENDPOINT = "ipc:///tmp/totton_zmq.sock"
ENDPOINT_ENV = "TOTTON_ZMQ_ENDPOINT"
PUB_ENDPOINT_ENV = "TOTTON_ZMQ_PUB_ENDPOINT"
STATS_PATH_ENV = "TOTTON_STATS_PATH"
DEFAULT_STATS_PATH = "/tmp/gpu_upsampler_stats.json"


def _resolve_initial_phase(phase_type: str | None) -> str:
    """Initial PHASE_TYPE state: explicit value > config.json
    `filter.phaseType` > "minimum".

    Reading the config keeps a standalone daemon's reported phase in
    agreement with what the streamer loads from the same config (round-1
    drift: the daemon always booted "minimum").
    """
    if phase_type is None:
        try:
            from totton_tpu_torch.web.services.config import load_config

            settings = load_config()
            if settings.filter is not None:
                phase_type = settings.filter.phase_type
        except Exception:
            phase_type = None
    if phase_type in ("min", "minimum"):
        return "minimum"
    if phase_type == "linear":
        return "linear"
    return "minimum"


class ControlDaemon:
    """Registers the command set and owns daemon-side state."""

    def __init__(
        self,
        endpoint: str | None = None,
        pub_endpoint: str | None = None,
        on_reload: Callable[[], None] | None = None,
        on_soft_reset: Callable[[], None] | None = None,
        on_phase_change: Callable[[str], None] | None = None,
        list_devices_fn: Callable[[], dict] | None = None,
        stats_path: str | None = None,
        phase_type: str | None = None,
        heartbeat_s: float = 2.0,
    ) -> None:
        self.endpoint = endpoint or os.environ.get(ENDPOINT_ENV, DEFAULT_ENDPOINT)
        # PUB endpoint: flag > TOTTON_ZMQ_PUB_ENDPOINT env > off. When on,
        # state-changing commands publish JSON events (the reference opens
        # the socket via the same env, docker/entrypoint.sh:10,139, but its
        # shipped daemon never publishes anything; subscribers here get
        # real reload/phase/reset notifications).
        pub_endpoint = pub_endpoint or os.environ.get(PUB_ENDPOINT_ENV)
        self.server = ZmqCommandServer(self.endpoint, pub_endpoint)
        self._on_reload = on_reload
        self._on_soft_reset = on_soft_reset
        self._on_phase_change = on_phase_change
        if list_devices_fn is None:
            from totton_tpu_torch.io.devices import list_devices as list_devices_fn
        self._list_devices = list_devices_fn
        self._stats_path = stats_path or os.environ.get(
            STATS_PATH_ENV, DEFAULT_STATS_PATH
        )

        self.phase_type = _resolve_initial_phase(phase_type)
        self.reload_count = 0
        self.soft_reset_count = 0
        self._start_time = time.monotonic()
        self._shutdown = threading.Event()
        # Delivery robustness for the PUB fan-out: ZMQ PUB/SUB silently
        # drops events for subscribers that haven't finished connecting
        # (slow joiner) or are mid-reconnect. Every state-changing event
        # carries a monotone sequence number, and a periodic "state"
        # heartbeat (seq + phase + shutdown flag) lets followers DETECT a
        # gap and resynchronize instead of diverging forever
        # (control/follower.py). heartbeat_s=0 disables (tests).
        self._event_seq = 0
        self._seq_lock = threading.Lock()
        self._heartbeat_s = heartbeat_s
        self._hb_stop = threading.Event()
        self._hb_thread: threading.Thread | None = None

        s = self.server
        s.register("PING", lambda req: build_ok({"pong": True}))
        s.register("STATS", self._handle_stats)
        s.register("RELOAD", self._handle_reload)
        s.register("SOFT_RESET", self._handle_soft_reset)
        s.register("PHASE_TYPE_GET",
                   lambda req: build_ok({"phase_type": self.phase_type}))
        s.register("PHASE_TYPE_SET", self._handle_phase_set)
        s.register("LIST_ALSA_DEVICES", self._handle_list_devices)
        s.register("list_alsa_devices", self._handle_list_devices)
        s.register("SHUTDOWN", self._handle_shutdown)

    # -- handlers ---------------------------------------------------------

    def _handle_stats(self, req: ZmqRequest) -> str:
        data = {
            "uptime_ms": int((time.monotonic() - self._start_time) * 1000),
            "phase_type": self.phase_type,
            "reloads": self.reload_count,
            "soft_resets": self.soft_reset_count,
        }
        # Merge live stream stats when the streamer emits them.
        try:
            with open(self._stats_path) as f:
                data["stream"] = json.load(f)
        except (OSError, json.JSONDecodeError):
            pass
        return build_ok(data)

    def _publish_event(self, event: str, **payload) -> None:
        """Fire-and-forget PUB notification (no-op without a PUB socket).
        State-changing events are numbered so followers can detect drops."""
        with self._seq_lock:
            self._event_seq += 1
            seq = self._event_seq
        self.server.publish(json.dumps({"event": event, "seq": seq,
                                        **payload}))

    def _publish_state(self) -> None:
        """The heartbeat: current seq + state, NOT seq-incrementing. A
        follower whose applied seq lags this one missed a published event
        and resyncs from the carried state."""
        with self._seq_lock:
            seq = self._event_seq
        self.server.publish(json.dumps({
            "event": "state", "seq": seq, "phase_type": self.phase_type,
            "reloads": self.reload_count,
            "shutdown": self._shutdown.is_set(),
        }))

    def _heartbeat_loop(self) -> None:
        while not self._hb_stop.wait(self._heartbeat_s):
            self._publish_state()

    def _handle_reload(self, req: ZmqRequest) -> str:
        self.reload_count += 1
        # A callback may return extra event payload — notably
        # apply_at_step for step-synchronized multi-host swaps (the
        # leader's engine stamps the boundary; followers schedule the
        # same step from the published value, parallel/sharded.py
        # schedule_swap).
        extra = {}
        if self._on_reload is not None:
            extra = self._on_reload() or {}
        self._publish_event("reload", count=self.reload_count,
                            phase_type=self.phase_type, **extra)
        return build_ok({"reloaded": True, **extra})

    def _handle_soft_reset(self, req: ZmqRequest) -> str:
        self.soft_reset_count += 1
        if self._on_soft_reset is not None:
            self._on_soft_reset()
        # phase_type rides every event so a follower detecting a seq gap
        # can converge from the event itself (follower._resync).
        self._publish_event("soft_reset", count=self.soft_reset_count,
                            phase_type=self.phase_type)
        return build_ok({"reset": True})

    def _handle_phase_set(self, req: ZmqRequest) -> str:
        phase = req.param("phase", "phase_type") or ""
        if phase == "min":
            phase = "minimum"
        if phase not in ("minimum", "linear"):
            return build_error("INVALID_PARAMS",
                               "phase must be minimum or linear")
        # Callback first: a failed engine swap (e.g. no linear filter on
        # disk) raises -> dispatch returns INTERNAL and the reported phase
        # stays what the engine is actually running.
        extra = {}
        if self._on_phase_change is not None:
            extra = self._on_phase_change(phase) or {}
        self.phase_type = phase
        self._publish_event("phase_type", phase_type=phase, **extra)
        return build_ok({"phase_type": self.phase_type, **extra})

    def _handle_list_devices(self, req: ZmqRequest) -> str:
        return build_ok(self._list_devices())

    def _handle_shutdown(self, req: ZmqRequest) -> str:
        # Publish BEFORE signaling shutdown: once the server stops, the PUB
        # socket is gone and followers would never hear it.
        self._publish_event("shutdown", phase_type=self.phase_type)
        self._shutdown.set()
        return build_ok({"shutdown": True})

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        self.server.start()
        if self._heartbeat_s > 0 and self.server.pub_endpoint:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, daemon=True,
                name="totton-control-heartbeat")
            self._hb_thread.start()

    def stop(self) -> None:
        if self._hb_thread is not None:
            self._hb_stop.set()
            self._hb_thread.join(timeout=5)
            self._hb_thread = None
        if self._shutdown.is_set() and self.server.pub_endpoint:
            # One last state heartbeat with the shutdown flag, then a
            # short grace so the PUB socket flushes before closing —
            # a follower that missed the single "shutdown" event still
            # hears it here.
            self._publish_state()
            time.sleep(0.05)
        self.server.stop()

    def wait_for_shutdown(self, timeout: float | None = None) -> bool:
        return self._shutdown.wait(timeout)

    @property
    def shutdown_requested(self) -> bool:
        return self._shutdown.is_set()
