"""Control-plane fan-out for multi-host streams: the follower side.

On a multi-process mesh only process 0 (the leader) serves the REQ/REP
command endpoint; it publishes every state-changing command as a JSON
event on its PUB socket (control/daemon.py _publish_event). Followers
subscribe and replay the same action on their local engine shard, so a
single RELOAD / PHASE_TYPE_SET / SOFT_RESET / SHUTDOWN reaches every
host's spectrum — without it, a swap applied on one host would diverge
the replicated filter spectrum across the mesh (and with time sharding,
eventually the audio at shard boundaries).

The reference has no multi-host path at all (SURVEY.md §2.3); its PUB
socket exists but nothing ever publishes or subscribes
(src/zmq/command_server.cpp:189-207).

Delivery model: ZMQ PUB/SUB gives no delivery guarantee — a subscriber
still connecting (slow joiner) or mid-reconnect silently loses messages.
Every state-changing event therefore carries a monotone `seq`, and the
leader publishes a periodic `state` heartbeat (current seq + phase +
shutdown flag). A follower whose applied seq lags resynchronizes from the
carried state (phase -> filter reload, which also re-reads config EQ);
a missed SOFT_RESET is deliberately not replayed late (its effect is
transient and a late replay would itself glitch the audio). A follower
that missed the shutdown event hears it from the heartbeat's flag, and
the leader flushes one final flagged heartbeat before closing its PUB
socket.
"""

from __future__ import annotations

import json
import sys
import threading
from typing import Callable


class ControlFollower:
    """Subscribes to a leader ControlDaemon's PUB endpoint and applies its
    events via the same callbacks the leader's daemon uses locally."""

    def __init__(
        self,
        pub_endpoint: str,
        on_reload: Callable[[], None] | None = None,
        on_soft_reset: Callable[[], None] | None = None,
        on_phase_change: Callable[[str], None] | None = None,
        on_shutdown: Callable[[], None] | None = None,
    ) -> None:
        self.pub_endpoint = pub_endpoint
        self._on_reload = on_reload
        self._on_soft_reset = on_soft_reset
        self._on_phase_change = on_phase_change
        self._on_shutdown = on_shutdown
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        #: events successfully applied (observability/test hook)
        self.applied: list[str] = []
        # Highest leader event seq this follower has applied. ZMQ PUB/SUB
        # silently drops messages for a subscriber that is still
        # connecting (slow joiner) or mid-reconnect; the leader's periodic
        # "state" heartbeat carries its current seq, so a gap here is
        # DETECTED and closed by resync instead of diverging forever.
        self.seq_applied = 0
        self._shutdown_seen = False

    def _resync(self, msg: dict) -> None:
        """Missed event(s): converge on the heartbeat's carried state.

        on_phase_change(phase) reloads the right filter family (and the
        CLI's callback re-reads config EQ on the way); a missed SOFT_RESET
        is NOT replayed — it is a transient action whose effect (flushed
        history) cannot be reconstructed late, and replaying it seconds
        after the leader's would itself glitch the audio.
        """
        phase = msg.get("phase_type")
        if phase in ("minimum", "linear") and self._on_phase_change:
            self._on_phase_change(phase)
        elif self._on_reload:
            self._on_reload()
        self.applied.append("resync")

    @staticmethod
    def _call(fn, msg: dict, *args) -> None:
        """Invoke a callback, forwarding apply_at_step (the leader's
        step-synchronized swap boundary, daemon _handle_reload) when the
        callback can take it — signatures without it keep working."""
        import inspect

        kwargs = {}
        if "apply_at_step" in msg:
            try:
                params = inspect.signature(fn).parameters
                if "apply_at_step" in params or any(
                        p.kind == p.VAR_KEYWORD for p in params.values()):
                    kwargs["apply_at_step"] = msg.get("apply_at_step")
            except (TypeError, ValueError):
                pass
        fn(*args, **kwargs)

    def _apply(self, msg: dict) -> None:
        event = msg.get("event")
        seq = msg.get("seq")
        if event == "state":
            if isinstance(seq, int) and seq > self.seq_applied:
                self._resync(msg)
                self.seq_applied = seq
            if msg.get("shutdown") and not self._shutdown_seen:
                self._shutdown_seen = True
                if self._on_shutdown:
                    self._on_shutdown()
            return
        # Seq gap on a direct event: events were dropped between the last
        # applied one and this one. A missed phase change means the
        # follower's LOCAL phase notion is stale — even a reload applied
        # with it would not converge — so resync from the event's carried
        # leader phase first, then apply the event's own action.
        gap = isinstance(seq, int) and seq > self.seq_applied + 1
        if gap:
            self._resync(msg)
        if gap and event == "phase_type":
            pass  # the resync above already applied the leader's phase
        elif event == "reload" and self._on_reload:
            self._call(self._on_reload, msg)
        elif event == "soft_reset" and self._on_soft_reset:
            self._on_soft_reset()
        elif event == "phase_type" and self._on_phase_change:
            phase = msg.get("phase_type")
            if phase in ("minimum", "linear"):
                self._call(self._on_phase_change, msg, phase)
        elif event == "shutdown":
            if not self._shutdown_seen and self._on_shutdown:
                self._shutdown_seen = True
                self._on_shutdown()
        if isinstance(seq, int):
            self.seq_applied = max(self.seq_applied, seq)
        self.applied.append(str(event))

    def _run(self) -> None:
        import zmq

        ctx = zmq.Context.instance()
        sub = ctx.socket(zmq.SUB)
        sub.setsockopt(zmq.LINGER, 0)
        sub.setsockopt_string(zmq.SUBSCRIBE, "")
        sub.connect(self.pub_endpoint)
        poller = zmq.Poller()
        poller.register(sub, zmq.POLLIN)
        try:
            while not self._stop.is_set():
                if not poller.poll(100):
                    continue
                raw = sub.recv_string()
                try:
                    msg = json.loads(raw)
                except json.JSONDecodeError:
                    continue
                try:
                    self._apply(msg)
                except Exception as e:  # keep following on a failed apply
                    print(f"control follower: {msg.get('event')} failed: {e}",
                          file=sys.stderr)
        finally:
            sub.close(0)

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="totton-control-follower")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
