"""Daemon access for the web layer: liveness + stats-file reading.

Parity with the reference's web/services/daemon.py: PING check via the ZMQ
client, and tolerant stats-file parsing (multiple legacy key shapes).
"""

from __future__ import annotations

import json
from typing import Any

from totton_tpu_torch.control.client import DaemonClient
from totton_tpu_torch.web.constants import STATS_FILE_PATH, ZMQ_ENDPOINT


def get_client(timeout_ms: int = 1000) -> DaemonClient:
    return DaemonClient(endpoint=ZMQ_ENDPOINT, timeout_ms=timeout_ms)


def check_daemon_running() -> bool:
    return get_client(timeout_ms=500).ping()


def read_stats_file() -> dict[str, Any]:
    """Streamer stats with fallback key shapes (legacy compat)."""
    try:
        data = json.loads(STATS_FILE_PATH.read_text())
    except (OSError, json.JSONDecodeError):
        return {}
    if not isinstance(data, dict):
        return {}
    out = dict(data)
    # Normalize legacy shapes: {inputRate,outputRate} and {rates:{in,out}}.
    rates = out.get("rates") if isinstance(out.get("rates"), dict) else {}
    out.setdefault("input_rate", out.get("inputRate", rates.get("in", 0)) or 0)
    out.setdefault("output_rate", out.get("outputRate", rates.get("out", 0)) or 0)
    xruns = out.get("xruns")
    if isinstance(xruns, dict):
        out["xrun_total"] = sum(
            v for v in xruns.values() if isinstance(v, (int, float))
        )
    elif isinstance(xruns, (int, float)):
        out["xrun_total"] = xruns
    else:
        out["xrun_total"] = 0
    return out


def read_serve_stats_file() -> dict[str, Any] | None:
    """totton-serve aggregate stats, when a serving plane runs on this
    host (TOTTON_SERVE_STATS_PATH; totton_tpu/serve.py _write_stats)."""
    import json
    import os

    path = os.environ.get("TOTTON_SERVE_STATS_PATH",
                          "/tmp/totton_serve_stats.json")
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    return data if isinstance(data, dict) else None


def get_full_status() -> dict[str, Any]:
    """Merged view: daemon ping + ZMQ stats + stream stats file
    (the reference's /api/status composition, web/routers/status.py),
    plus the serving plane's aggregate when one runs on this host."""
    client = get_client()
    running = client.ping()
    status: dict[str, Any] = {"daemon_running": running}
    if running:
        stats = client.stats()
        if stats.ok and isinstance(stats.data, dict):
            status["daemon"] = stats.data
    status["stream"] = read_stats_file()
    serve = read_serve_stats_file()
    if serve is not None:
        status["serve"] = serve
    return status
