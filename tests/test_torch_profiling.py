"""The port's utils/profiling: BlockTimer (a copy of the reference's) and
trace_context on torch.profiler, on the CPU: no-op without a directory,
one Chrome trace with one."""

import json
import time

import torch

from totton_tpu.utils.profiling import BlockTimer as JaxBlockTimer
from totton_tpu_torch.utils.profiling import BlockTimer, trace_context


def test_block_timer_summary_keys_match_the_reference():
    timers = (BlockTimer(capacity=4), JaxBlockTimer(capacity=4))
    for t in timers:
        assert t.summary() == {"count": 0}
        for _ in range(6):
            with t.measure():
                time.sleep(0.001)
    a, b = (t.summary() for t in timers)
    assert a.keys() == b.keys()
    assert a["count"] == b["count"] == 6
    assert a["p50_ms"] <= a["p95_ms"] <= a["p99_ms"] <= a["max_ms"]


def test_trace_context_noop_without_dir(monkeypatch, tmp_path):
    monkeypatch.delenv("TOTTON_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with trace_context():
        x = torch.ones(4).sum().item()
    assert x == 4.0
    assert list(tmp_path.iterdir()) == []


def test_trace_context_writes_a_chrome_trace(tmp_path):
    trace_dir = tmp_path / "traces"
    with trace_context(str(trace_dir)):
        torch.matmul(torch.ones((64, 64)), torch.ones((64, 64))).sum()
    files = list(trace_dir.glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("matmul" in str(ev.get("name", "")) for ev in events)


def test_trace_context_reads_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("TOTTON_TRACE_DIR", str(tmp_path))
    with trace_context():
        torch.ones(8).cumsum(0)
    assert len(list(tmp_path.glob("trace_*.json"))) == 1
