"""The port's utils/profiling: BlockTimer (a copy of the reference's) and
trace_context on torch.profiler, on the CPU: no-op without a directory,
one Chrome trace with one."""

import json
import time

import pytest

torch = pytest.importorskip("torch")

from totton_tpu.utils.profiling import BlockTimer as JaxBlockTimer
from totton_tpu_torch.utils.profiling import (
    NO_KERNEL_SUFFIX,
    BlockTimer,
    check_kernel_records,
    trace_context,
)


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


def _fake_trace(path, kernels: int):
    """A recorded-shape Chrome trace: two cudaLaunchKernel runtime events
    and ``kernels`` kernel records."""
    events = [{"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 0,
               "dur": 5, "pid": 1, "tid": 1}]
    events += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": 10 * i, "dur": 3, "pid": 1, "tid": 1,
                "args": {"correlation": i}} for i in range(2)]
    events += [{"ph": "X", "cat": "kernel", "name": "fft_stage<...>",
                "ts": 20 + i, "dur": 50, "pid": 0, "tid": 7,
                "args": {"correlation": i}} for i in range(kernels)]
    path.write_text(json.dumps({"traceEvents": events}))


def test_trace_without_kernel_records_is_marked(tmp_path, caplog):
    path = tmp_path / "trace_1_2.json"
    _fake_trace(path, kernels=0)
    with caplog.at_level("WARNING"):
        marked = check_kernel_records(str(path))
    assert marked == str(tmp_path / f"trace_1_2{NO_KERNEL_SUFFIX}.json")
    assert not path.exists()
    trace = json.loads(open(marked).read())
    assert trace["tottonKernelRecords"]["launches"] == 2
    assert trace["tottonKernelRecords"]["kernel_records"] == 0
    assert len(trace["traceEvents"]) == 3
    assert "no kernel record" in caplog.text


def test_trace_with_kernel_records_is_left_alone(tmp_path):
    path = tmp_path / "trace_1_3.json"
    _fake_trace(path, kernels=2)
    before = path.read_text()
    assert check_kernel_records(str(path)) == str(path)
    assert path.read_text() == before


def test_cpu_trace_is_not_checked(tmp_path):
    """A window without CUDA activity has no launches: nothing is marked
    (and trace_context checks only CUDA windows)."""
    with trace_context(str(tmp_path)):
        torch.ones(8).sum()
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1 and NO_KERNEL_SUFFIX not in files[0].name
    assert check_kernel_records(str(files[0])) == str(files[0])
