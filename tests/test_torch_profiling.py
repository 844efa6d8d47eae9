"""The port's utils/profiling: BlockTimer (a copy of the reference's),
trace_context on torch.profiler, on the CPU: no-op without a directory,
one Chrome trace with one; and the Spans recorder: off it records nothing,
reads no clock and allocates nothing, a full ring counts what it
overwrote, parents link, thread CPU stays within the wall time, and its
Chrome export loads."""

import json
import threading
import time
import tracemalloc

import pytest

torch = pytest.importorskip("torch")

from totton_tpu.utils.profiling import BlockTimer as JaxBlockTimer
from totton_tpu_torch.utils import profiling
from totton_tpu_torch.utils.profiling import (
    NO_KERNEL_SUFFIX,
    BlockTimer,
    Spans,
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


def _sites(sp: Spans, items: list) -> None:
    """The serve plane's span site, once per item."""
    for _ in items:
        tok = sp.open("serve.gather", 3) if sp.on else -1
        sp.close(tok)


def test_spans_off_record_nothing_and_read_no_clock(monkeypatch):
    calls = {"perf": 0, "thread": 0}
    perf, thread = time.perf_counter_ns, time.thread_time_ns

    def counted(name, fn):
        def wrapped():
            calls[name] += 1
            return fn()
        return wrapped

    monkeypatch.setattr(profiling.time, "perf_counter_ns",
                        counted("perf", perf))
    monkeypatch.setattr(profiling.time, "thread_time_ns",
                        counted("thread", thread))
    sp = Spans(capacity=8)
    _sites(sp, [None] * 1000)
    assert calls == {"perf": 0, "thread": 0}
    snap = sp.snapshot()
    assert snap["num"].size == 0 and snap["dropped"] == 0
    sp.start()
    _sites(sp, [None] * 3)
    assert calls == {"perf": 6, "thread": 6}
    sp.stop()
    _sites(sp, [None] * 100)
    assert calls == {"perf": 6, "thread": 6}
    assert sp.snapshot()["num"].size == 3


def test_spans_off_allocate_nothing():
    """Ten thousand sites allocate no more than one: the loop's own
    iterator is all there is."""
    sp = Spans(capacity=8)
    growth = {}
    for n in (1, 10000):
        items = [None] * n
        _sites(sp, items)  # warm the code path
        tracemalloc.start()
        try:
            before = tracemalloc.get_traced_memory()[0]
            tracemalloc.reset_peak()
            _sites(sp, items)
            current, peak = tracemalloc.get_traced_memory()
        finally:
            tracemalloc.stop()
        assert current == before
        growth[n] = peak - before
    assert growth[10000] == growth[1] <= 64


def test_spans_ring_counts_what_it_overwrote():
    sp = Spans(capacity=4)
    sp.start()
    toks = [sp.open("serve.read", i) for i in range(10)]
    for t in toks:
        sp.close(t)
    snap = sp.snapshot()
    assert snap["dropped"] == 6 and sp.dropped == 6
    assert snap["key"].tolist() == [6, 7, 8, 9]
    assert snap["open"] == 0
    # start() forgets the earlier records; an open span is not a record
    # yet, and a close of an overwritten record changes nothing.
    sp.start()
    t = sp.open("serve.write", 1, 2)
    assert sp.snapshot()["num"].size == 0 and sp.snapshot()["open"] == 1
    sp.close(t)
    sp.close(toks[0])
    snap = sp.snapshot()
    assert snap["num"].size == 1 and snap["dropped"] == 0
    assert snap["names"][snap["name"][0]] == "serve.write"
    assert (snap["key"][0], snap["gen"][0]) == (1, 2)


def test_spans_parents_cpu_and_threads():
    sp = Spans()
    sp.start()
    outer = sp.open("serve.enqueue", 7)
    inner = sp.open("serve.upload", 7, parent=outer)
    deadline = time.perf_counter() + 0.02
    while time.perf_counter() < deadline:  # on the CPU
        pass
    sp.close(inner)
    wait = sp.open("serve.launch", 7, parent=outer)
    time.sleep(0.02)  # off the CPU
    sp.close(wait)
    sp.close(outer)

    def other():
        sp.close(sp.open("serve.read", 1, 4))

    th = threading.Thread(target=other)
    th.start()
    th.join(timeout=10)
    assert not th.is_alive()
    sp.add("serve.drain_wait", 10, 30, 5, 7, parent=outer)
    snap = sp.snapshot()
    names = [snap["names"][i] for i in snap["name"]]
    assert names == ["serve.enqueue", "serve.upload", "serve.launch",
                     "serve.read", "serve.drain_wait"]
    nums = snap["num"].tolist()
    assert snap["parent"].tolist() == [-1, nums[0], nums[0], -1, nums[0]]
    wall = snap["t1"] - snap["t0"]
    assert (snap["cpu"][:4] <= wall[:4]).all()
    assert snap["cpu"][2] < 0.5 * wall[2]   # sleep: off the CPU
    assert snap["cpu"][1] > 10 * snap["cpu"][2]   # busy loop: on it
    for child in (1, 2):
        assert snap["t0"][0] <= snap["t0"][child] <= snap["t1"][child] \
            <= snap["t1"][0]
    assert snap["tid"][3] != snap["tid"][0]
    assert (snap["t0"][4], snap["t1"][4], snap["cpu"][4]) == (10, 30, 5)


def test_spans_write_chrome_loads(tmp_path):
    sp = Spans()
    sp.start()
    outer = sp.open("serve.drain", 2)
    sp.close(sp.open("serve.write", 0, 1, parent=outer))
    sp.close(outer)
    path = sp.write_chrome(str(tmp_path / "d" / "spans_1_2.json"))
    trace = json.loads(open(path).read())
    events = trace["traceEvents"]
    assert [e["name"] for e in events] == ["serve.drain", "serve.write"]
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)
    assert events[1]["args"]["parent"] == events[0]["args"]["num"]
    assert events[1]["args"]["gen"] == 1
    assert trace["tottonSpans"]["dropped"] == 0
