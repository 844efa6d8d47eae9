"""The harness finds a configuration, a traffic mix and a metric reader
added as new files and entries, with no edit to its code; a tiny run on
the CPU prints a well-formed result; a run without a card exits non-zero
with no result."""

from __future__ import annotations

import json
import shutil
import time

import pytest
import torch

from portbench import run


def test_new_files_are_picked_up(tmp_path):
    pkg = tmp_path / "portbench"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(run.PKG / sub, pkg / sub)
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    config = json.loads((run.PKG / "configs" / "serve_16x_8k_s16.json")
                        .read_text())
    config["serve_flags"]["latency"] = "normal"
    (pkg / "configs" / "new_cfg.json").write_text(json.dumps(config))
    (pkg / "traffic" / "new_mix.json").write_text(json.dumps(
        {"mode": "paced", "clients": 3, "processes": 1, "period_frames": 128,
         "warmup_s": 1.0, "drain_s": 10.0,
         "capture": {"frames": 64, "every_s": 1.0}}))
    (pkg / "metrics" / "new.metric.py").write_text(
        "def read(ctx):\n    return ctx['seconds'] * 2\n")
    bench["configs"].append({"name": "new_cfg", "source": "a test",
                             "file": "portbench/configs/new_cfg.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "new.cell", "config": "new_cfg",
                               "traffic": "new_mix", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "new.metric", "unit": "s",
                               "better": "lower", "source": "host_clock",
                               "layer": "test", "moves": "out_samples_per_s",
                               "workloads": ["new.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = run.load_cell("new.cell", root=tmp_path, pkg=pkg)
    assert cell["config"]["serve_flags"]["latency"] == "normal"
    assert cell["traffic"]["period_frames"] == 128
    assert run.clients_of(cell["traffic"], "new_cfg") == 3
    names = [m["name"] for m in run.metrics_of(cell, trace=True)]
    assert "new.metric" in names and "devstep_roofline" not in names
    assert run.load_reader(pkg, "new.metric")({"seconds": 4}) == 8
    e2e = [m["name"] for m in run.metrics_of(cell, trace=False)]
    assert e2e == ["setup_s", "out_samples_per_s"]


def test_every_entry_has_its_file():
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = run.load_cell(w["name"])
        assert cell["config"]["name"] == w["config"]
        for m in run.metrics_of(cell, True) + run.metrics_of(cell, False):
            assert callable(run.load_reader(run.PKG, m["name"]))


def test_tiny_run_prints_a_well_formed_result(tiny_cell):
    cell = tiny_cell("serve8k.live")
    r = run.run_cell(cell, 2**31 + 12345, 2.0, False, device="cpu")
    info = r.pop("info")
    assert list(r)[-1] == "checks" and r["correct"] is True
    assert set(r) >= {"correct", "attempted", "failed", "metrics", "device"}
    json.loads(json.dumps(r, allow_nan=False))
    assert set(r["metrics"]) == {"setup_s", "out_samples_per_s"}
    assert r["metrics"]["out_samples_per_s"]["value"] == pytest.approx(
        2 * 2 * 44100 * 16, rel=0.05)
    assert r["failed"] == 0 and r["attempted"] > 300
    assert info["segments"] >= 4
    assert r["checks"]["max_lsb"]["value"] <= r["checks"]["max_lsb"]["limit"]


def test_tiny_bulk_run_is_correct(tiny_cell):
    r = run.run_cell(tiny_cell("serve8k.live", traffic="bulk"), 2**33 + 5,
                     2.0, False, device="cpu")
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] == 2
    assert r["metrics"]["out_samples_per_s"]["value"] > 0


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = run.main(["--workload", "serve8k.live", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_traced_run_records_spans_only_after_the_window(tiny_cell,
                                                        monkeypatch):
    """A ``--trace 1``-shaped run on the CPU (the profiler's windows
    stood in for by a wait under the same traffic): the spans are off
    over the measured window, on over the windows, off again before the
    drain, and ``ctx["spans"]`` holds what they recorded. An untraced run
    records none."""
    from portbench import trace

    state = {}

    def windows(seconds, count, snapshot, until):
        state["on"] = state["server"].spans.on
        time.sleep(1.0)
        return []

    monkeypatch.setattr(run, "PROFILED", ("cuda", "cpu"))
    monkeypatch.setattr(run, "TRACE_AFTER_S", 2.0)
    monkeypatch.setattr(trace, "warm_profiler", lambda: None)
    monkeypatch.setattr(trace, "take_windows", windows)
    ctx = {}
    r = run.run_cell(tiny_cell("serve8k.live"), 2**32 + 4321, 1.5, True,
                     device="cpu", fault=lambda s: state.update(server=s),
                     out=ctx)
    assert r["correct"] is True and state["on"] is True
    # The measured window's block latency is read in a traced run too.
    lat = r["metrics"]
    assert 0 < lat["block_p50_ms"]["value"] <= lat["block_p95_ms"]["value"]
    assert state["server"].spans.on is False
    snap = ctx["spans"]
    assert snap["dropped"] == 0 and snap["num"].size > 0
    # Nothing opened before the measured window's end was recorded.
    assert snap["t0"].min() >= ctx["measured"][1]["t_ns"]
    assert "serve.gather" in {snap["names"][i] for i in snap["name"]}
    assert r["info"]["spans"] == dict(dropped=0,
                                      records=int(snap["num"].size))
    for s in ctx["measured"]:
        assert len(s["block_latency"]) > 0 and "clock_offset_ns" in s

    ctx = {}
    r = run.run_cell(tiny_cell("serve8k.live"), 2**32 + 4321, 1.5, False,
                     device="cpu", fault=lambda s: state.update(server=s),
                     out=ctx)
    assert r["correct"] is True and ctx["spans"] is None
    assert "spans" not in r["info"]
    assert state["server"].spans.snapshot()["num"].size == 0
