"""The load generator paces every schedule at the configuration's input
rate: at 44100 frames a second each value is the one it has always been,
and a paced cell at another rate delivers its offered load."""

from __future__ import annotations

import json

import numpy as np
import pytest

from portbench import audio, loadgen, run

RATES = (44100, 48000, 96000, 192000, 384000)


def traffic_file(name: str) -> dict:
    return json.loads((run.PKG / "traffic" / f"{name}.json").read_text())


def plan_at(rate: int) -> dict:
    """A paced stream's plan, as ``run.drive`` writes it, at ``rate``."""
    config = json.loads((run.PKG / "configs" / "serve_16x_8k_s16.json")
                        .read_text())
    traffic = traffic_file("live")
    return dict(wire=config["wire"], traffic=traffic,
                capture=traffic["capture"],
                geometry=dict(channels=2, rate=rate, ratio=config["ratio"],
                              block_in=config["block_size"]
                              // config["ratio"],
                              block_size=config["block_size"]))


@pytest.mark.parametrize("rate", RATES)
def test_schedule_follows_the_rate(rate):
    """Period, burst, track length, phase, capture spacing and every
    block's due time equal their formulas at ``rate``; at 44100 those are
    the expressions the generator has always used (``audio.RATE``), bit
    for bit."""
    r = audio.RATE if rate == 44100 else rate
    plan = plan_at(rate)
    geo, live = plan["geometry"], plan["traffic"]
    seed = audio.stream_seed(2**31 + 777, 3)
    st = loadgen.Stream(3, seed, plan)

    assert loadgen.pace(live, rate)[1] == live["period_frames"] / r
    bulk = traffic_file("bulk")
    assert loadgen.pace(bulk, rate)[0] == int(bulk["burst_s"] * r)

    rng = np.random.default_rng([seed, 2])
    assert st.track_frames == int(rng.uniform(*live["track_s"]) * r)
    spread = live["phase_spread_blocks"] * geo["block_in"]
    assert st.phase_s == float(rng.uniform(0.0, spread / r))
    assert 0.0 <= st.phase_s < spread / rate

    every = float(plan["capture"]["every_s"]) * r * geo["ratio"]
    starts, a = [0], 0.0
    while a < st.track_frames * geo["ratio"] and len(starts) < 4096:
        a += max(rng.uniform(0.5, 1.5) * every, 2 * st.seg_frames)
        starts.append(int(a))
    assert [s for s, _buf in st.captures] == starts

    t0, ws, we = 100.0, 101.0, 104.0
    due = st.result(t0, ws, we)["block_due"]
    period = live["period_frames"]
    want = []
    for b in range(10**6):
        last = (b + 1) * geo["block_in"] - 1
        d = t0 + st.phase_s + (last // period) * period / r
        if d >= we:
            break
        if d >= ws:
            want.append(d)
    assert due.tolist() == want
    # A block falls due every block period, to within a period.
    block_s = geo["block_in"] / rate
    assert len(due) == pytest.approx((we - ws) / block_s, abs=1.5)
    assert np.abs(np.diff(due) - block_s).max() <= period / rate


@pytest.mark.parametrize("rate,ratio,bank", [
    (48000, 16, "filter_48k_16x_8000_min_phase"),
    (192000, 4, "filter_48k_4x_8000_min_phase"),
])
def test_paced_cell_offers_its_load(tiny_cell, rate, ratio, bank):
    """The tiny live cell on another bank family and rate: correct, no
    block lost, the run's line gives the offered load, and each client
    sends ``rate`` frames a second from the traffic's start to its end,
    to within its phase and a period (it sent 44100 of them when the
    schedule ran at 44100). What the clients receive follows what the
    server on this host can serve: at most the offered load and the
    warm-up's backlog."""
    cell = tiny_cell("serve8k.live")
    config, traffic = cell["config"], cell["traffic"]
    meta = json.loads((run.ROOT / config["serve_flags"]["filter_dir"]
                       / f"{bank}.json").read_text())
    config["serve_flags"].update(rate=rate, ratio=ratio)
    config.update(filter=bank, taps=meta["taps"], fft_size=meta["fft_size"],
                  block_size=meta["block_size"], ratio=ratio)
    seconds, ctx = 2.0, {}
    r = run.run_cell(cell, 2**31 + 12345, seconds, False, device="cpu",
                     out=ctx)
    info = r.pop("info")
    offered = 2 * 2 * rate * ratio
    delivered = r["metrics"]["out_samples_per_s"]["value"]
    assert r["correct"] is True and r["failed"] == 0
    assert info["offered_samples_per_s"] == offered
    assert info["out_samples_per_s"] == delivered
    assert 0 < delivered <= 1.25 * offered
    want = rate * (traffic["warmup_s"] + seconds)
    slack = meta["block_size"] // ratio + traffic["period_frames"]
    for s in ctx["streams"]:
        assert abs(s["sent_frames"] - want) <= slack
