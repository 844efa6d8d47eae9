"""Shared pieces of the benchmark's CPU tests: tiny cells of the real
configurations and traffic, run by ``run.run_cell`` on the CPU."""

from __future__ import annotations

import copy
import json

import pytest

from portbench import run


def tiny(cell_name: str, clients: int = 2, traffic: str | None = None
         ) -> dict:
    """The cell (with another traffic mix where ``traffic`` names one)
    at two slots and two clients, short tracks and segments: the same
    harness, server path and comparison at a size a CPU holds."""
    cell = copy.deepcopy(run.load_cell(cell_name))
    if traffic is not None:
        cell["traffic"] = json.loads(
            (run.PKG / "traffic" / f"{traffic}.json").read_text())
    cell["config"]["serve_flags"]["max_streams"] = clients
    cell["traffic"].update(clients=clients, processes=1, loadgen_cores=0,
                           warmup_s=0.5, drain_s=60.0,
                           capture={"frames": 2048, "every_s": 0.3})
    if cell["traffic"]["mode"] == "closed":
        cell["traffic"]["track_s"] = [30.0, 30.0]
    return cell


@pytest.fixture
def tiny_cell():
    return tiny
