"""``correct`` comes out false when the timed path is broken underneath:
once for each fault a serve cell can have. The harness runs as a check
would, with the look for a card skipped: on the CPU at a tiny size, and on
the card at each cell's own stream count and step shapes. (A served stream
crosses no chip, so no exchange can be left out.)"""

from __future__ import annotations

import pytest
import torch

from portbench import run


def state_unchanged(server):
    """Every step leaves the streams' overlap-save tails as they were."""
    gather = server._gather

    def frozen():
        tails = {id(s): s.tail.copy() for s in server.slots}
        batch = gather()
        for s in server.slots:
            s.tail = tails[id(s)]
        return batch

    server._gather = frozen


def half_the_batch(server):
    """Each step computes only the first half of the streams it serves:
    the rows of the served slots in the second half of its list (at
    least one slot) come back as zeros, whatever padding the step has."""
    gather, step = server._gather, server._step
    last = []

    def gathered():
        batch = gather()
        last[:] = [] if batch is None else batch[2]
        return batch

    def half(tail, x, bundle):
        y, t = step(tail, x, bundle)
        if last:
            y = y.clone()
            for _slot, r0, *_rest in last[len(last) // 2:]:
                y[r0:r0 + server.channels] = 0
        return y, t

    server._gather, server._step = gathered, half


def answer_altered(server):
    """One output sample of every step is changed where it is produced."""
    step = server._step

    def altered(tail, x, bundle):
        y, t = step(tail, x, bundle)
        y = y.clone()
        y[:, 100] += 0.01
        return y, t

    server._step = altered


@pytest.mark.parametrize("traffic", ["bulk", "live"])
@pytest.mark.parametrize("fault", [state_unchanged, half_the_batch,
                                   answer_altered])
def test_fault_is_not_correct(tiny_cell, traffic, fault):
    r = run.run_cell(tiny_cell("serve8k.live", traffic=traffic), 777, 1.5,
                     False, device="cpu", fault=fault)
    assert r["correct"] is False, r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", ["serve8k.live", "serve80k.live"])
@pytest.mark.parametrize("fault", [state_unchanged, half_the_batch,
                                   answer_altered])
def test_fault_is_not_correct_at_the_cells_load(cell_name, fault):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    r = run.run_cell(run.load_cell(cell_name), 2**32 + 11, 5.0, False,
                     fault=fault)
    assert r["correct"] is False, r["checks"]


def test_sound_run_is_correct_with_f32_wire(tiny_cell):
    """The f32 wire at the 8k bank on the CPU: the configured limit of the
    80k configuration holds for the program, and fails for a fault."""
    cell = tiny_cell("serve8k.live", traffic="bulk")
    f32 = run.load_cell("serve80k.live")["config"]
    cell["config"]["serve_flags"]["device_pcm"] = False
    cell["config"].update(wire="f32", check=f32["check"])
    r = run.run_cell(cell, 4242, 1.5, False, device="cpu")
    assert r["correct"] is True, r["checks"]
    r = run.run_cell(cell, 4242, 1.5, False, device="cpu",
                     fault=answer_altered)
    assert r["correct"] is False, r["checks"]
