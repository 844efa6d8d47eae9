"""On the card: a short run of ``serve4x192k.live`` (192 kHz input served
4x on the 80k bank, the frame kernel's four-launch plan) is correct, its
control (the reference in TF32 in the program's place) is not, and each
fault of ``test_portbench_faults.py`` reads false at the cell's own
stream count. Skips without a card."""

from __future__ import annotations

import pytest
import torch
from test_portbench_faults import answer_altered, half_the_batch, \
    state_unchanged

from portbench import run

CELL = "serve4x192k.live"


@pytest.mark.cuda
def test_cell_correct_and_control_not():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    r = run.run_cell(run.load_cell(CELL), 2**32 + 192, 5.0, False,
                     control=True)
    assert r["correct"] is True, r["checks"]
    control = r["info"]["control"]["max_rel"]
    assert control["value"] > control["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [state_unchanged, half_the_batch,
                                   answer_altered])
def test_fault_is_not_correct_at_the_cells_load(fault):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    r = run.run_cell(run.load_cell(CELL), 2**32 + 193, 5.0, False,
                     fault=fault)
    assert r["correct"] is False, r["checks"]
