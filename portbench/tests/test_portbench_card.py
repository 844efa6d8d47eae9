"""On the card: a short run of each cell is correct, and its control (the
reference in TF32 in the program's place, at the cell's own size) is
not. Skips without a card."""

from __future__ import annotations

import pytest
import torch

from portbench import run


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", ["serve8k.live", "serve80k.live"])
def test_cell_correct_and_control_not(cell_name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    r = run.run_cell(run.load_cell(cell_name), 2**32 + 7, 5.0, False,
                     control=True)
    assert r["correct"] is True, r["checks"]
    control = r["info"]["control"]
    name = "max_lsb" if "max_lsb" in control else "max_rel"
    assert control[name]["value"] > control[name]["limit"]
