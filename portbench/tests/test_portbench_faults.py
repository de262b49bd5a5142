"""A whole run of each cell, at a tiny size on the CPU with the harness's
look for a card skipped, comes out correct; with each fault the cell can
have planted under the timed path it comes out not correct."""
import pytest
import torch

from portbench import run
from portbench.harness import faults
from portbench.tests.tiny import SEED, edits

CELLS = ["sphere128-init", "sphere128-refine", "sphere128-sfm_refine", "synthhard200-init"]


def _run(cell):
    res, rows = run.run_cell(cell, SEED, 0.2, False, torch.device("cpu"),
                             option_edits=edits(cell), log=lambda *a, **k: None)
    return res, rows


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res, rows = _run(cell)
    assert res["correct"], rows
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "check"
    assert set(res["metrics"]) == {"step_ms", "setup_s"}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_is_caught(cell, fault):
    if fault == "pose_identity" and not cell.endswith("-init"):
        pytest.skip("the pose estimate is a stage of the init alone")
    with faults.FAULTS[fault]():
        res, rows = _run(cell)
    assert not res["correct"], rows
