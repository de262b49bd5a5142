"""The three-view run of the port at the tiny widths, in full and fast mode
(see ``test_torch_port_sfm.py``).
Kept apart so that it runs after the suite's long files have started: pytest-xdist's loadfile queue starts the files with more tests first.
"""
import numpy as np
import pytest

from level_s2fm_tpu_torch.sfm import pipeline as tpipe

from test_torch_port_sfm import E2E_ARGS, _rel_rot_err_deg  # noqa: F401
from torch_port_helpers import _scene_var, torch_opt


@pytest.mark.parametrize("mode", ["full", "fast"])
def test_three_view_run_registers_every_view(mode):
    m = tpipe.LevelSfM(torch_opt(E2E_ARGS + [f"--sfm_mode={mode}"]), seed=0,
                       device="cpu")
    m.load_data(_scene_var(3))
    assert m.train(verbose=False, max_views=3) is True
    assert m.camera_set.cam_ids == [0, 1, 2]
    row = m.view_log[-1]
    assert row["view"] == 2 and row["n_cams"] == 3
    for k in ("reproj_px", "rot_err_deg", "t_err", "ate"):
        assert np.isfinite(row[k]), k
    assert ("refine" in row["stage_s"]) == (mode == "full")
    assert ("sfm_refine" in row["stage_s"]) == (mode == "full")
    assert _rel_rot_err_deg(m, 0, 1) < 5.0
    assert len(m.point_set) >= 10
