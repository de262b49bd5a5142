"""The ``tri_trad`` + ``ba_trad`` CLI run and ``polish_trad_ba`` on its
checkpoint (see ``test_torch_port_ablations.py``).
Kept apart so that it runs after the suite's long files have started: pytest-xdist's loadfile queue starts the files with more tests first.
"""
import os

import numpy as np

from level_s2fm_tpu.utils import checkpoint as jck
from level_s2fm_tpu_torch.utils import checkpoint as tck

from test_torch_port_ablations import TRAD_ARGS, trad_run  # noqa: F401


def test_trad_run_meets_the_jax_tests_bars(trad_run):
    """All three views register, > 30 points, median | |X| - 0.5 | < 0.1
    (DLT from near-GT poses on noiseless data puts the points on the
    sphere)."""
    m, _ = trad_run
    assert list(m.camera_set.cam_ids) == [0, 1, 2] and not m.skipped_views
    assert len(m.point_set) > 30
    r = np.linalg.norm(m.point_set.all_xyzs(), axis=-1)
    assert np.median(np.abs(r - 0.5)) < 0.1
    assert m.view_log[-1]["reproj_px"] < 1.0


def test_polish_trad_ba_writes_a_checkpoint_both_packages_read(trad_run):
    from level_s2fm_tpu_torch import polish_trad_ba
    _, out = trad_run
    ckpt = os.path.join(out, "model.ckpt")
    with open(ckpt, "rb") as f:
        before = f.read()
    res = polish_trad_ba.main([out] + TRAD_ARGS + ["--cycles=1", "--iters=50"])
    with open(ckpt, "rb") as f:
        assert f.read() == before
    path = os.path.join(out, "model_polished.ckpt")
    assert res["path"] == path and len(res["cycles"]) == 1
    assert all(np.isfinite(v) for v in res["cycles"][0].values())
    tparams, tcam, tpts, _ = tck.restore_checkpoint_sfm(path, device="cpu")
    jparams, jcam, jpts, _ = jck.restore_checkpoint_sfm(path)
    np.testing.assert_array_equal(np.asarray(tcam["pose_para"]),
                                  np.asarray(jcam["pose_para"]))
    np.testing.assert_array_equal(tpts["xyzs"], np.asarray(jpts["xyzs"]))
    np.testing.assert_array_equal(tparams["sdf"]["table"].numpy(),
                                  np.asarray(jparams["sdf"]["table"]))
