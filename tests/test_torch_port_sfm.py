"""The port's incremental SfM loop end to end on the CPU at the tiny
widths, and its registration bookkeeping against the JAX package's.

* A 3-view run in ``full`` and in ``fast`` mode registers views
  [0, 1, 2] with finite metrics, and the relative rotation of views 0-1
  stays within the JAX package's E2E oracle (``tests/test_pipeline_e2e.py``:
  < 5 deg). The run's random draws are the port's own, so it is judged
  by bands, not step by step. The oracle for views 0-2 (< 8 deg) needs
  the E2E test's widths: at these tiny ones a 10-point PnP on 16x16
  images sets the third pose, and the JAX package itself lands at 14.5
  deg there (fast mode, measured on the CPU). ``chip_smoke.py``'s bands
  phase holds both oracles at the synthetic configuration on the card.
* Deferral and termination: with ``registration.max_attempts`` > 1 and
  views made to fail, the port tries, defers, retries and skips exactly
  the views the JAX package does (both loops driven with the same
  stubbed registration, so only the loop logic is compared).
"""
import numpy as np
import pytest
import torch

from level_s2fm_tpu.sfm import pipeline as jpipe
from level_s2fm_tpu_torch.geometry import lie as tlie
from level_s2fm_tpu_torch.sfm import pipeline as tpipe

from torch_port_helpers import _scene_var, jax_opt, torch_opt

E2E_ARGS = ["--data.n_views=3", "--optim.init.max_iter=20",
            "--optim.geoinit.max_iter=2", "--optim.ba.max_iter=10",
            "--optim.refine.max_iter=4"]


def _rel_rot_err_deg(m, i, j):
    poses, gt = m.camera_set.all_poses()
    p, g = torch.as_tensor(poses), torch.as_tensor(gt)
    rel = tlie.pose_compose_pair(tlie.pose_invert(p[i]), p[j])
    rel_gt = tlie.pose_compose_pair(tlie.pose_invert(g[i]), g[j])
    return float(np.rad2deg(float(tlie.rotation_distance(rel_gt[:3, :3],
                                                         rel[:3, :3]))))


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


def _stubbed(mod, opt, fail):
    """An engine of package ``mod`` whose init and registration are stubs:
    views in ``fail`` never register, the others always do."""
    m = mod.LevelSfM(opt, seed=0, **({"device": "cpu"} if mod is tpipe else {}))
    m.load_data(_scene_var(5))
    m.attempts = []

    def init(id0, id1, verbose=True):
        for i in (id0, id1):
            m.camera_set.add(m._make_camera(i))

    def register(new_id, verbose=True):
        m.attempts.append(new_id)
        if new_id in fail:
            return False
        m.camera_set.add(m._make_camera(new_id))
        return True

    m.initialize_two_views = init
    m.register_view = register
    return m


@pytest.mark.parametrize("attempts,fail", [(1, {3}), (3, {2}), (2, {3}),
                                           (10, {2, 3, 4})])
def test_deferral_and_skips_match_jax(tmp_path, attempts, fail):
    """max_attempts 1 aborts on the first failure; with more a failed
    view is deferred until another view registers, retried, and skipped
    once its attempts are spent or no view can change the scene."""
    args = ["--data.n_views=5", f"--registration.max_attempts={attempts}",
            f"--output_path={tmp_path}", "--freq.vis=0"]
    jm = _stubbed(jpipe, jax_opt(args), fail)
    tm = _stubbed(tpipe, torch_opt(args), fail)
    assert tm.train(verbose=False) == jm.train(verbose=False)
    assert tm.attempts == jm.attempts
    assert tm.camera_set.cam_ids == jm.camera_set.cam_ids
    skipped = [r["skipped_views"] for r in jm.metrics.history
               if "skipped_views" in r]
    assert tm.skipped_views == (skipped[-1] if skipped else [])
