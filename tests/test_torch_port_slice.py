"""The slice end to end: two-view initialization in the port against the
JAX package, from the same options, scene and weights (moved over by
``convert.params_from_jax``), on the CPU at small widths.

Both sides run ``Initializer`` for three ``InitPhase`` steps, each in
its own occupancy-refresh segment, then triangulate. Every pixel of both
views is drawn each step (rand_rays // 2 == H*W), so the losses do not
depend on the ray permutation, the one random draw that reaches them.

Tolerances (measured margins in brackets): every loss term of every step
agrees to 2e-5 relative [2.5e-6]; the MLP weights to 1e-5 absolute
[5e-7]. Adam normalises each gradient entry, so a hash-table entry whose
gradient is rounding noise on both sides can move by up to lr_sdf = 1e-3
per step in either direction: the table agrees to 1e-5 at the 99.9th
percentile [2.2e-6] and to 3 steps x lr_sdf at worst [6.9e-4].
"""
import jax
import numpy as np
import pytest
import torch

from level_s2fm_tpu.data import synthetic as jsyn
from level_s2fm_tpu.sfm import initialization as jinit
from level_s2fm_tpu.sfm import pipeline as jpipe
from level_s2fm_tpu_torch.convert import params_from_jax, params_to_jax
from level_s2fm_tpu_torch.data import synthetic as tsyn
from level_s2fm_tpu_torch.sfm import initialization as tinit
from level_s2fm_tpu_torch.sfm import pipeline as tpipe

from torch_port_helpers import jax_opt, torch_opt

LOSSES = ("reproj_error", "sdf_surf", "eikonal_loss", "rgb", "DC_Loss",
          "PSNR", "all", "nonfinite")


def _init_var(var):
    return {"indx_init": [0, 1],
            "imgs_init": [var["images"][0], var["images"][1]],
            "kypts_init": [var["kypts"][0], var["kypts"][1]],
            "intrs_init": [var["intrs"][0], var["intrs"][1]],
            "mchs_init": [var["matches"][0], var["matches"][1]],
            "inliers_init": [var["masks"][0], var["masks"][1]],
            "poses_gt": var["poses_gt"]}


@pytest.fixture(scope="module")
def both():
    opt_j, opt_t = jax_opt(), torch_opt()
    jm = jpipe.LevelSfM(opt_j, seed=0)
    jm.load_data(jsyn.scene_to_var(jsyn.make_scene(n_views=2, H=16, W=16,
                                                   n_points=64, seed=0)))
    params_np = jax.tree.map(np.array, jm.params)
    ji = jinit.Initializer(opt_j, jm.cfgs, jm.camera_set, jm.point_set,
                           _init_var(jm.var))
    jparams = ji.run(jm.params, jax.random.PRNGKey(3))

    tm = tpipe.LevelSfM(opt_t, seed=0, device="cpu")
    tm.load_data(tsyn.scene_to_var(tsyn.make_scene(n_views=2, H=16, W=16,
                                                   n_points=64, seed=0)))
    tm.params = params_from_jax(params_np, device="cpu")
    ti = tinit.Initializer(opt_t, tm.cfgs, tm.camera_set, tm.point_set,
                           _init_var(tm.var), device="cpu")
    tparams = ti.run(tm.params, torch.Generator().manual_seed(3))
    return (ji, jm, jax.tree.map(np.asarray, jparams)), (ti, tm, params_to_jax(tparams))


def test_cameras_and_batch_match(both):
    (ji, jm, _), (ti, tm, _) = both
    for jc, tc in zip(jm.camera_set.cameras, tm.camera_set.cameras):
        np.testing.assert_allclose(tc.se3, jc.se3, rtol=0, atol=1e-5)
        np.testing.assert_allclose(tc.pose(), jc.pose(), rtol=0, atol=1e-5)
    for k, v in ji.batch.items():
        np.testing.assert_allclose(ti.batch[k].numpy().astype(np.float64),
                                   np.asarray(v, np.float64), rtol=0, atol=1e-5,
                                   err_msg=k)


def test_init_losses_match_step_by_step(both):
    (ji, _, _), (ti, _, _) = both
    for k in LOSSES:
        j = np.asarray(ji._metrics[k], np.float64)
        t = np.asarray(ti._metrics[k], np.float64)
        assert t.shape == j.shape == (3,), k
        np.testing.assert_allclose(t, j, rtol=2e-5, atol=1e-7, err_msg=k)
    assert np.all(ti._metrics["nonfinite"] == 0)
    assert ti._metrics["all"][-1] < ti._metrics["all"][0]


def test_params_after_init_match(both):
    (_, _, jp), (_, _, tp) = both
    jl = jax.tree.leaves(jp)
    tl = jax.tree.leaves(tp)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        assert a.shape == b.shape
        d = np.abs(a.astype(np.float64) - b)
        if a.ndim == 3:                                   # the hash table
            assert np.quantile(d, 0.999) < 1e-5 and d.max() < 3e-3
        else:
            assert d.max() < 1e-5


def test_triangulation_matches(both):
    (ji, jm, _), (ti, tm, _) = both
    assert len(tm.point_set) == len(jm.point_set) > 0
    np.testing.assert_allclose(tm.point_set.all_xyzs(), jm.point_set.all_xyzs(),
                               rtol=0, atol=1e-3)
    assert ti.tri_ratio[1] == ji._n_kp
    r_t, t_t, _ = tm.camera_set.eval_poses(verbose=False)
    r_j, t_j, _ = jm.camera_set.eval_poses(verbose=False)
    # float32 arccos near 1 resolves angles only to sqrt(2 * 6e-8) rad =
    # 0.02 deg: one ulp of the cosine moves a near-zero error by that much
    np.testing.assert_allclose([r_t, t_t], [r_j, t_j], rtol=0, atol=0.05)
