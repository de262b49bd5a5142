"""Registration of a third view in the port against the JAX package, on
the CPU at the tiny widths: PnP, the geoinit batch and phase, the point
acceptance, the multi-view pose evaluation and the BA bookkeeping
(pruning, the host reprojection error, snapshot / restore).

Both sides start from one state: the JAX package's two-view start
(``torch_port_helpers.two_view_state``) copied into the port. The
geoinit steps use the JAX draws, replayed for the port from each step's
key (the sphere trace's eikonal samples and the existing-point
subsample).

Tolerances: PnP runs the same C++ on bitwise equal inputs, so its R, t
and inliers are equal; poses built from them agree to float32 rounding
(1e-5). Each geoinit loss agrees to 1e-4 relative: the trace is a chain
of threshold decisions on values that agree to ~1e-6, and Adam then
moves every table entry by up to lr = 1e-3 per step, whose rounding the
next step's losses see at ~1e-5. Host bookkeeping is float32 numpy on
equal inputs: 1e-5.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from level_s2fm_tpu.geometry import lie as jlie
from level_s2fm_tpu.geometry import transforms as jT
from level_s2fm_tpu.sfm import entities as jent
from level_s2fm_tpu.sfm import hostgeom as jhg
from level_s2fm_tpu.sfm import phases as jphases
from level_s2fm_tpu.sfm import registration as jreg
from level_s2fm_tpu_torch.geometry import transforms as tT
from level_s2fm_tpu_torch.sfm import entities as tent
from level_s2fm_tpu_torch.sfm import hostgeom as thg
from level_s2fm_tpu_torch.sfm import optim as toptim
from level_s2fm_tpu_torch.sfm import phases as tphases
from level_s2fm_tpu_torch.sfm import registration as treg

from torch_port_helpers import copy_scene, two_view_state

GEO_LOSSES = ("reproj_error", "tracing_loss", "sdf_surf", "eikonal_loss", "all",
              "n_frames_re", "nonfinite")


@pytest.fixture(scope="module")
def state():
    return two_view_state(n_views=3)


def _fresh(state):
    """Independent copies of both engines' scene state."""
    jm, tm = state
    jm2 = copy.copy(jm)
    jm2.opt = copy.deepcopy(jm.opt)
    jm2.camera_set = copy.deepcopy(jm.camera_set)
    jm2.point_set = copy.deepcopy(jm.point_set)
    tm2 = copy.copy(tm)
    tm2.opt = copy.deepcopy(tm.opt)
    copy_scene(jm2, tm2)
    return jm2, tm2


class _Captured(Exception):
    pass


def _jax_geoinit_batch(monkeypatch, jm, reg, cam):
    """The batch and phase of the JAX ``geo_init``, taken where the phase
    would start to run."""
    got = {}

    class Probe:
        def __init__(self, cls, cfgs, weights, **kw):
            got["phase"] = cls(cfgs, weights, **kw)

        def init_state(self, params):
            return {"opt": None}

        def run(self, state, batch, key):
            got["batch"] = batch
            raise _Captured

    monkeypatch.setattr(jphases, "get_cached_phase", Probe)
    with pytest.raises(_Captured):
        reg.geo_init(jm.params, cam, jm.point_set, jax.random.PRNGKey(0),
                     verbose=False)
    return got["phase"], got["batch"]


def test_pnp_ransac_is_identical():
    rng = np.random.default_rng(3)
    K = np.asarray([[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]], np.float32)
    p3d = rng.uniform(-0.5, 0.5, (200, 3)).astype(np.float32)
    R = np.asarray(jlie.so3_to_SO3(jnp.asarray([0.1, -0.2, 0.05])))
    t = np.asarray([0.1, -0.05, 2.5], np.float32)
    uvw = (p3d @ R.T + t) @ K.T
    p2d = (uvw[:, :2] / uvw[:, 2:] + rng.normal(scale=0.3, size=(200, 2))
           ).astype(np.float32)
    p2d[:30] += rng.uniform(-20, 20, (30, 2)).astype(np.float32)   # outliers
    a = jhg.pnp_ransac(p2d, p3d, K)
    b = thg.pnp_ransac(p2d, p3d, K)
    assert a.success and b.success
    np.testing.assert_array_equal(b.R, a.R)
    np.testing.assert_array_equal(b.t, a.t)
    np.testing.assert_array_equal(b.inliers, a.inliers)
    assert 150 <= b.inliers.sum() <= 175
    assert not thg.pnp_ransac(p2d[:3], p3d[:3], K).success


def test_get_pairs_and_pnp_match(state):
    jm, tm = _fresh(state)
    jr = jreg.Registration(jm.opt, jm.cfgs, jm.camera_set)
    tr = treg.Registration(tm.opt, tm.cfgs, tm.camera_set)
    jc, tc = jm._make_camera(2), tm._make_camera(2)
    for a, b in zip(jr.get_pairs(jc, jm.point_set), tr.get_pairs(tc, tm.point_set)):
        np.testing.assert_array_equal(b, a)
    assert tr.src_cam_id == jr.src_cam_id == [0, 1]
    # below 100 pairs registration fails unless if_nbv, as in the JAX package
    assert tr.pnp(tm.params, tc, tm.point_set)[0] is False
    res_j = jr.pnp(jm.params, jc, jm.point_set, if_nbv=True)
    res_t = tr.pnp(tm.params, tc, tm.point_set, if_nbv=True)
    assert res_t == res_j and res_t[0] is True
    np.testing.assert_allclose(tc.se3, jc.se3, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tc.idx2d_to_3d, jc.idx2d_to_3d)
    assert tm.point_set.tracks == jm.point_set.tracks
    # the floors reject before any state changes
    tc2 = tm._make_camera(2)
    ok, ratio, n = tr.pnp(tm.params, tc2, tm.point_set, if_nbv=True,
                          min_inliers=res_t[2] + 1)
    assert (ok, n) == (False, res_t[2]) and (tc2.idx2d_to_3d == -1).all()
    assert tr.pnp(tm.params, tc2, tm.point_set, if_nbv=True, dry_run=True)[0]
    assert (tc2.idx2d_to_3d == -1).all()


def _registered(state):
    """Both engines with view 2 registered by PnP (not yet triangulated)."""
    jm, tm = _fresh(state)
    regs = []
    for m, mod in ((jm, jreg), (tm, treg)):
        reg = mod.Registration(m.opt, m.cfgs, m.camera_set)
        cam = m._make_camera(2)
        assert reg.pnp(m.params, cam, m.point_set, if_nbv=True)[0]
        m.camera_set.add(cam)
        regs.append((reg, cam))
    return jm, tm, regs


@pytest.mark.parametrize("max_rays", [0, 20])
def test_geoinit_batch_matches(state, monkeypatch, max_rays):
    """max_rays 20 caps the 28 pair rays: the subsample is drawn from
    the same seeded numpy generator on both sides."""
    jm, tm, ((jr, jc), (tr, tc)) = _registered(state)
    for m in (jm, tm):
        m.opt.optim.geoinit.max_rays = max_rays
    _, jb = _jax_geoinit_batch(monkeypatch, jm, jr, jc)
    segs, tb = tr.geo_init_batch(tc, tm.point_set, verbose=False)
    assert sorted(tb) == sorted(jb)
    for k in tb:
        np.testing.assert_allclose(np.asarray(tb[k], np.float64),
                                   np.asarray(jb[k], np.float64),
                                   rtol=0, atol=1e-5, err_msg=k)
    assert int(np.asarray(jb["valid"]).sum()) == sum(s["n"] for s in segs)
    assert sum(s["n"] for s in segs) == (20 if max_rays else 28)


def test_geoinit_steps_and_acceptance_match(state, monkeypatch):
    jm, tm, ((jr, jc), (tr, tc)) = _registered(state)
    jphase, jb = _jax_geoinit_batch(monkeypatch, jm, jr, jc)
    segs, tb = tr.geo_init_batch(tc, tm.point_set, verbose=False)
    tb = {k: torch.as_tensor(v) for k, v in tb.items()}
    og = tm.opt.optim.geoinit
    tphase = tphases.GeoInitPhase(
        tm.cfgs, dict(tm.opt.loss_weight.geoinit), n_segments=jphase.n_segments,
        lr_sdf=float(og.lr_sdf), lr_sdf_end=float(og.lr_sdf_end),
        max_iter=int(og.max_iter) * 5, reproj_max=jphase.reproj_max)
    js = jphase.init_state(jm.params)
    ts = tphase.init_state(tm.params)
    rad0 = [p.clone() for p in toptim.tree_leaves(tm.params["rad"])]
    P, E = tb["valid"].shape[0], tb["pts_exists"].shape[0]
    for i in range(3):
        key = jax.random.PRNGKey(10 + i)
        js, jmet = jphase.step(js, jb, key)
        k1, k2 = jax.random.split(key)
        # replay: march_samples(k1) and the existing-point subsample (k2)
        kf, kp, kp2 = jax.random.split(k1, 3)
        n_pick = min(4096, 2 * P)
        draws = {"factor_rand": np.array(jax.random.uniform(kf, (2 * P,))),
                 "pick": np.array(jax.random.permutation(kp, 2 * P)[:n_pick]),
                 "pick2": np.array(jax.random.permutation(
                     kp2, n_pick * tm.cfgs.sdf.iters_max + 2 * P)[:4096])}
        pick = np.array(jax.random.permutation(k2, E)[:min(4096, E)])
        tmet = tphase.step(ts, tb, None, draws=draws, exist_pick=pick)
        for k in GEO_LOSSES:
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-4,
                                       atol=1e-7, err_msg=f"step {i} {k}")
    assert float(jmet["reproj_error"]) > 0 and float(jmet["tracing_loss"]) > 0
    # the radiance field is frozen: bit for bit unchanged
    for a, b in zip(toptim.tree_leaves(tm.params["rad"]), rad0):
        assert torch.equal(a, b)

    # the final trace and the host acceptance of new points
    jfin = jphase.final(js["params"], jb, jax.random.PRNGKey(7))
    tfin = tphase.final(ts["params"], tb, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(tfin["pts"].numpy(), np.asarray(jfin["pts"]),
                               rtol=0, atol=1e-4)
    for k in ("finish", "reject", "trace_mask"):
        np.testing.assert_array_equal(tfin[k].numpy(), np.asarray(jfin[k]), k)
    jsegs = _jax_segments(jr, jc, jm)
    fin_np = {k: np.asarray(v) for k, v in jfin.items()}
    # three steps leave the new rays unconverged, so nothing passes the
    # (f0 & f1) gate; marking every ray converged accepts every kept one
    fin_np["finish"] = np.ones_like(fin_np["finish"])
    n_before = len(jm.point_set)
    jr._accept_points(fin_np, jsegs, jc, jm.point_set, verbose=False)
    tr._accept_points(fin_np, segs, tc, tm.point_set, verbose=False)
    assert len(tm.point_set) == len(jm.point_set) > n_before
    assert tm.point_set.tracks == jm.point_set.tracks
    np.testing.assert_array_equal(tm.point_set.all_xyzs(), jm.point_set.all_xyzs())
    for a, b in zip(tm.camera_set.cameras, jm.camera_set.cameras):
        np.testing.assert_array_equal(a.idx2d_to_3d, b.idx2d_to_3d)


def _jax_segments(jr, jc, jm):
    """The JAX ``geo_init``'s segment list, rebuilt as it builds it when
    no ray budget applies."""
    segs = []
    for src_id in jr.src_cam_id:
        cam_i = jm.camera_set(src_id)
        _, _, _, kidx_new = jr._pair_rays(jc, cam_i)
        _, _, _, kidx_src = jr._pair_rays(cam_i, jc)
        segs.append(dict(kidx_new=kidx_new, kidx_src=kidx_src, n=len(kidx_new),
                         is_new=jc.idx2d_to_3d[kidx_new] == -1,
                         cam_pair=(jm.camera_set.index_of(jc.id),
                                   jm.camera_set.index_of(src_id))))
    return segs


def _perturbed_three_views(state):
    jm, tm, _ = _registered(state)
    rng = np.random.default_rng(4)
    for jc, tc in zip(jm.camera_set.cameras, tm.camera_set.cameras):
        jc.se3 = tc.se3 = (tc.se3 + rng.normal(scale=0.02, size=6)).astype(np.float32)
    return jm, tm


def test_eval_poses_three_views_and_procrustes(state):
    jm, tm = _perturbed_three_views(state)
    r_j, t_j, a_j = jm.camera_set.eval_poses(verbose=False)
    r_t, t_t, a_t = tm.camera_set.eval_poses(verbose=False)
    assert np.isfinite(a_t)
    # arccos of a float32 cosine near 1 resolves angles to ~0.02 deg
    np.testing.assert_allclose([r_t, t_t, a_t], [r_j, t_j, a_j], rtol=1e-4, atol=0.03)
    rng = np.random.default_rng(5)
    X1 = rng.normal(size=(6, 3)).astype(np.float32)
    X0 = (1.7 * X1 @ np.asarray(jlie.so3_to_SO3(jnp.asarray([0.3, 0.1, -0.4]))).T
          + [0.5, -1.0, 2.0]).astype(np.float32)
    js = jT.procrustes_analysis(jnp.asarray(X0), jnp.asarray(X1))
    ts = tT.procrustes_analysis(torch.as_tensor(X0), torch.as_tensor(X1))
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
    # non-finite poses give nan metrics, as in the JAX package
    tm.camera_set.cameras[1].se3 = np.full(6, np.nan, np.float32)
    assert all(np.isnan(tm.camera_set.eval_poses(verbose=False)))


def test_prune_reprojection_and_snapshot_match(state):
    jm, tm = _perturbed_three_views(state)
    for mod, m in ((jent, jm), (tent, tm)):
        m.reproj0 = mod.mean_reprojection_px(m.camera_set, m.point_set, [0, 2])
        m.snap = mod.snapshot_geometry(m.camera_set, m.point_set)
        m.camera_set.cameras[0].se3 = m.camera_set.cameras[0].se3 + 0.05
        m.point_set.xyz[:3] += 0.1
        m.pruned = mod.prune_outlier_observations(m.camera_set, m.point_set,
                                                  thr_px=0.5, max_cam_frac=0.9)
        m.reproj1 = mod.mean_reprojection_px(m.camera_set, m.point_set)
    np.testing.assert_allclose(tm.reproj0, jm.reproj0, rtol=1e-5)
    np.testing.assert_allclose(tm.reproj1, jm.reproj1, rtol=1e-5)
    assert tm.pruned == jm.pruned and tm.pruned[0] > 0
    assert tm.point_set.tracks == jm.point_set.tracks
    np.testing.assert_array_equal(tm.point_set.alive_mask(), jm.point_set.alive_mask())
    for a, b in zip(tm.camera_set.cameras, jm.camera_set.cameras):
        np.testing.assert_array_equal(a.idx2d_to_3d, b.idx2d_to_3d)
    tent.restore_geometry(tm.camera_set, tm.point_set, tm.snap)
    se3s, xyz = tent.snapshot_geometry(tm.camera_set, tm.point_set)
    for a, b in zip(se3s + [xyz], tm.snap[0] + [tm.snap[1]]):
        np.testing.assert_array_equal(a, b)
    idx, pose_idx, kp = tent.gather_track_observations(tm.camera_set, [2, 0])
    jidx, jpose_idx, jkp = jent.gather_track_observations(jm.camera_set, [2, 0])
    for a, b in ((idx, jidx), (pose_idx, jpose_idx), (kp, jkp)):
        np.testing.assert_array_equal(a, b)
