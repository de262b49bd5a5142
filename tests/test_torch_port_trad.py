"""The traditional-SfM ablation paths of the port against the JAX package
(DLT triangulation, quaternions, trad BA, the SDF post-fit), the rest
of ``rendering/raymarch.py`` and the ``paired_dense`` hash-grid key, on
the CPU at small sizes.

Tolerances (measured margins in brackets): the DLT is the same numpy
code, so bitwise; quaternions and ``slerp_pose`` 1e-6 absolute [6e-8];
``BATradPhase``: the first 20 steps, each step's reprojection error to
1e-4 relative [1.3e-5] and the poses and points after them to 1e-4 of
their largest entry [3e-6]; after 50 steps, and after a
``TradBundler`` run, every pose and point entry within one base-lr Adam
step (5e-3 for the rotations, 1e-2 for translations and points)
[4.4e-4 and 1.4e-4], and the tracks equal. Once the BA has converged
its gradients are at rounding level along the gauge freedom (every
camera and point is free, so a similarity of the whole scene leaves the
loss unchanged), and Adam's normalised step moves those coordinates by
up to lr in the direction of the rounding: the packages then agree to
the step size, not to the rounding (2e-7 after one step, 3e-6 after 20,
2.8e-4 to 9.3e-4 relative after 50, with the thread count).
``SdfFitPhase`` five steps with the JAX draws replayed, each loss
1e-4 relative [~2e-6]; the ray-march functions 1e-6 [exact or 1 ulp];
``paired_dense`` as ``tests/test_hashgrid_paired.py`` holds the JAX
package's two paths (values 1e-6, Jacobians 1e-4 inside and 1e-5
outside the domain, table gradients 1e-5).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from level_s2fm_tpu.fields import hashgrid as jhash
from level_s2fm_tpu.geometry import lie as jlie
from level_s2fm_tpu.rendering import raymarch as jrm
from level_s2fm_tpu.sfm import hostgeom as jhg
from level_s2fm_tpu.sfm import trad as jtrad
from level_s2fm_tpu_torch.fields import hashgrid as thash
from level_s2fm_tpu_torch.geometry import lie as tlie
from level_s2fm_tpu_torch.rendering import raymarch as trm
from level_s2fm_tpu_torch.sfm import hostgeom as thg
from level_s2fm_tpu_torch.sfm import trad as ttrad

from torch_port_helpers import dlt_scene, jax_opt, rel_err, torch_opt


def test_triangulate_dlt_is_bitwise_the_jax_packages():
    rng = np.random.default_rng(0)
    K = np.asarray([[50.0, 0, 16], [0, 50.0, 16], [0, 0, 1]])
    X = rng.uniform(-0.5, 0.5, (40, 3))
    kps, Ps = [], []
    for ang in (0.0, 0.3):
        R = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]]
        Rt = np.concatenate([R, [[0.1], [0.0], [3.0]]], 1)
        P = K @ Rt
        x = (X @ P[:, :3].T + P[:, 3])
        kps.append((x[:, :2] / x[:, 2:] + rng.normal(0, 0.05, (40, 2))).astype(np.float32))
        Ps.append(P)
    a = jhg.triangulate_dlt(kps[0], kps[1], Ps[0], Ps[1])
    b = thg.triangulate_dlt(kps[0], kps[1], Ps[0], Ps[1])
    assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    assert np.abs(b - X).max() < 0.1


def test_quaternions_and_slerp_pose():
    rng = np.random.default_rng(1)
    w = rng.normal(0, 1.0, (16, 3)).astype(np.float32)
    # +-170 deg about x last: quaternions with a negative dot
    w = np.concatenate([w, np.float32([[2.967, 0, 0], [-2.967, 0, 0]])], 0)
    R = tlie.so3_to_SO3(torch.as_tensor(w)).numpy()
    t = rng.normal(size=(18, 3, 1)).astype(np.float32)
    poses = np.concatenate([R, t], -1)

    @jax.jit
    def jax_side(R, poses):
        q = jlie.R_to_q(R)
        q2 = q[::-1]
        # a generic pair, the negative-dot pair, and a pair too close for
        # the sine (the linear branch), each at three t
        slerps = [jlie.slerp_pose(poses[i], poses[j], s)
                  for i, j in ((0, 1), (16, 17), (2, 2)) for s in (0.0, 0.3, 1.0)]
        return (q, jlie.q_to_R(q), jlie.q_invert(q), jlie.q_product(q, q2),
                jnp.stack(slerps))

    jq, jR, jinv, jprod, jslerp = map(np.asarray, jax_side(R, poses))
    assert np.sum(jq[16] * jq[17]) < 0
    q = tlie.R_to_q(torch.as_tensor(R))
    tslerp = torch.stack([
        tlie.slerp_pose(torch.as_tensor(poses[i]), torch.as_tensor(poses[j]), s)
        for i, j in ((0, 1), (16, 17), (2, 2)) for s in (0.0, 0.3, 1.0)])
    for got, want in ((q, jq), (tlie.q_to_R(q), jR), (tlie.q_invert(q), jinv),
                      (tlie.q_product(q, q.flip(0)), jprod), (tslerp, jslerp)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def _ba_problem(n_obs_pad=256):
    """Three noisy cameras, the scene's points and their observations,
    padded as the JAX ``TradBundler`` pads them."""
    _, (jcs, jps), _ = dlt_scene(n_views=3, size=32, n_points=128, noise=0.02)
    from level_s2fm_tpu.sfm import entities as jent
    pts_id, pose_idx, kypts = jent.gather_track_observations(jcs, [0, 1, 2])
    uniq, inv = np.unique(pts_id, return_inverse=True)
    P, U = n_obs_pad, 64
    assert len(pts_id) < P and len(uniq) < U
    batch = {"pose_idx": np.zeros(P, np.int32), "kp": np.zeros((P, 2), np.float32),
             "valid": np.zeros(P, bool), "obs_to_pt": np.zeros(P, np.int32),
             "intr": np.asarray(jcs.cameras[0].intr, np.float32)}
    n = len(pts_id)
    batch["pose_idx"][:n], batch["kp"][:n] = pose_idx, kypts
    batch["valid"][:n], batch["obs_to_pt"][:n] = True, inv
    xyzs = np.zeros((U, 3), np.float32)
    xyzs[:len(uniq)] = jps.get_xyzs(uniq)
    se3 = jcs.all_se3()
    return batch, {"se3_r": se3[:, :3], "se3_t": se3[:, 3:], "xyzs": xyzs}


#: the base learning rates of the trad BA (``optim.ba`` / ``optim.lr_xyzs``)
TRAD_LRS = {"se3_r": 5e-3, "se3_t": 1e-2, "xyzs": 1e-2}


def _within_a_step(got, want):
    """Converged trad BA: each entry within one base-lr Adam step."""
    for k, lr in TRAD_LRS.items():
        assert np.abs(got[k] - want[k]).max() <= lr, k


def test_ba_trad_phase_50_steps():
    batch, p0 = _ba_problem()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jp0 = {k: jnp.asarray(v) for k, v in p0.items()}
    j20, jmet = jtrad.BATradPhase(None, max_iter=50).run(jp0, jb, jax.random.PRNGKey(0), n_iters=20)
    j50, _ = jtrad.BATradPhase(None, max_iter=50).run(jp0, jb, jax.random.PRNGKey(0), n_iters=50)
    tphase = ttrad.BATradPhase(None, max_iter=50)
    tb = {k: torch.as_tensor(v).long() if v.dtype == np.int32 else torch.as_tensor(v)
          for k, v in batch.items()}
    state = tphase.init_state({k: torch.as_tensor(v) for k, v in p0.items()})
    tmet = [tphase.step(state, tb)["reproj_px"] for _ in range(20)]
    np.testing.assert_allclose(torch.stack(tmet).numpy(),
                               np.asarray(jmet["reproj_px"]), rtol=1e-4)
    t = {k: v.detach().numpy().copy() for k, v in state["params"].items()}
    for k in TRAD_LRS:
        assert rel_err(t[k], np.asarray(j20[k])) <= 1e-4, k
    for _ in range(30):
        tphase.step(state, tb)
    t = {k: v.detach().numpy() for k, v in state["params"].items()}
    _within_a_step(t, {k: np.asarray(v) for k, v in j50.items()})
    assert float(jmet["reproj_px"][-1]) < 0.5 * float(jmet["reproj_px"][0])


@pytest.mark.parametrize("pick", [[2, 0, 1], None])
def test_trad_bundler_run(pick):
    """A local (views 2, 0, 1) and a global ``TradBundler`` write the same
    poses and points back in both packages; the tracks are untouched."""
    extra = ["--optim.ba.max_iter=40"]
    _, (jcs, jps), (tcs, tps) = dlt_scene(n_views=3, size=32, n_points=128,
                                          noise=0.02)
    tracks = [list(t) for t in tps.tracks]
    jb = jtrad.TradBundler(jax_opt(extra), None, jcs, jps, cam_pick_ids=pick)
    tb = ttrad.TradBundler(torch_opt(extra), None, tcs, tps, cam_pick_ids=pick,
                           device="cpu")
    _, jr = jb.run(None, jax.random.PRNGKey(0), verbose=False)
    _, tr = tb.run(None, None, verbose=False)
    assert abs(tr - jr) <= 1e-2 * jr     # ~0.02 px, agrees to 4e-3 relative
    _within_a_step({"se3_r": tcs.all_se3()[:, :3], "se3_t": tcs.all_se3()[:, 3:],
                    "xyzs": tps.all_xyzs()},
                   {"se3_r": jcs.all_se3()[:, :3], "se3_t": jcs.all_se3()[:, 3:],
                    "xyzs": jps.all_xyzs()})
    assert [list(t) for t in tps.tracks] == tracks == [list(t) for t in jps.tracks]
    assert list(tcs.cam_ids) == list(jcs.cam_ids)


def _paired_cfgs(**kw):
    base = jhash.HashGridConfig(n_levels=6, n_features_per_level=2,
                                log2_hashmap_size=10, base_resolution=4,
                                per_level_scale=1.7, include_input=False, **kw)
    tcfg = thash.HashGridConfig(n_levels=6, n_features_per_level=2,
                                log2_hashmap_size=10, base_resolution=4,
                                per_level_scale=1.7, include_input=False,
                                paired_dense=True, **kw)
    return dataclasses.replace(base, paired_dense=True), tcfg


def test_raymarch_functions():
    rng = np.random.default_rng(3)
    occ = rng.uniform(size=(8, 8, 8)) < 0.4
    o = np.tile(np.float32([0, 0, -3]), (20, 1))
    d = np.concatenate([rng.uniform(-0.4, 0.4, (20, 2)), np.ones((20, 1))], 1)
    d = d.astype(np.float32)
    d[0] = [1.0, 0, 0]                           # a ray that misses the box
    pert = rng.uniform(size=(20, 32)).astype(np.float32)
    sig = rng.uniform(0, 20, (20, 32)).astype(np.float32)
    rgb = rng.uniform(size=(20, 32, 3)).astype(np.float32)
    bg = np.float32([0.2, 0.5, 1.0])
    x = np.float32([-30.0, -1.0, 0.0, 2.0, 30.0])
    vals = rng.normal(size=12).astype(np.float32)
    seg = np.int32([0, 0, 1, 1, 1, 3, 3, 3, 3, 4, 4, 4])

    @jax.jit
    def jax_side(occ, pert, sig, rgb):
        grid = jrm.OccupancyGrid(occ=occ, center=jnp.zeros(3), half_size=jnp.ones(3))
        marched = [jrm.march_rays(grid, o, d, 32),
                   jrm.march_rays(grid, o, d, 32, perturb_key=jax.random.PRNGKey(4))]

        def comp(s, c):
            out = jrm.composite_hard_stop(s, c, marched[0][1], marched[0][2],
                                          bg_color=bg)
            return out["rgb"].sum() + out["opacity"].sum(), out
        (_, out), g = jax.value_and_grad(comp, argnums=(0, 1), has_aux=True)(sig, rgb)
        te, te_g = jax.value_and_grad(lambda v: jnp.sum(jrm.trunc_exp(v)))(x)
        return (marched, out, g, jrm.trunc_exp(x), te_g,
                jrm.segment_mean(vals, seg, 6),
                jax.random.uniform(jax.random.PRNGKey(4), (20, 32)))

    jm, jo, jg, jte, jte_g, jseg, jpert = jax.tree.map(
        np.asarray, jax_side(occ, pert, sig, rgb))

    tx = torch.as_tensor(x).requires_grad_(True)
    te = trm.trunc_exp(tx)
    (te_g,) = torch.autograd.grad(te.sum(), tx)
    np.testing.assert_allclose(te.detach().numpy(), jte, rtol=1e-6)
    np.testing.assert_allclose(te_g.numpy(), jte_g, rtol=1e-6)
    np.testing.assert_allclose(float(te_g[-1]), np.exp(15.0), rtol=1e-6)

    tgrid = trm.OccupancyGrid(occ=torch.as_tensor(occ), center=torch.zeros(3),
                              half_size=torch.ones(3))
    for perturb, want in ((None, jm[0]), (torch.as_tensor(jpert), jm[1])):
        got = trm.march_rays(tgrid, torch.as_tensor(o), torch.as_tensor(d), 32,
                             perturb=perturb)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6)
    assert not got[2][0].any() and got[2].any()

    ts = torch.as_tensor(sig).requires_grad_(True)
    tc = torch.as_tensor(rgb).requires_grad_(True)
    to = trm.composite_hard_stop(ts, tc, torch.as_tensor(jm[0][1]),
                                 torch.as_tensor(jm[0][2]), bg_color=torch.as_tensor(bg))
    tg = torch.autograd.grad(to["rgb"].sum() + to["opacity"].sum(), (ts, tc))
    for k in ("opacity", "rgb", "ws"):
        np.testing.assert_allclose(to[k].detach().numpy(), jo[k], atol=1e-6)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-6)
    assert float(to["opacity"].max()) > 0.5
    np.testing.assert_allclose(
        trm.segment_mean(torch.as_tensor(vals), torch.as_tensor(seg).long(), 6).numpy(),
        jseg, atol=1e-6)
