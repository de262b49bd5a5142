"""The GeoInitPhase steps and the acceptance of new points against the JAX
package (see ``test_torch_port_geoinit.py``).
Kept apart so that it runs after the suite's long files have started: pytest-xdist's loadfile queue starts the files with more tests first.
"""
import jax
import numpy as np
import torch

from level_s2fm_tpu_torch.sfm import optim as toptim
from level_s2fm_tpu_torch.sfm import phases as tphases

from test_torch_port_registration import (  # noqa: F401
    GEO_LOSSES, _jax_geoinit_batch, _jax_segments, _registered, state)


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

    # the final trace and the host acceptance of new points (the JAX
    # phase's jitted ``_final``: ``final`` runs the same function op by op)
    jfin = jphase._final(js["params"], jb, jax.random.PRNGKey(7))
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
