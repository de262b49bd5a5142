"""One ``BAPhase(mode="rad_init")`` step of the port against the JAX
package's, on the CPU at the tiny widths: the fields train on the BA
losses while the poses stay frozen.

Both packages start from the same state (cameras at their GT poses, the
DLT-triangulated points of ``torch_port_helpers.dlt_scene``, the JAX
package's parameters with visible tables) and the JAX draws are
replayed. The port builds the batch with its ``Bundler``; the JAX phase
gets the same arrays (``test_torch_port_ba.py`` holds the two packages'
BA batches equal), which spares the JAX ``Bundler``'s eager set-up.
Tolerances (measured margins in brackets): each loss term 1e-4
relative or 1e-6 absolute [3e-7]; the update of every field parameter
to 1e-4 of the parameter's largest entry [2e-6]; the poses bit for bit
(their label is frozen).
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from level_s2fm_tpu.rendering import raymarch as jrm
from level_s2fm_tpu.sfm.phases import BAPhase as JBAPhase
from level_s2fm_tpu.sfm.pipeline import LevelSfM as JSfM
from level_s2fm_tpu_torch.convert import params_from_jax
from level_s2fm_tpu_torch.sfm import bundle as tbundle
from level_s2fm_tpu_torch.sfm import optim as toptim
from level_s2fm_tpu_torch.sfm.pipeline import LevelSfM as TSfM

from torch_port_helpers import dlt_scene, jax_opt, torch_opt, visible_params


def _jax_batch(tbatch):
    out = {}
    for k, v in tbatch.items():
        if k == "n_real":
            continue
        if k == "tracing":
            out[k] = {kk: jnp.asarray(vv.numpy()) for kk, vv in v.items()}
        elif k == "occ":
            out[k] = jrm.OccupancyGrid(occ=jnp.asarray(v.occ.numpy()),
                                       center=jnp.asarray(v.center.numpy()),
                                       half_size=jnp.asarray(v.half_size.numpy()))
        elif v.dtype == torch.int64:
            out[k] = jnp.asarray(v.numpy().astype(np.int32))
        else:
            out[k] = jnp.asarray(v.numpy())
    return out


def test_ba_rad_init_step_matches_and_keeps_the_poses():
    """One step over two views; the fields move, the poses do not."""
    _, _, (tcs, tps) = dlt_scene(n_views=2, noise=0.0)
    jopt, topt = jax_opt(), torch_opt()
    params_np = visible_params(jopt, seed=3, scale=0.01)
    jcfgs = JSfM(jopt, seed=0).cfgs
    tcfgs = TSfM(topt, seed=0, device="cpu").cfgs
    tb = tbundle.Bundler(topt, tcfgs, tcs, tps, cam_pick_ids=[0, 1], mode="rad_init",
                         device="cpu")
    ob = jopt.optim.ba
    jphase = JBAPhase(jcfgs, dict(jopt.loss_weight.ba), mode="rad_init",
                      single_cam=False, lr_sdf=float(ob.lr_sdf),
                      lr_sdf_end=float(ob.lr_sdf_end), lr_color=float(ob.lr_color),
                      lr_pose_r=float(ob.lr_pose_r), lr_pose_t=float(ob.lr_pose_t),
                      max_iter=tb.max_iter)
    se3 = tcs.all_se3(tb.padded_ids)
    jparams = {**jax.tree.map(jnp.asarray, params_np),
               "se3_r": jnp.asarray(se3[:, :3]), "se3_t": jnp.asarray(se3[:, 3:])}
    tparams = {**params_from_jax(params_np, device="cpu"),
               "se3_r": torch.as_tensor(se3[:, :3]), "se3_t": torch.as_tensor(se3[:, 3:])}
    t_old = {k: [x.clone() for x in toptim.tree_leaves(tparams[k])] for k in tparams}
    ts = tb.phase.init_state(tparams, tb.xyzs0.clone())
    assert all(x is not tparams["se3_r"] and x is not tparams["se3_t"]
               for x in ts["opt"].leaves)
    tbatch = dict(tb.batch)
    tbatch["occ"] = tbundle.maybe_build_occ(topt, tcfgs, ts["params"])
    js = jphase.init_state(jparams, jnp.asarray(tb.xyzs0.numpy()))
    key = jax.random.PRNGKey(11)
    C, HW = tbatch["images"].shape[:2]
    k_rays, _, k_cam, _ = jax.random.split(key, 4)
    rays = np.array(jax.random.permutation(k_rays, HW)[:min(tcfgs.rand_rays // C, HW)])
    cam = int(jax.random.randint(k_cam, (), 0, jnp.asarray(tbatch["n_real"], jnp.int32)))
    js, jmet = jphase.step(js, _jax_batch(tbatch), key)
    tmet = tb.phase.step(ts, tbatch, None, rays_idx=torch.as_tensor(rays), trace_cam=cam)
    for k, v in jmet.items():
        np.testing.assert_allclose(float(tmet[k]), float(v), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert float(jmet["rgb"]) > 0 and float(jmet["tracing_loss"]) > 0
    assert float(jmet["nonfinite"]) == 0
    for k in ("se3_r", "se3_t"):
        assert torch.equal(ts["params"][k], t_old[k][0])
        np.testing.assert_array_equal(np.asarray(js["params"][k]), t_old[k][0].numpy())
    for k in ("sdf", "rad"):
        for a, a0, b, b0 in zip(toptim.tree_leaves(ts["params"][k]), t_old[k],
                                jax.tree.leaves(js["params"][k]),
                                jax.tree.leaves(jparams[k])):
            upd_t = (a - a0).detach().numpy()
            upd_j = np.asarray(b) - np.asarray(b0)
            assert np.abs(upd_j).max() > 0
            assert np.abs(upd_t - upd_j).max() <= 1e-4 * np.abs(np.asarray(b)).max()
