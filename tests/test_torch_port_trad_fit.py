"""The SDF post-fit of the trad path and the paired dense gather in the
port against the JAX package, on the CPU (see ``test_torch_port_trad.py``,
which holds the rest of ``rendering/raymarch.py``). Kept to two tests so
that it runs after the suite's long files have started: pytest-xdist's
loadfile queue starts the files with more tests first.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from level_s2fm_tpu.fields import hashgrid as jhash
from level_s2fm_tpu.sfm import trad as jtrad
from level_s2fm_tpu.sfm.pipeline import LevelSfM as JSfM
from level_s2fm_tpu_torch.convert import params_from_jax
from level_s2fm_tpu_torch.fields import hashgrid as thash
from level_s2fm_tpu_torch.geometry import transforms as tT
from level_s2fm_tpu_torch.sfm import trad as ttrad
from level_s2fm_tpu_torch.sfm.pipeline import LevelSfM as TSfM

from test_torch_port_trad import _paired_cfgs  # noqa: F401
from torch_port_helpers import (
    TINY_ARGS, dlt_scene, jax_opt, jax_params_np, perturb_table, torch_opt)


def test_sdf_fit_phase_steps_with_jax_draws():
    """Five ``SdfFitPhase`` steps from the same parameters on the rays
    through view 0's triangulated keypoints."""
    opt = jax_opt()
    jparams = jax.tree.map(jnp.asarray, perturb_table(jax_params_np(opt), seed=2))
    jcfgs = JSfM(opt, seed=0).cfgs
    tm_cfgs = TSfM(torch_opt(), seed=0, device="cpu").cfgs
    _, _, (tcs, tps) = dlt_scene(n_views=2, size=32, n_points=128, noise=0.0)
    cam = tcs.cameras[0]
    kidx = np.where(cam.idx2d_to_3d >= 0)[0]
    c, r = tT.get_center_and_ray(torch.as_tensor(cam.pose())[None],
                                 torch.as_tensor(cam.intr),
                                 torch.as_tensor(cam.kypts[kidx]))
    n, N = len(kidx), 64
    batch = {"center": np.zeros((1, N, 3), np.float32),
             "ray": np.tile(np.float32([0, 0, 1]), (1, N, 1)),
             "pts_at_rays": np.zeros((N, 3), np.float32),
             "kp_mask": np.arange(N) < n}
    batch["center"][0, :n], batch["ray"][0, :n] = c[0].numpy(), r[0].numpy()
    batch["pts_at_rays"][:n] = tps.get_xyzs(cam.idx2d_to_3d[kidx])
    batch["pts"], batch["pts_mask"] = batch["pts_at_rays"], batch["kp_mask"]
    key = jax.random.PRNGKey(5)
    _, jmet = jtrad.SdfFitPhase(jcfgs, max_iter=5).run(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    tphase = ttrad.SdfFitPhase(tm_cfgs, max_iter=5)
    state = tphase.init_state(params_from_jax(jax.tree.map(np.asarray, jparams),
                                              device="cpu"))
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    n_pick = min(4096, N)
    for i, k in enumerate(jax.random.split(jax.random.fold_in(key, 0), 5)):
        k1, k2, _ = jax.random.split(k, 3)
        draws = {"factor_rand": torch.as_tensor(np.array(jax.random.uniform(k1, (N,)))),
                 "pick": torch.as_tensor(np.array(jax.random.permutation(k2, N)[:n_pick]))}
        tmet = tphase.step(state, tb, None, draws=draws)
        for name in ("tracing_loss", "sdf_surf", "eikonal_loss", "all"):
            np.testing.assert_allclose(float(tmet[name]), float(jmet[name][i]),
                                       rtol=1e-4, err_msg=f"step {i} {name}")
    assert float(jmet["all"][-1]) < float(jmet["all"][0])



def test_paired_dense_matches_the_jax_paired_path():
    """The port accepts ``paired_dense`` and runs its one gather; held to
    the JAX package's paired path as ``test_hashgrid_paired.py`` holds it
    to the default path, at exact corners and the domain boundary too."""
    from level_s2fm_tpu_torch.config import build_options
    assert thash.config_from_opt(build_options(
        TINY_ARGS + ["--SDF.Hash_config.paired_dense"])).paired_dense
    jcfg, tcfg = _paired_cfgs()
    assert jcfg.n_dense_levels == 2
    rng = np.random.default_rng(6)
    table = np.asarray(jhash.init_table(jax.random.PRNGKey(3), jcfg)) * 1e4
    x = np.concatenate([rng.uniform(0, 1, (257, 3)), np.zeros((1, 3)), np.ones((1, 3)),
                        [[0.25, 1.0, 0.0]]], 0).astype(np.float32)
    inner = rng.uniform(0.01, 0.99, (301, 3)).astype(np.float32)
    outside = np.float32([[-0.05, 0.5, 0.5], [0.5, 1.2, 0.5]])
    cot = rng.standard_normal((123, 12)).astype(np.float32)
    pts_g = rng.uniform(0.01, 0.99, (123, 3)).astype(np.float32)

    @jax.jit
    def jax_side(t):
        g = jax.grad(lambda t: jnp.sum(jhash.encode(t, pts_g, jcfg) * cot))(t / 1e4)
        return (jhash.encode(t, x, jcfg), jhash.encode_with_grad(t, inner, jcfg),
                jhash.encode_with_grad(t, outside, jcfg), g)

    ja, (je, jd), (jeo, jdo), jg = jax.tree.map(np.asarray, jax_side(table))
    tt = torch.as_tensor(table)
    np.testing.assert_allclose(thash.encode(tt, torch.as_tensor(x), tcfg).numpy(), ja,
                               rtol=0, atol=1e-6)
    te, td = thash.encode_with_grad(tt, torch.as_tensor(inner), tcfg)
    np.testing.assert_allclose(te.numpy(), je, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), jd, atol=1e-4)
    teo, tdo = thash.encode_with_grad(tt, torch.as_tensor(outside), tcfg)
    np.testing.assert_allclose(teo.numpy(), jeo, atol=1e-6)
    np.testing.assert_allclose(tdo.numpy(), jdo, atol=1e-5)
    assert np.allclose(tdo.numpy()[0, :, 0], 0.0, atol=1e-5)
    assert np.allclose(tdo.numpy()[1, :, 1], 0.0, atol=1e-5)
    t1 = (tt / 1e4).requires_grad_(True)
    (g,) = torch.autograd.grad(
        (thash.encode(t1, torch.as_tensor(pts_g), tcfg) * torch.as_tensor(cot)).sum(), t1)
    np.testing.assert_allclose(g.numpy(), jg, atol=1e-5)
