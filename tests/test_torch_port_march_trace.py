"""The sphere re-evaluation and tracing against the JAX package (see
``test_torch_port_march.py``).
Kept apart so that it runs after the suite's long files have started: pytest-xdist's loadfile queue starts the files with more tests first.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from level_s2fm_tpu.fields import sdf as jsdf
from level_s2fm_tpu_torch.convert import params_from_jax
from level_s2fm_tpu_torch.fields import sdf as tsdf

from test_torch_port_march import TOL, setup  # noqa: F401
from torch_port_helpers import rel_err


def test_sphere_reeval_and_gradients_match_jax(setup):
    jcfg, tcfg, pnp, c, r = setup
    jp = jax.tree.map(jnp.asarray, pnp["sdf"])
    jm = jax.jit(lambda p, c_, r_: jsdf.sphere_march(p, jcfg, c_, r_))(
        jp, jnp.asarray(c), jnp.asarray(r))
    w = np.random.default_rng(1).normal(size=(c.shape[1],)).astype(np.float32)

    def jloss(p):
        d, s, f, pts = jsdf.sphere_reeval(p, jcfg, jm, jnp.asarray(c), jnp.asarray(r))
        return jnp.sum(d[0] * w) + jnp.sum(s) + 0.1 * jnp.sum(pts), (d, s, f, pts)

    (_, (jd, js, jf, jpts)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)

    tp = params_from_jax(pnp["sdf"], device="cpu")
    tp["table"].requires_grad_(True)
    tm = tsdf.sphere_march(tp, tcfg, torch.as_tensor(c), torch.as_tensor(r))
    d, s, f, pts = tsdf.sphere_reeval(tp, tcfg, tm, torch.as_tensor(c), torch.as_tensor(r))
    (torch.sum(d[0] * torch.as_tensor(w)) + s.sum() + 0.1 * pts.sum()).backward()
    assert rel_err(d.detach(), jd) < TOL
    assert rel_err(s.detach(), js) < TOL
    assert rel_err(pts.detach(), jpts) < TOL
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    assert f.any() and not f.all()
    assert rel_err(tp["table"].grad, jg["table"]) < 1e-4


def test_sphere_tracing_with_the_jax_draws_matches(setup):
    jcfg, tcfg, pnp, c, r = setup
    key = jax.random.PRNGKey(7)
    jt = jax.jit(lambda p, c_, r_, k: jsdf.sphere_tracing(
        p, jcfg, c_, r_, key=k, track_subsample=32, max_sample_pts=100))(
        jax.tree.map(jnp.asarray, pnp["sdf"]), jnp.asarray(c), jnp.asarray(r), key)
    # the JAX draws of march_samples, replayed for the port
    BN = c.shape[1]
    k1, k2, k3 = jax.random.split(key, 3)
    factor = np.array(jax.random.uniform(k1, (BN,)))
    pick = np.array(jax.random.permutation(k2, BN)[:32])
    n_all = 32 * tcfg.iters_max + BN
    pick2 = np.array(jax.random.permutation(k3, n_all)[:100])

    tp = params_from_jax(pnp["sdf"], device="cpu")
    tc_, tr_ = torch.as_tensor(c), torch.as_tensor(r)
    tt = tsdf.sphere_tracing(tp, tcfg, tc_, tr_, gen=torch.Generator().manual_seed(0),
                             track_subsample=32, max_sample_pts=100)
    for a in ("d_pred", "sdf_surf", "pts_surface"):
        assert rel_err(getattr(tt, a).detach(), getattr(jt, a)) < TOL, a
    np.testing.assert_array_equal(tt.finish_mask.numpy(), np.asarray(jt.finish_mask))
    m = tsdf.sphere_march(tp, tcfg, tc_, tr_)
    samples = tsdf.march_samples(m, tc_, tr_, track_subsample=32, max_sample_pts=100,
                                 factor_rand=factor, pick=pick, pick2=pick2)
    assert samples.shape == tuple(jt.sample_pts.shape)
    assert rel_err(samples, jt.sample_pts) < TOL
