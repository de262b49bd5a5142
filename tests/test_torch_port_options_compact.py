"""The exact ``march_compact`` / ``reeval_compact`` against the full
evaluation (see ``test_torch_port_options.py``).
Kept apart so that it runs after the suite's long files have started: pytest-xdist's loadfile queue starts the files with more tests first.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from level_s2fm_tpu.fields import sdf as jsdf
from level_s2fm_tpu_torch.convert import params_from_jax
from level_s2fm_tpu_torch.fields import sdf as tsdf
from level_s2fm_tpu_torch.sfm import optim as toptim

from torch_port_helpers import jax_opt, rel_err, sphere_rays, torch_opt, visible_params


def test_march_and_reeval_compact_are_exact(monkeypatch):
    """Sphere tracing with ``march_compact`` and ``reeval_compact``: the
    port with the knobs = the JAX package with the knobs = the port
    without them, in values and gradients; the port evaluates fewer
    points with them."""
    knobs = ["--SDF.VolSDF.march_compact=0.5", "--SDF.VolSDF.reeval_compact=0.6"]
    # a smooth field: on a rough one (5x this perturbation) the march
    # amplifies rounding (the field's slope along a ray exceeds 1), so
    # the two packages' tracks part by 2e-3 after ten steps, knobs or not
    pnp = visible_params(jax_opt(), seed=4, scale=0.01)
    o, d = sphere_rays(64, seed=1)
    jcfg = jsdf.config_from_opt(jax_opt(knobs))
    assert jcfg.march_compact == 0.5 and jcfg.reeval_compact == 0.6
    key = jax.random.PRNGKey(0)

    def jloss(p):
        r = jsdf.sphere_tracing(p, jcfg, o, d, key=key)
        return jnp.sum(jnp.abs(r.d_pred)) + jnp.sum(jnp.abs(r.sdf_surf)), r

    (_, jr), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, pnp["sdf"]))
    k1, k2, _ = jax.random.split(key, 3)
    draws = {"factor_rand": torch.as_tensor(np.array(jax.random.uniform(k1, (64,)))),
             "pick": torch.as_tensor(np.array(jax.random.permutation(k2, 64)))}
    n_eval = []
    real = tsdf.infer_sdf
    monkeypatch.setattr(tsdf, "infer_sdf", lambda p, c, x: (
        n_eval.append(x[..., 0].numel()), real(p, c, x))[1])
    out = {}
    for name, extra in (("knobs", knobs), ("plain", [])):
        cfg = tsdf.config_from_opt(torch_opt(extra))
        tp = params_from_jax(pnp["sdf"], device="cpu")
        leaves = toptim.tree_leaves(tp)
        for x in leaves:
            x.requires_grad_(True)
        n_eval.clear()
        r = tsdf.sphere_tracing(tp, cfg, torch.as_tensor(o), torch.as_tensor(d),
                                draws=draws)
        loss = r.d_pred.abs().sum() + r.sdf_surf.abs().sum()
        g = torch.autograd.grad(loss, leaves, allow_unused=True)
        g = [torch.zeros_like(x) if gi is None else gi for x, gi in zip(leaves, g)]
        out[name] = (r, g, sum(n_eval))
    assert out["knobs"][2] < out["plain"][2]
    for r, g, _ in out.values():
        np.testing.assert_allclose(r.d_pred.detach().numpy(), np.asarray(jr.d_pred),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(r.sdf_surf.detach().numpy(), np.asarray(jr.sdf_surf),
                                   rtol=0, atol=1e-5)
        np.testing.assert_array_equal(r.finish_mask.numpy(), np.asarray(jr.finish_mask))
        for a, b in zip(g, jax.tree.leaves(jg)):
            assert rel_err(a.numpy(), np.asarray(b)) <= 1e-4
    assert torch.equal(out["knobs"][0].d_pred, out["plain"][0].d_pred)
    for a, b in zip(out["knobs"][1], out["plain"][1]):
        assert rel_err(a.numpy(), b.numpy()) <= 1e-5
