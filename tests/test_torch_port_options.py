"""The renderer and sphere-trace options of the port against the JAX
package, on the CPU at small widths: the adaptive ``volsdf_sampling``
and the exact ``march_compact`` / ``reeval_compact`` compactions.

Tolerances (measured margins in brackets): the VolSDF helpers 1e-5
absolute on depths in (2, 4) [1e-6] and the same search indices as the
comparison-sum search; the adaptive depths 1e-4 absolute [2e-6], their
gradient 1e-3 relative [6e-6], the render on them 1e-4 [1.2e-5]; the
compactions: the port's depths with the knobs equal to its depths
without them bit for bit and its gradients to 1e-5 relative [exact],
depths and sdf values 1e-5 from the JAX package's [2e-6] and the
gradients 1e-4 relative [7e-5].
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from level_s2fm_tpu.fields import sdf as jsdf
from level_s2fm_tpu.rendering import renderer as jren
from level_s2fm_tpu_torch.convert import params_from_jax
from level_s2fm_tpu_torch.fields import sdf as tsdf
from level_s2fm_tpu_torch.rendering import renderer as tren
from level_s2fm_tpu_torch.sfm import optim as toptim

from torch_port_helpers import (field_cfgs, jax_opt, rel_err, render_both,
                                sphere_rays, torch_opt, visible_params)

def test_volsdf_helpers_and_search():
    rng = np.random.default_rng(4)
    R, N = 12, 24
    d_vals = np.sort(rng.uniform(2.0, 4.0, (R, N)), -1).astype(np.float32)
    sdf = np.linspace(0.6, -0.6, N, dtype=np.float32)[None] + \
        0.05 * rng.standard_normal((R, N)).astype(np.float32)
    sdf[0] = np.nan                     # a ray whose bound is NaN
    alpha, beta = np.float32(20.0), np.float32(0.05)

    @jax.jit
    def jax_side(d_vals, sdf):
        b = jren.error_bound(d_vals, sdf, alpha, beta)
        bins = 0.5 * (d_vals[..., 1:] + d_vals[..., :-1])
        w = jnp.nan_to_num(b, nan=1.0)
        cdf = jnp.cumsum(w / w.sum(-1, keepdims=True), -1)
        u = jnp.broadcast_to(jnp.linspace(0.0, 1.0, 30), (R, 30))
        return (b, jren.sample_pdf(bins, w, 30),
                jren.opacity_to_sample(d_vals, jnp.nan_to_num(sdf), alpha, beta, 16),
                jren._searchsorted(cdf, u), cdf, u)

    jb, jpdf, jop, jidx, cdf, u = map(np.asarray, jax_side(d_vals, sdf))
    tb = tren.error_bound(torch.as_tensor(d_vals), torch.as_tensor(sdf),
                          torch.tensor(alpha), torch.tensor(beta))
    assert np.isfinite(jb).all() and jb[0].max() == np.finfo(np.float32).max
    np.testing.assert_allclose(tb.numpy(), jb, rtol=1e-5)
    w = torch.nan_to_num(torch.as_tensor(jb), nan=1.0)
    bins = torch.as_tensor(0.5 * (d_vals[..., 1:] + d_vals[..., :-1]))
    np.testing.assert_allclose(tren.sample_pdf(bins, w, 30).numpy(), jpdf,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        tren.opacity_to_sample(torch.as_tensor(d_vals), torch.nan_to_num(
            torch.as_tensor(sdf)), torch.tensor(alpha), torch.tensor(beta), 16).numpy(),
        jop, rtol=0, atol=1e-5)
    idx = tren._search_left(torch.as_tensor(cdf), torch.as_tensor(u))
    np.testing.assert_array_equal(idx.numpy(), jidx)


def _adaptive_depths(extra, o, d):
    """The adaptive depths on both sides and the gradients of a weighted
    sum of them w.r.t. beta and the ray directions, the depths on the far
    bound left out (see below)."""
    jopt, topt = jax_opt(extra), torch_opt(extra)
    jc, tc = field_cfgs(jopt), field_cfgs(topt, port=True)
    assert tc[2].volsdf_sampling and tc[2].max_upsample_iter == 2
    pnp = visible_params(jopt, scale=0.01)
    # a weight per ray, not per sample, over a function of the depths:
    # the sorts may order (near-)tied depths either way, which moves
    # their gradients between positions but not their sum
    w = np.random.default_rng(5).standard_normal((1, d.shape[1], 1)).astype(np.float32)

    def jdepth(p, o, d):
        z = jren.volsdf_sampling(p, jc[0], jc[2], o, d)
        return jnp.sum(jnp.where(z < z[..., -1:], z * z * w, 0.0)), z

    (_, jz), jg = jax.jit(jax.value_and_grad(jdepth, argnums=(0, 2), has_aux=True))(
        jax.tree.map(jnp.asarray, pnp["sdf"]), o, d)
    tp = params_from_jax(pnp, device="cpu")
    tp["sdf"]["beta"].requires_grad_(True)
    td = torch.as_tensor(d).requires_grad_(True)
    tz = tren.volsdf_sampling(tp["sdf"], tc[0], tc[2], torch.as_tensor(o), td)
    g = torch.autograd.grad(torch.where(tz < tz[..., -1:], tz * tz * torch.as_tensor(w),
                                        0.0).sum(), (tp["sdf"]["beta"], td))
    assert tz.shape == (1, d.shape[1], 24)
    np.testing.assert_allclose(tz.detach().numpy(), np.asarray(jz), rtol=0, atol=1e-4)
    return np.asarray(jz), tz.detach().numpy(), (jg[0]["beta"], jg[1]), g


def test_volsdf_sampling_depths_and_render():
    """The adaptive depths, their gradient w.r.t. beta and the rays, and
    the compacted render on them.

    The reference sampler puts samples on the far bound: on a ray through
    the surface the error bound overflows (exp(-R_t) = 0 times exp(sum
    of errors) = inf gives NaN, mapped to the largest float) and the
    pdf's sum with it, and on any ray whose opacity stays below a
    quantile of the final samples ``opacity_to_sample`` places them at
    d_lo + t (d_hi - d_lo) with d_lo = d_hi the last depth and
    t = (u - c) / 1e-8. Their values agree; their gradient, 1 arriving as
    (1 - t) + t with t ~ 1e7, is rounding (the JAX package's jitted and
    eager gradients of one loss differ by 40% there), so the gradient is
    held on the other depths. The depths are not uniform, yet both
    packages take the composite's bin width from the first gap."""
    extra = ["--SDF.VolSDF.volsdf_sampling", "--SDF.VolSDF.max_upsample_iter=2",
             "--SDF.VolSDF.final_sample_intvs=8"]
    o, d = sphere_rays(16)
    # rays 8..15 pass the sphere (radius 0.5) by, inside the box
    d[0, 8:, :2] = np.random.default_rng(6).uniform(0.3, 0.45, (8, 2)) * \
        np.sign(d[0, 8:, :2])
    jz, tz, jg, tg = _adaptive_depths(extra, o, d)
    # samples on the far bound, on the same rays in both
    n_far = [(z[0] == z[0, :, -1:]).sum(-1) for z in (jz, tz)]
    assert np.array_equal(n_far[0], n_far[1]) and n_far[0].max() >= 4
    gaps = np.diff(jz, axis=-1)
    assert np.ptp(gaps, axis=-1).min() > 0.1 * gaps.mean()   # not uniform
    for a, b in zip(tg, jg):
        assert float(a.abs().max()) > 0
        assert rel_err(a.numpy(), np.asarray(b)) <= 1e-3
    jout, _, tout, _, _ = render_both(extra, o, d)
    for k in ("rgb", "depth_mlp", "opacity"):
        np.testing.assert_allclose(tout[k].detach().numpy(), np.asarray(jout[k]),
                                   rtol=0, atol=1e-4, err_msg=k)


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
