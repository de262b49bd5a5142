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
import jax
import jax.numpy as jnp
import numpy as np
import torch

from level_s2fm_tpu.rendering import renderer as jren
from level_s2fm_tpu_torch.convert import params_from_jax
from level_s2fm_tpu_torch.rendering import renderer as tren

from torch_port_helpers import (
    field_cfgs, jax_opt, rel_err, render_both, sphere_rays, torch_opt, visible_params)

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
