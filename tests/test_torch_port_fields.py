"""Parity of the port's fields (hash grid, SDF with analytic normals,
radiance) with the JAX package, on the CPU at small widths.

Tolerances: both sides compute in float32 with the same operation order
up to reduction order, so outputs agree to ~1e-6 relative; the bar is
1e-5 relative to the largest magnitude (rel_err). Cell assignment
(floor(x * res)) is compared exactly: the inputs here are given in unit
coordinates, so both sides floor the same float32 product.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from level_s2fm_tpu.fields import hashgrid as jhg
from level_s2fm_tpu.fields import radiance as jradf
from level_s2fm_tpu.fields import sdf as jsdf
from level_s2fm_tpu_torch.convert import params_from_jax
from level_s2fm_tpu_torch.fields import hashgrid as thg
from level_s2fm_tpu_torch.fields import radiance as tradf
from level_s2fm_tpu_torch.fields import sdf as tsdf

from torch_port_helpers import jax_opt, jax_params_np, perturb_table, rel_err, torch_opt

TOL = 1e-5


def _grid_cfgs(dtype="float32"):
    kw = dict(n_levels=4, n_features_per_level=2, log2_hashmap_size=13,
              base_resolution=16, per_level_scale=5.04, compute_dtype=dtype)
    return jhg.HashGridConfig(**kw), thg.HashGridConfig(**kw)


def test_level_indices_match_jax():
    rng = np.random.default_rng(0)
    g = rng.integers(0, 2049, size=(3, 500, 3)).astype(np.int32)
    res = np.asarray([16, 300, 2048], np.int32)[:, None]
    fits = ((res.astype(np.int64) + 1) ** 3 <= 8192)
    j = jhg._level_indices(jnp.asarray(g), jnp.asarray(res), jnp.asarray(fits), 8192)
    t = thg._level_indices(torch.as_tensor(g.astype(np.int64)),
                           torch.as_tensor(res.astype(np.int64)),
                           torch.as_tensor(fits), 8192)
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_with_grad_matches_jax(dtype):
    jcfg, tcfg = _grid_cfgs(dtype)
    rng = np.random.default_rng(1)
    table = (0.1 * rng.standard_normal((4, 8192, 2))).astype(np.float32)
    x = rng.uniform(0, 1, size=(301, 3)).astype(np.float32)
    c1 = rng.standard_normal((301, 8)).astype(np.float32)
    c2 = rng.standard_normal((301, 8, 3)).astype(np.float32)

    def jloss(tab, xx):
        e, d = jhg.encode_with_grad(tab, xx, jcfg)
        return jnp.sum(e * c1) + jnp.sum(d * c2), (e, d)

    (_, (je, jd)), (jgt, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(table), jnp.asarray(x))
    tt = torch.tensor(table, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    te, td = thg.encode_with_grad(tt, tx, tcfg)
    (torch.sum(te * torch.as_tensor(c1)) + torch.sum(td * torch.as_tensor(c2))).backward()
    assert rel_err(te.detach(), je) < TOL
    assert rel_err(td.detach(), jd) < TOL
    assert tt.grad.dtype == torch.float32
    assert rel_err(tt.grad, jgt) < TOL
    assert rel_err(tx.grad, jgx) < TOL
    # encode (no Jacobian) is the same features
    assert rel_err(thg.encode(tt.detach(), tx.detach(), tcfg), je) < TOL


def test_bf16_reads_accumulate_the_table_gradient_in_f32():
    """Thousands of points in one coarse cell: the bf16-read gather's
    table gradient must be the f32 one (it does not depend on the table
    values), i.e. accumulated in f32, not rounded to bf16."""
    _, cfg32 = _grid_cfgs("float32")
    _, cfg16 = _grid_cfgs("bfloat16")
    rng = np.random.default_rng(2)
    table = (0.1 * rng.standard_normal((4, 8192, 2))).astype(np.float32)
    x = (0.5 + 0.01 * rng.uniform(size=(4096, 3))).astype(np.float32)
    c = torch.as_tensor(rng.uniform(0.9, 1.1, size=(4096, 8)).astype(np.float32))
    grads = []
    for cfg in (cfg32, cfg16):
        t = torch.tensor(table, requires_grad=True)
        (thg.encode(t, torch.as_tensor(x), cfg) * c).sum().backward()
        grads.append(t.grad)
    assert grads[1].dtype == torch.float32
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-6, atol=0.0)
    # and the bf16 forward really rounds the reads
    e32 = thg.encode(torch.as_tensor(table), torch.as_tensor(x), cfg32)
    e16 = thg.encode(torch.as_tensor(table), torch.as_tensor(x), cfg16)
    assert 0 < float((e32 - e16).abs().max()) < 1e-2


@pytest.fixture(scope="module")
def sdf_setup():
    opt_j, opt_t = jax_opt(), torch_opt()
    pnp = perturb_table(jax_params_np(opt_j))
    jcfg = jsdf.config_from_opt(opt_j)
    tcfg = tsdf.config_from_opt(opt_t)
    return opt_j, opt_t, pnp, jcfg, tcfg


def test_infer_all_with_normal_matches_jax(sdf_setup):
    opt_j, opt_t, pnp, jcfg, tcfg = sdf_setup
    rng = np.random.default_rng(3)
    xyz = rng.uniform(-0.9, 0.9, size=(257, 3)).astype(np.float32)
    w = rng.standard_normal((257, 3)).astype(np.float32)

    def jloss(p, x):
        s, f, n = jsdf.infer_all_with_normal(p, jcfg, x)
        nn_ = jnp.sqrt(jnp.sum(n * n, -1) + 1e-12)
        return jnp.sum(jnp.abs(nn_ - 1)) + jnp.sum(s) + jnp.sum(f * 0.1) \
            + jnp.sum(n * w), (s, f, n)

    jp = jax.tree.map(jnp.asarray, pnp["sdf"])
    (_, (js, jf, jn)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(xyz))

    tp = params_from_jax(pnp["sdf"], device="cpu")
    for leaf in (tp["table"], tp["beta"], *[v for lay in tp["mlp"]["layers"] for v in lay.values()]):
        leaf.requires_grad_(True)
    tx = torch.tensor(xyz, requires_grad=True)
    s, f, n = tsdf.infer_all_with_normal(tp, tcfg, tx)
    nn_ = torch.sqrt(torch.sum(n * n, -1) + 1e-12)
    (torch.sum(torch.abs(nn_ - 1)) + s.sum() + (f * 0.1).sum()
     + (n * torch.as_tensor(w)).sum()).backward()
    assert rel_err(s.detach(), js) < TOL
    assert rel_err(f.detach(), jf) < TOL
    assert rel_err(n.detach(), jn) < TOL
    assert rel_err(tp["table"].grad, jgp["table"]) < TOL
    for tl, jl in zip(tp["mlp"]["layers"], jgp["mlp"]["layers"]):
        for k in ("V", "g", "b"):
            assert rel_err(tl[k].grad, jl[k]) < TOL, k
    assert rel_err(tx.grad, jgx) < TOL
    # infer_sdf / infer_all agree with the fused eval
    s2, f2 = tsdf.infer_all(tp, tcfg, tx.detach())
    assert rel_err(s2.detach(), js) < TOL and rel_err(f2.detach(), jf) < TOL
    # the analytic normal is the autograd spatial gradient of the sdf
    x2 = tx.detach().clone().requires_grad_(True)
    (g_auto,) = torch.autograd.grad(tsdf.infer_sdf(tp, tcfg, x2).sum(), x2)
    assert rel_err(n.detach(), g_auto) < 1e-4


def test_radiance_and_forward_ab_match_jax(sdf_setup):
    opt_j, opt_t, pnp, jcfg, tcfg = sdf_setup
    jrc, trc = jradf.config_from_opt(opt_j), tradf.config_from_opt(opt_t)
    assert jrc.input_enc_dim == trc.input_enc_dim
    rng = np.random.default_rng(4)
    enc = rng.standard_normal((100, trc.input_enc_dim)).astype(np.float32)
    view = rng.standard_normal((100, 3)).astype(np.float32)
    jr = jradf.infer_app(jax.tree.map(jnp.asarray, pnp["rad"]), jrc, jnp.asarray(enc))
    tr = tradf.infer_app(params_from_jax(pnp["rad"], device="cpu"), trc,
                         torch.as_tensor(enc))
    assert rel_err(tr, jr) < TOL
    assert rel_err(tradf.embed_view(trc, torch.as_tensor(view)),
                   jradf.embed_view(jrc, jnp.asarray(view))) < TOL
    ja, jb = jsdf.forward_ab(jax.tree.map(jnp.asarray, pnp["sdf"]), jcfg)
    ta, tb = tsdf.forward_ab(params_from_jax(pnp["sdf"], device="cpu"), tcfg)
    assert rel_err(ta, ja) < TOL and rel_err(tb, jb) < TOL


def test_port_init_is_the_geometric_sphere():
    """The port's own init at the default MLP width: sdf ~ |x| - bias
    (geometric init; the JAX package's gives 0.118 on these points), the
    table uniform in +-1e-4, beta = log(beta_init). The error depends on
    the random first layer, so it is averaged over four seeds."""
    opt = torch_opt(["--SDF.arch.layers=[null,64,16]"])
    cfg = tsdf.config_from_opt(opt)
    x = torch.as_tensor(np.random.default_rng(1).uniform(
        -0.8, 0.8, (500, 3)).astype(np.float32))
    errs = []
    for seed in range(4):
        p = tsdf.init_params(cfg, torch.Generator().manual_seed(seed))
        assert p["table"].shape == (4, 8192, 2)
        assert float(p["table"].abs().max()) <= 1e-4
        s = tsdf.infer_sdf(p, cfg, x)[..., 0]
        errs.append(float((s - (x.norm(dim=-1) - cfg.sphere_bias)).abs().mean()))
    assert np.mean(errs) < 0.15, errs
    torch.testing.assert_close(p["beta"], torch.tensor([np.log(cfg.beta_init)],
                                                       dtype=torch.float32))
