"""Adam, the frozen label and the surface projection of the port's bundle
adjustment, on the CPU (the BA steps against the JAX package are in
``test_torch_port_ba.py``, whose tolerances these share). Kept apart so
that each test file holds at most five tests: pytest-xdist's loadfile
queue starts the files with more tests first.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from level_s2fm_tpu_torch.config import build_options
from level_s2fm_tpu_torch.fields import sdf as tsdf
from level_s2fm_tpu_torch.sfm import optim as toptim
from level_s2fm_tpu_torch.sfm import phases as tphases

from torch_port_helpers import TINY_ARGS


@pytest.mark.parametrize("grads", ["identical", "drawn"])
def test_phase_adam_is_adam_stacked_to_the_last_bit(grads):
    """``PhaseAdam``'s float32 rounding: five updates equal
    ``jit(adam_stacked(...).update)``'s (through the JAX package's phase
    optimizer: per-label lr, the shared gamma) to 0 ulp, for one
    gradient repeated and for fresh gradients, of magnitudes 1e-6..10."""
    from level_s2fm_tpu.sfm import optim as joptim
    rng = np.random.default_rng(5)

    def draw(shapes):
        return {k: {n: (10.0 ** rng.uniform(-6, 1, sh) * rng.choice([-1, 1], sh))
                    .astype(np.float32) for n, sh in d.items()}
                for k, d in shapes.items()}

    shapes = {"sdf": {"table": (3, 700), "w": (16,)}, "rad": {"w": (300,)}}
    p0 = draw(shapes)
    gamma = joptim.decay_gamma(1e-3, 1e-4, 500)
    labels, lrs = {"sdf": "sdf", "rad": "color"}, {"sdf": 1e-3, "color": 1e-2}
    tx = joptim.make_phase_optimizer(p0, labels, lrs, gamma)
    st = tx.init(jax.tree.map(jnp.asarray, p0))
    opt = toptim.PhaseAdam({k: {n: torch.tensor(v) for n, v in d.items()}
                            for k, d in p0.items()}, labels, lrs, gamma)
    update = jax.jit(tx.update)
    g = draw(shapes)
    for _ in range(5):
        if grads == "drawn":
            g = draw(shapes)
        ju, st = update(jax.tree.map(jnp.asarray, g), st)
        tu = opt.updates([torch.tensor(x) for x in jax.tree.leaves(g)])
        for a, b in zip(tu, jax.tree.leaves(ju)):
            np.testing.assert_array_equal(a.numpy().view(np.int32),
                                          np.asarray(b).view(np.int32))


def test_frozen_label_gets_no_moments_and_no_update():
    p = {"sdf": {"x": torch.ones(3)}, "rad": {"y": torch.full((2,), 2.0)}}
    opt = toptim.PhaseAdam(p, {"sdf": "sdf", "rad": toptim.FROZEN},
                           {"sdf": 0.1}, gamma=1.0)
    assert len(opt.leaves) == len(opt.mu) == 1 and opt.leaves[0] is p["sdf"]["x"]
    y0 = p["rad"]["y"].clone()
    tphases.guarded_update(opt, [torch.ones(3)])
    assert torch.equal(p["rad"]["y"], y0)
    assert not torch.equal(p["sdf"]["x"], torch.ones(3))


def test_surface_projection_gradcheck():
    """BA's reprojection loss differentiates the analytic normal inside
    ``get_surface_pts`` w.r.t. the table and the MLP: the fused sdf and
    normal pass gradcheck in f64, and ``get_surface_pts``'s gradient is
    that of pts - n * sdf / |n| with |n| held constant (the divisor is
    detached, as the JAX package's stop_gradient does)."""
    opt = build_options(TINY_ARGS + ["--SDF.Hash_config.n_levels=2",
                                     "--SDF.Hash_config.log2_hashmap_size=5",
                                     "--SDF.arch.layers=[null,4,2]"])
    cfg = tsdf.config_from_opt(opt)
    gen = torch.Generator().manual_seed(0)
    params = tsdf.init_params(cfg, gen)
    table = (params["table"] + 0.05 * torch.randn(
        params["table"].shape, generator=gen)).double().requires_grad_(True)
    layers = [{k: v.double() for k, v in lay.items()}
              for lay in params["mlp"]["layers"]]
    w = layers[0]["V"].requires_grad_(True)
    pts = (0.5 * torch.randn(5, 3, generator=gen)).double()

    def field(table, w):
        return {"table": table,
                "mlp": {"layers": [dict(layers[0], V=w)] + layers[1:]}}

    def sdf_and_normal(table, w):
        s, _, n = tsdf.infer_all_with_normal(field(table, w), cfg, pts)
        return s, n

    assert torch.autograd.gradcheck(sdf_and_normal, (table, w), eps=1e-6,
                                    atol=1e-5)
    surf, _ = tsdf.get_surface_pts(field(table, w), cfg, pts)
    s, n = sdf_and_normal(table, w)
    denom = torch.linalg.norm(n, dim=-1, keepdim=True).detach()
    want = pts - n / denom * s
    torch.testing.assert_close(surf, want)
    cot = torch.randn(surf.shape, generator=gen, dtype=torch.float64)
    for a, b in zip(torch.autograd.grad(surf, (table, w), cot),
                    torch.autograd.grad(want, (table, w), cot)):
        torch.testing.assert_close(a, b)
