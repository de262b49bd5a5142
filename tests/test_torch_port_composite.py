"""The port's fused Laplace-sigma composite (rendering/fused_composite.py)
against the JAX package's: the plain versions against ``_forward_jnp`` /
``_backward_jnp`` and against the interpreted Pallas kernels, an f64
``gradcheck`` of the autograd op's CPU path, and the renderer-shaped
adapter. The CUDA kernels themselves run only on the card (marked
``gpu``); ``chip_smoke.py`` holds them to the plain versions there.

Bar: atol 2e-4, the bar ``bench.py::verify_pallas`` set for the Pallas
kernel; float32 agreement here is ~1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from level_s2fm_tpu.rendering import pallas_composite as pc
from level_s2fm_tpu_torch.rendering import fused_composite as fc

import torch_port_helpers  # noqa: F401  (thread setting shared by the port's tests)

ATOL = 2e-4


@pytest.fixture
def gpu():
    """Skips unless a CUDA card is present (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _inputs(R, K, seed=0):
    rng = np.random.default_rng(seed)
    sdf = (rng.normal(size=(R, K)) * 0.1).astype(np.float32)
    valid = (rng.uniform(size=(R, K)) > 0.3).astype(np.float32)
    delta = rng.uniform(0.01, 0.1, size=(R, K)).astype(np.float32)
    rgb = rng.uniform(size=(3, R, K)).astype(np.float32)
    depth = rng.uniform(0.5, 3.0, size=(R, K)).astype(np.float32)
    normal = rng.normal(size=(3, R, K)).astype(np.float32)
    alpha = np.float32(20.0)
    beta = np.float32(0.05)
    g = (rng.normal(size=(3, R)).astype(np.float32),
         rng.normal(size=(R,)).astype(np.float32),
         rng.normal(size=(3, R)).astype(np.float32),
         rng.normal(size=(R,)).astype(np.float32))
    return (sdf, valid, delta, rgb, depth, normal, alpha, beta), g


def _torch(args, dtype=torch.float32):
    return tuple(torch.tensor(np.asarray(a), dtype=dtype) for a in args)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=0, atol=atol)


@pytest.mark.parametrize("R,K", [(37, 8), (129, 32), (71, 40)])
def test_plain_versions_match_jnp_and_interpreted_pallas(R, K):
    args, g = _inputs(R, K, seed=R + K)
    jargs = tuple(jnp.asarray(a) for a in args)
    jg = tuple(jnp.asarray(a) for a in g)
    t_out = fc._forward_ref(*_torch(args))
    t_bwd = fc._backward_ref(_torch(args), _torch(g))
    j_out, j_bwd = jax.jit(lambda a, b: (pc._forward_jnp(*a), pc._backward_jnp(a, b)))(
        jargs, jg)
    old = pc.INTERPRET
    pc.INTERPRET = True
    try:
        p_out, p_bwd = jax.jit(lambda a, b: (pc._forward_pallas(*a),
                                             pc._backward_pallas(a, b)))(jargs, jg)
    finally:
        pc.INTERPRET = old
    for t, j, p in zip(t_out, j_out, p_out):
        _close(t, j)
        _close(t, p)
    for i, (t, j, p) in enumerate(zip(t_bwd, j_bwd, p_bwd)):
        if i >= 6:  # d_alpha, d_beta: sums over R*K terms, compare relatively
            np.testing.assert_allclose(float(t), float(j), rtol=1e-4)
            np.testing.assert_allclose(float(t), float(p), rtol=1e-4)
        else:
            _close(t, j)
            _close(t, p)


def test_autograd_op_gradcheck_f64():
    args, _ = _inputs(7, 9, seed=5)
    t = list(_torch(args, torch.float64))
    t[6] = torch.tensor(2.0, dtype=torch.float64)   # alpha, beta near a
    t[7] = torch.tensor(0.3, dtype=torch.float64)   # well-conditioned scale
    for i in (0, 2, 3, 4, 5, 6, 7):
        t[i].requires_grad_(True)
    assert torch.autograd.gradcheck(fc.laplace_composite, tuple(t),
                                    eps=1e-6, atol=1e-6)


def test_autograd_op_backward_matches_jax_vjp():
    """The op's backward (CPU path) == the JAX custom_vjp's gradient of a
    scalar loss through both."""
    args, g = _inputs(33, 16, seed=9)

    def jloss(sdf, delta, rgb, depth, normal, alpha, beta):
        o = pc.laplace_composite(sdf, jnp.asarray(args[1]), delta, rgb, depth,
                                 normal, alpha, beta, False)
        return sum(jnp.sum(a * b) for a, b in zip(o, g))

    diff = (0, 2, 3, 4, 5, 6, 7)
    jgr = jax.jit(jax.grad(jloss, argnums=tuple(range(7))))(
        *[jnp.asarray(args[i]) for i in diff])
    t = list(_torch(args))
    for i in diff:
        t[i].requires_grad_(True)
    out = fc.laplace_composite(*t)
    sum((o * torch.as_tensor(b)).sum() for o, b in zip(out, g)).backward()
    for i, jg_ in zip(diff, jgr):
        np.testing.assert_allclose(t[i].grad.numpy(), np.asarray(jg_),
                                   rtol=1e-4, atol=1e-5)
    assert fc.LAUNCHES == {"fwd": 0, "bwd": 0}  # CPU tensors launch nothing


def test_composite_fused_adapter_matches_jax():
    B, HW, K = 2, 35, 8
    rng = np.random.default_rng(1)
    ray = rng.normal(size=(B, HW, 3)).astype(np.float32)
    rgbs = rng.uniform(size=(B, HW, K, 3)).astype(np.float32)
    sdfs = (rng.normal(size=(B, HW, K)) * 0.1).astype(np.float32)
    valid = rng.uniform(size=(B, HW, K)) > 0.5
    deltas = rng.uniform(0.01, 0.1, size=(B, HW, K)).astype(np.float32)
    depth = rng.uniform(0.5, 2.0, size=(B, HW, K)).astype(np.float32)
    normals = rng.normal(size=(B, HW, K, 3)).astype(np.float32)
    arrs = (ray, rgbs, sdfs, valid, deltas, depth, normals)
    j = pc.composite_fused(*[jnp.asarray(a) for a in arrs], 20.0, 0.05,
                           use_pallas=False)
    t = fc.composite_fused(*[torch.as_tensor(a) for a in arrs],
                           torch.tensor(20.0), torch.tensor(0.05))
    for a, b in zip(t, j):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b, 1e-5)


def test_cuda_entry_rejects_cpu_tensors():
    args, _ = _inputs(5, 8)
    t = _torch(args)
    with pytest.raises(ValueError):
        fc.forward_cuda(*t[:6], torch.stack([t[6], t[7]]))


@pytest.mark.gpu
def test_kernels_match_plain_versions_on_gpu(gpu):
    for R, K in ((8192, 32), (1000, 32), (257, 128), (37, 40)):
        args, g = _inputs(R, K, seed=K)
        t = [a.cuda() for a in _torch(args)]
        gg = [a.cuda() for a in _torch(g)]
        ab = torch.stack([t[6], t[7]])
        out_k = fc.forward_cuda(*t[:6], ab)
        out_r = fc._forward_ref(*t)
        for a, b in zip(out_k, out_r):
            torch.testing.assert_close(a, b, rtol=0, atol=ATOL)
        bk = fc.backward_cuda(*t[:6], ab, *gg)
        br = fc._backward_ref(tuple(t), tuple(gg))
        br = (br[0], br[2], br[3], br[4], br[5], br[6], br[7])
        for i, (a, b) in enumerate(zip(bk, br)):
            if i >= 5:
                torch.testing.assert_close(a, b, rtol=1e-4, atol=0)
            else:
                torch.testing.assert_close(a, b, rtol=0, atol=ATOL)
