"""The port's fused Laplace-sigma composite (rendering/fused_composite.py)
against the JAX package's: the plain versions against ``_forward_jnp`` /
``_backward_jnp`` and against the interpreted Pallas kernels, an f64
``gradcheck`` of the autograd op's CPU path, the renderer-shaped adapter
with its VJP, and the CUDA wrappers' input checks. The CUDA kernels
themselves run only on the card (marked ``gpu``); ``chip_smoke.py``
holds them to the plain versions there.

The port takes the renderer's layout (rgb/normal [R,K,3], bool valid, one
delta per ray); the JAX side gets its own ([3,R,K], float valid, delta
broadcast over K), and the port's per-ray d_delta is compared with the
JAX d_delta summed over K.

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
    """The port's layout: (sdf, valid bool, delta [R], rgb [R,K,3], depth,
    normal [R,K,3], alpha, beta) and the cotangents (g_rgb [R,3], g_depth,
    g_normal [R,3], g_op)."""
    rng = np.random.default_rng(seed)
    sdf = (rng.normal(size=(R, K)) * 0.1).astype(np.float32)
    valid = rng.uniform(size=(R, K)) > 0.3
    delta = rng.uniform(0.01, 0.1, size=(R,)).astype(np.float32)
    rgb = rng.uniform(size=(R, K, 3)).astype(np.float32)
    depth = rng.uniform(0.5, 3.0, size=(R, K)).astype(np.float32)
    normal = rng.normal(size=(R, K, 3)).astype(np.float32)
    alpha = np.float32(20.0)
    beta = np.float32(0.05)
    g = (rng.normal(size=(R, 3)).astype(np.float32),
         rng.normal(size=(R,)).astype(np.float32),
         rng.normal(size=(R, 3)).astype(np.float32),
         rng.normal(size=(R,)).astype(np.float32))
    return (sdf, valid, delta, rgb, depth, normal, alpha, beta), g


def _jax_layout(args, g):
    """The JAX package's layout of the same inputs."""
    sdf, valid, delta, rgb, depth, normal, alpha, beta = args
    K = sdf.shape[1]
    ja = (sdf, valid.astype(np.float32), np.repeat(delta[:, None], K, 1),
          np.moveaxis(rgb, -1, 0), depth, np.moveaxis(normal, -1, 0), alpha, beta)
    jg = (g[0].T, g[1], g[2].T, g[3])
    return (tuple(jnp.asarray(a) for a in ja), tuple(jnp.asarray(a) for a in jg))


def _torch(args, dtype=torch.float32):
    return tuple(torch.tensor(np.asarray(a)) if np.asarray(a).dtype == bool
                 else torch.tensor(np.asarray(a), dtype=dtype) for a in args)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=0, atol=atol)


def _port_bwd_as_jax(t_bwd):
    """The port's (d_sdf, d_delta, d_rgb, d_depth, d_normal) in the JAX
    package's layout, d_delta still per ray."""
    d_sdf, d_delta, d_rgb, d_depth, d_normal = (np.asarray(x) for x in t_bwd[:5])
    return (d_sdf, d_delta, np.moveaxis(d_rgb, -1, 0), d_depth,
            np.moveaxis(d_normal, -1, 0))


@pytest.mark.parametrize("R,K", [(37, 8), (129, 32), (71, 128), (45, 257)])
def test_plain_versions_match_jnp_and_interpreted_pallas(R, K):
    """atol 2e-4 (the Pallas kernel's bar); dalpha/dbeta are sums over R*K
    terms and are compared relatively, 1e-4."""
    args, g = _inputs(R, K, seed=R + K)
    jargs, jg = _jax_layout(args, g)
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
    t_out = (t_out[0].T, t_out[1], t_out[2].T, t_out[3])
    for t, j, p in zip(t_out, j_out, p_out):
        _close(t, j)
        _close(t, p)
    t_main = _port_bwd_as_jax(t_bwd)
    for ref in (j_bwd, p_bwd):
        d_sdf, _, d_delta, d_rgb, d_depth, d_normal, d_a, d_b = ref
        jr = (d_sdf, np.asarray(d_delta).sum(-1), d_rgb, d_depth, d_normal)
        for t, j in zip(t_main, jr):
            _close(t, j)
        np.testing.assert_allclose(float(t_bwd[5]), float(d_a), rtol=1e-4)
        np.testing.assert_allclose(float(t_bwd[6]), float(d_b), rtol=1e-4)


def test_autograd_op_gradcheck_f64():
    """Finite differences in float64 (eps 1e-6, atol 1e-6) of every
    differentiable input, per-ray delta, alpha and beta included."""
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
    scalar loss through both (rtol 1e-4, atol 1e-5: float32 sums in
    another order). JAX broadcasts the per-ray delta over K itself, so its
    gradient is per ray too."""
    args, g = _inputs(33, 16, seed=9)
    K = args[0].shape[1]
    jvalid = jnp.asarray(args[1].astype(np.float32))

    def jloss(sdf, delta, rgb, depth, normal, alpha, beta):
        o = pc.laplace_composite(sdf, jvalid, jnp.repeat(delta[:, None], K, 1),
                                 jnp.moveaxis(rgb, -1, 0), depth,
                                 jnp.moveaxis(normal, -1, 0), alpha, beta, False)
        o = (o[0].T, o[1], o[2].T, o[3])
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
    """The renderer-shaped adapter, outputs (atol 1e-5: float32 sums in
    another order) and its VJP with respect to ray and bin_w (rtol 1e-4,
    atol 1e-5), against the JAX adapter fed the broadcast deltas."""
    B, HW, K = 2, 35, 8
    rng = np.random.default_rng(1)
    ray = rng.normal(size=(B, HW, 3)).astype(np.float32)
    rgbs = rng.uniform(size=(B, HW, K, 3)).astype(np.float32)
    sdfs = (rng.normal(size=(B, HW, K)) * 0.1).astype(np.float32)
    valid = rng.uniform(size=(B, HW, K)) > 0.5
    bin_w = rng.uniform(0.01, 0.1, size=(B, HW)).astype(np.float32)
    depth = rng.uniform(0.5, 2.0, size=(B, HW, K)).astype(np.float32)
    normals = rng.normal(size=(B, HW, K, 3)).astype(np.float32)
    cot = [rng.normal(size=s).astype(np.float32)
           for s in ((B, HW, 3), (B, HW, 1), (B, HW, 3), (B, HW, 1))]

    def jfn(ray_, bin_w_):
        deltas = jnp.broadcast_to(bin_w_[..., None], (B, HW, K))
        return pc.composite_fused(ray_, jnp.asarray(rgbs), jnp.asarray(sdfs),
                                  jnp.asarray(valid), deltas, jnp.asarray(depth),
                                  jnp.asarray(normals), 20.0, 0.05, use_pallas=False)

    def jall(ray_, bin_w_, cot_):
        out, vjp = jax.vjp(jfn, ray_, bin_w_)
        return out, vjp(cot_)

    j, (j_dray, j_dbin) = jax.jit(jall)(jnp.asarray(ray), jnp.asarray(bin_w),
                                        tuple(jnp.asarray(c) for c in cot))
    t_ray = torch.tensor(ray, requires_grad=True)
    t_bin = torch.tensor(bin_w, requires_grad=True)
    t = fc.composite_fused(t_ray, torch.tensor(rgbs), torch.tensor(sdfs),
                           torch.tensor(valid), t_bin, torch.tensor(depth),
                           torch.tensor(normals), torch.tensor(20.0),
                           torch.tensor(0.05))
    for a, b in zip(t, j):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a.detach(), b, 1e-5)
    torch.autograd.backward(t, [torch.tensor(c) for c in cot])
    np.testing.assert_allclose(t_ray.grad.numpy(), np.asarray(j_dray),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t_bin.grad.numpy(), np.asarray(j_dbin),
                               rtol=1e-4, atol=1e-5)


def test_cuda_entry_rejects_cpu_tensors():
    args, g = _inputs(5, 8)
    t = _torch(args)
    with pytest.raises(ValueError):
        fc.forward_cuda(*t)
    with pytest.raises(ValueError):
        fc.backward_cuda(*t, *_torch(g))


def _misaligned(x):
    """The same values 4 bytes past a 16-byte boundary."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype)[1:]
    flat.copy_(x.reshape(-1))
    return flat.view(x.shape)


_BAD_INPUTS = {
    "sdf_f64": lambda t: t.__setitem__(0, t[0].double()),
    "valid_float": lambda t: t.__setitem__(1, t[1].float()),
    "delta_per_sample": lambda t: t.__setitem__(2, t[2][:, None].expand(t[0].shape).clone()),
    "rgb_planes": lambda t: t.__setitem__(3, t[3].movedim(-1, 0).contiguous()),
    "depth_short": lambda t: t.__setitem__(4, t[4][:, :-1].contiguous()),
    "normal_strided": lambda t: t.__setitem__(5, t[5].transpose(0, 1).contiguous().transpose(0, 1)),
    "rgb_misaligned": lambda t: t.__setitem__(3, _misaligned(t[3])),
    "sdf_misaligned": lambda t: t.__setitem__(0, _misaligned(t[0])),
    "alpha_two": lambda t: t.__setitem__(6, torch.stack([t[6], t[6]])),
    "beta_f64": lambda t: t.__setitem__(7, t[7].double()),
    "k_over_max": None,
}


@pytest.mark.parametrize("case", sorted(_BAD_INPUTS))
def test_check_inputs_rejects_bad_inputs(case):
    """The wrappers' checks need no card: each bad input raises
    ValueError before anything is built or launched; good inputs pass."""
    R, K = (3, fc.MAX_K + 1) if case == "k_over_max" else (12, 8)
    args, _ = _inputs(R, K, seed=3)
    t = list(_torch(args))
    if case != "k_over_max":
        assert fc.check_inputs(*t) == (R, K)
        _BAD_INPUTS[case](t)
    with pytest.raises(ValueError):
        fc.check_inputs(*t)


_FULL = torch.arange(2 * 10 * 3, dtype=torch.float32).reshape(2, 10, 3)
_GRADS = {  # per-ray cotangents [2,4,3] as autograd may hand them back
    "slice": _FULL[:, 2:6],                                  # ray_chunk slices
    "broadcast": torch.ones(()).expand(2, 4, 3),             # from a .sum()
    "channels_strided": torch.arange(60.0).reshape(2, 3, 10).transpose(1, 2)[:, 2:6],
    "contiguous": _FULL[:, :4].contiguous(),
}


@pytest.mark.parametrize("case", sorted(_GRADS) + ["shape", "dtype", "lead3_strided"])
def test_grad_strides_addressing_and_rejects(case):
    """Cotangent addressing: a strided [B,HW,3] slice (what autograd hands
    back from the renderer's chunk concatenation), a broadcast and other
    strides are addressed in place, element by element; wrong shapes,
    dtypes and strided leads of more than two dims raise."""
    if case in _GRADS:
        g = _GRADS[case]
        sb, sr, sc = fc.grad_strides((2, 4), "g", g, 3)
        group = fc.ray_group((2, 4))
        base = g.storage_offset()                     # what g.data_ptr() points at
        store = g.untyped_storage()
        flat = torch.tensor([], dtype=g.dtype).set_(store)
        for r in range(8):
            b, i = divmod(r, group)
            got = flat[base + b * sb + i * sr + sc * torch.arange(3)]
            assert torch.equal(got, g[b, i])
        return
    g = _GRADS["slice"]
    bad = {"shape": ((2, 5), g, 3), "dtype": ((2, 4), g.double(), 3),
           "lead3_strided": ((1, 2, 4), g[None], 3)}[case]
    with pytest.raises(ValueError):
        fc.grad_strides(bad[0], "g", bad[1], bad[2])


@pytest.mark.gpu
def test_kernels_match_plain_versions_on_gpu(gpu):
    """Both instances (registers: K <= 128, K % 4 == 0; chunked: the rest)
    against the plain versions (atol 2e-4; dalpha/dbeta rtol 1e-4), the
    per-ray d_delta included, and a backward run twice is bitwise equal."""
    for R, K in ((8192, 32), (1000, 32), (257, 128), (37, 40), (300, 257), (37, 10)):
        args, g = _inputs(R, K, seed=K)
        t = [a.cuda() for a in _torch(args)]
        gg = [a.cuda() for a in _torch(g)]
        out_r = fc._forward_ref(*t)
        br = fc._backward_ref(tuple(t), tuple(gg))
        out_k = fc.forward_cuda(*t)
        for a, b in zip(out_k, out_r):
            torch.testing.assert_close(a, b, rtol=0, atol=ATOL)
        bk = fc.backward_cuda(*t, *gg)
        for i, (a, b) in enumerate(zip(bk, br)):
            if i >= 5:
                torch.testing.assert_close(a, b, rtol=1e-4, atol=0)
            else:
                torch.testing.assert_close(a, b, rtol=0, atol=ATOL)
        again = fc.backward_cuda(*t, *gg)
        for a, b in zip(bk, again):
            assert torch.equal(a, b)
    # cotangents as autograd hands them back: a strided slice, a broadcast
    R, K = 300, 32
    args, g = _inputs(R, K, seed=1)
    t = [a.cuda() for a in _torch(args)]
    g_rgb = torch.randn(2 * R, 3, device="cuda")[::2]
    g_op = torch.ones((), device="cuda").expand(R)
    br = fc._backward_ref(tuple(t), (g_rgb, None, None, g_op))
    bk = fc.backward_cuda(*t, g_rgb, None, None, g_op)
    for i, (a, b) in enumerate(zip(bk, br)):
        if i >= 5:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=0)
        else:
            torch.testing.assert_close(a, b, rtol=0, atol=ATOL)
