"""Fused Laplace-sigma + quadrature composite (forward + backward).

Counterpart of ``level_s2fm_tpu/rendering/pallas_composite.py``. The two
Pallas TPU kernels (``_fwd_kernel``, ``_bwd_kernel``) are hand-written
CUDA kernels here (``csrc/composite.cu``: ``lc_forward``,
``lc_backward``), built for ``sm_90a`` at first use and called through
ctypes on PyTorch's current stream.

Math (per ray, K samples, already masked/compacted):
  sigma_k = alpha * psi_beta(sdf_k) * valid_k          (Laplace CDF)
  s_k     = sigma_k * delta_k                          (delta = bin * |ray|)
  T_k     = exp(-sum_{j<k} s_j)                        (strict prefix)
  w_k     = T_k * (1 - exp(-s_k))
  out     = (sum_k w_k rgb_k, sum_k w_k d_k, sum_k w_k n_k, sum_k w_k)
and the hand-derived VJP of the JAX package (see the CUDA source).

``LaplaceComposite`` is the autograd op. It takes the plain PyTorch
versions (``_forward_ref`` / ``_backward_ref``, ports of ``_forward_jnp``
/ ``_backward_jnp``) only for CPU tensors; for CUDA tensors it launches
the kernels or raises. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import kernels

#: kernel launches since the last reset (``fwd`` = lc_forward, ``bwd`` =
#: lc_backward); incremented only where a kernel is launched
LAUNCHES = {"fwd": 0, "bwd": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _sigma(sdf, valid, alpha, beta):
    e = 0.5 * torch.exp(-torch.abs(sdf) / beta)
    psi = torch.where(sdf >= 0, e, 1.0 - e)
    return alpha * psi * valid


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU path + the kernels' oracle)
# ---------------------------------------------------------------------------

def _forward_ref(sdf, valid, delta, rgb, depth, normal, alpha, beta):
    """sdf/valid/delta/depth [R,K]; rgb/normal [3,R,K]; alpha/beta [].
    Returns (rgb_sum [3,R], depth_sum [R], normal_sum [3,R], opacity [R])."""
    s = _sigma(sdf, valid, alpha, beta) * delta
    prefix = torch.cumsum(s, dim=-1) - s                 # strict prefix
    T = torch.exp(-prefix)
    w = T * (1.0 - torch.exp(-s))
    rgb_sum = torch.einsum("rk,crk->cr", w, rgb)
    depth_sum = torch.sum(w * depth, dim=-1)
    normal_sum = torch.einsum("rk,crk->cr", w, normal)
    opacity = torch.sum(w, dim=-1)
    return rgb_sum, depth_sum, normal_sum, opacity


def _backward_ref(res, g):
    sdf, valid, delta, rgb, depth, normal, alpha, beta = res
    g_rgb, g_depth, g_normal, g_op = g
    sigma = _sigma(sdf, valid, alpha, beta)
    s = sigma * delta
    prefix = torch.cumsum(s, dim=-1) - s
    T = torch.exp(-prefix)
    w = T * (1.0 - torch.exp(-s))

    G = (torch.einsum("cr,crk->rk", g_rgb, rgb)
         + g_depth[:, None] * depth
         + torch.einsum("cr,crk->rk", g_normal, normal)
         + g_op[:, None])
    Gw = G * w
    suffix = torch.flip(torch.cumsum(torch.flip(Gw, [-1]), dim=-1), [-1]) - Gw
    dL_ds = G * T * torch.exp(-s) - suffix

    d_delta = dL_ds * sigma
    dL_dsigma = dL_ds * delta
    expabs = torch.exp(-torch.abs(sdf) / beta)
    d_sdf = dL_dsigma * valid * alpha * (-(0.5 / beta)) * expabs
    psi = torch.where(sdf >= 0, 0.5 * expabs, 1.0 - 0.5 * expabs)
    d_alpha = torch.sum(dL_dsigma * valid * psi)
    d_beta = torch.sum(dL_dsigma * valid * alpha
                       * (0.5 * sdf / beta ** 2) * expabs)
    d_rgb = torch.einsum("cr,rk->crk", g_rgb, w)
    d_depth = g_depth[:, None] * w
    d_normal = torch.einsum("cr,rk->crk", g_normal, w)
    return (d_sdf, torch.zeros_like(valid), d_delta, d_rgb, d_depth, d_normal,
            d_alpha, d_beta)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = kernels.load("composite")
    if not getattr(lib, "_lc_typed", False):
        lib.lc_forward.restype = _I
        lib.lc_forward.argtypes = [_P] * 7 + [_I, _I] + [_P] * 5
        lib.lc_backward.restype = _I
        lib.lc_backward.argtypes = [_P] * 11 + [_I, _I] + [_P] * 7
        lib.lc_warps_per_block.restype = _I
        lib.lc_max_k.restype = _I
        lib._lc_typed = True
    return lib


def _check(name, t, shape, device):
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32 on {device}, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _check_inputs(sdf, valid, delta, rgb, depth, normal, ab):
    """Validate the kernels' inputs (before anything is built); returns
    (R, K, lib)."""
    dev = sdf.device
    if dev.type != "cuda":
        raise ValueError("the CUDA composite takes CUDA tensors")
    lib = _lib()
    R, K = sdf.shape
    if K > lib.lc_max_k():
        raise ValueError(f"K={K} exceeds the kernel's limit {lib.lc_max_k()}")
    for name, t, shape in (("sdf", sdf, (R, K)), ("valid", valid, (R, K)),
                           ("delta", delta, (R, K)), ("rgb", rgb, (3, R, K)),
                           ("depth", depth, (R, K)),
                           ("normal", normal, (3, R, K)), ("ab", ab, (2,))):
        _check(name, t, shape, dev)
    return R, K, lib


def forward_cuda(sdf, valid, delta, rgb, depth, normal, ab):
    """Launch ``lc_forward``. ab = [alpha, beta] as a device tensor."""
    R, K, lib = _check_inputs(sdf, valid, delta, rgb, depth, normal, ab)
    dev = sdf.device
    rgb_out = torch.empty((3, R), device=dev, dtype=torch.float32)
    depth_out = torch.empty((R,), device=dev, dtype=torch.float32)
    normal_out = torch.empty((3, R), device=dev, dtype=torch.float32)
    op_out = torch.empty((R,), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        st = lib.lc_forward(sdf.data_ptr(), valid.data_ptr(), delta.data_ptr(),
                            rgb.data_ptr(), depth.data_ptr(), normal.data_ptr(),
                            ab.data_ptr(), R, K, rgb_out.data_ptr(),
                            depth_out.data_ptr(), normal_out.data_ptr(),
                            op_out.data_ptr(), stream)
    kernels.check(st, "lc_forward")
    LAUNCHES["fwd"] += 1
    return rgb_out, depth_out, normal_out, op_out


def backward_cuda(sdf, valid, delta, rgb, depth, normal, ab,
                  g_rgb, g_depth, g_normal, g_op):
    """Launch ``lc_backward``; returns (d_sdf, d_delta, d_rgb, d_depth,
    d_normal, d_alpha, d_beta)."""
    R, K, lib = _check_inputs(sdf, valid, delta, rgb, depth, normal, ab)
    dev = sdf.device
    for name, t, shape in (("g_rgb", g_rgb, (3, R)), ("g_depth", g_depth, (R,)),
                           ("g_normal", g_normal, (3, R)), ("g_op", g_op, (R,))):
        _check(name, t, shape, dev)
    n_blocks = -(-R // lib.lc_warps_per_block())
    f32 = dict(device=dev, dtype=torch.float32)
    d_sdf = torch.empty((R, K), **f32)
    d_delta = torch.empty((R, K), **f32)
    d_rgb = torch.empty((3, R, K), **f32)
    d_depth = torch.empty((R, K), **f32)
    d_normal = torch.empty((3, R, K), **f32)
    d_ab = torch.empty((max(n_blocks, 1), 2), **f32)
    if R == 0:
        d_ab.zero_()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        st = lib.lc_backward(
            sdf.data_ptr(), valid.data_ptr(), delta.data_ptr(), rgb.data_ptr(),
            depth.data_ptr(), normal.data_ptr(), ab.data_ptr(),
            g_rgb.data_ptr(), g_depth.data_ptr(), g_normal.data_ptr(),
            g_op.data_ptr(), R, K, d_sdf.data_ptr(), d_delta.data_ptr(),
            d_rgb.data_ptr(), d_depth.data_ptr(), d_normal.data_ptr(),
            d_ab.data_ptr(), stream)
    kernels.check(st, "lc_backward")
    LAUNCHES["bwd"] += 1
    d_ab = torch.sum(d_ab, dim=0)
    return d_sdf, d_delta, d_rgb, d_depth, d_normal, d_ab[0], d_ab[1]


# ---------------------------------------------------------------------------
# autograd op
# ---------------------------------------------------------------------------

def _ab(alpha, beta):
    return torch.stack([alpha.reshape(()), beta.reshape(())]).to(
        torch.float32).contiguous()


class LaplaceComposite(torch.autograd.Function):
    """Fused composite; the kernels for CUDA tensors, the plain versions
    for CPU tensors. ``valid`` gets no gradient."""

    @staticmethod
    def forward(ctx, sdf, valid, delta, rgb, depth, normal, alpha, beta):
        ctx.save_for_backward(sdf, valid, delta, rgb, depth, normal, alpha, beta)
        if sdf.is_cuda:
            return forward_cuda(sdf, valid, delta, rgb, depth, normal,
                                _ab(alpha, beta))
        return _forward_ref(sdf, valid, delta, rgb, depth, normal, alpha, beta)

    @staticmethod
    def backward(ctx, g_rgb, g_depth, g_normal, g_op):
        sdf, valid, delta, rgb, depth, normal, alpha, beta = ctx.saved_tensors
        R = sdf.shape[0]
        z = lambda *s: torch.zeros(s, device=sdf.device, dtype=sdf.dtype)  # noqa: E731
        g_rgb = z(3, R) if g_rgb is None else g_rgb.contiguous()
        g_depth = z(R) if g_depth is None else g_depth.contiguous()
        g_normal = z(3, R) if g_normal is None else g_normal.contiguous()
        g_op = z(R) if g_op is None else g_op.contiguous()
        if sdf.is_cuda:
            d_sdf, d_delta, d_rgb, d_depth, d_normal, d_a, d_b = backward_cuda(
                sdf, valid, delta, rgb, depth, normal, _ab(alpha, beta),
                g_rgb, g_depth, g_normal, g_op)
        else:
            d_sdf, _, d_delta, d_rgb, d_depth, d_normal, d_a, d_b = _backward_ref(
                (sdf, valid, delta, rgb, depth, normal, alpha, beta),
                (g_rgb, g_depth, g_normal, g_op))
        return (d_sdf, None, d_delta, d_rgb, d_depth, d_normal,
                d_a.reshape(alpha.shape).to(alpha.dtype),
                d_b.reshape(beta.shape).to(beta.dtype))


def laplace_composite(sdf, valid, delta, rgb, depth, normal, alpha, beta):
    """Fused Laplace-sigma + composite. See the module docstring."""
    return LaplaceComposite.apply(sdf, valid, delta, rgb, depth, normal,
                                  alpha, beta)


def composite_fused(ray, rgb_samples, sdf_samples, valid, deltas,
                    depth_samples, normals, alpha, beta):
    """Adapter with the renderer's [B,HW,K,*] shapes.

    Returns (rgb [B,HW,3], depth [B,HW,1], normal [B,HW,3],
    opacity [B,HW,1]). Background/last-sample blending stays with the
    caller.
    """
    B, HW, K = sdf_samples.shape
    R = B * HW
    ray_len = torch.linalg.norm(ray, dim=-1).reshape(R)
    sdf = sdf_samples.reshape(R, K).contiguous()
    val = valid.reshape(R, K).to(sdf.dtype).contiguous()
    dl = (deltas.reshape(R, K) * ray_len[:, None]).contiguous()
    rgb = torch.movedim(rgb_samples.reshape(R, K, 3), -1, 0).contiguous()
    dep = depth_samples.reshape(R, K).contiguous()
    nrm = torch.movedim(normals.reshape(R, K, 3), -1, 0).contiguous()
    a = torch.as_tensor(alpha, dtype=torch.float32).reshape(())
    b = torch.as_tensor(beta, dtype=torch.float32).reshape(())
    rgb_sum, depth_sum, normal_sum, opacity = laplace_composite(
        sdf, val, dl, rgb, dep, nrm, a, b)
    return (torch.movedim(rgb_sum, 0, 1).reshape(B, HW, 3),
            depth_sum.reshape(B, HW, 1),
            torch.movedim(normal_sum, 0, 1).reshape(B, HW, 3),
            opacity.reshape(B, HW, 1))
