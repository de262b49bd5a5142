"""Fused Laplace-sigma + quadrature composite (forward + backward).

Counterpart of ``level_s2fm_tpu/rendering/pallas_composite.py``. The two
Pallas TPU kernels (``_fwd_kernel``, ``_bwd_kernel``) are hand-written
CUDA kernels here (``csrc/composite.cu``: ``lc_forward``,
``lc_backward``), built for ``sm_90a`` at first use and called through
ctypes on PyTorch's current stream.

Math (per ray, K samples, already masked/compacted):
  sigma_k = alpha * psi_beta(sdf_k) * valid_k          (Laplace CDF)
  s_k     = sigma_k * delta                            (delta = bin * |ray|)
  T_k     = exp(-sum_{j<k} s_j)                        (strict prefix)
  w_k     = T_k * (1 - exp(-s_k))
  out     = (sum_k w_k rgb_k, sum_k w_k d_k, sum_k w_k n_k, sum_k w_k)
and the hand-derived VJP of the JAX package (see the CUDA source).

Layout: the renderer's own, with any leading ray shape ``lead`` (the
renderer's ``[B,HW]``): sdf/depth ``[*lead,K]`` float32, valid
``[*lead,K]`` bool, delta ``[*lead]`` (one value per ray), rgb/normal
``[*lead,K,3]``; alpha/beta one-element float32 tensors. Outputs rgb/normal
``[*lead,3]``, depth/opacity ``[*lead]``. The JAX package's kernels take
``[3,R,K]`` planes, float valid and a per-sample delta; the function is
the same.

``LaplaceComposite`` is the autograd op. It takes the plain PyTorch
versions (``_forward_ref`` / ``_backward_ref``) only for CPU tensors; for
CUDA tensors it launches the kernels or raises. ``LAUNCHES`` counts kernel
launches and ``SHAPES`` counts them by (R, K).
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import kernels

#: kernel launches since the last reset (``fwd`` = lc_forward, ``bwd`` =
#: lc_backward); incremented only where a kernel is launched
LAUNCHES = {"fwd": 0, "bwd": 0}
#: the same launches counted by shape: {"fwd": {(R, K): n}, "bwd": {...}}
SHAPES = {"fwd": {}, "bwd": {}}

#: largest K the kernels take (``lc_max_k`` in the CUDA source)
MAX_K = 2048
#: fewest rays a block of any launch handles (``lc_min_rays_per_block``):
#: sizes the per-block dalpha/dbeta slots of the backward
MIN_RAYS_PER_BLOCK = 4


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        SHAPES[k] = {}


def _count(kind, R, K):
    LAUNCHES[kind] += 1
    SHAPES[kind][R, K] = SHAPES[kind].get((R, K), 0) + 1


def _sigma(sdf, valid, alpha, beta):
    e = 0.5 * torch.exp(-torch.abs(sdf) / beta)
    psi = torch.where(sdf >= 0, e, 1.0 - e)
    return alpha * psi * valid.to(sdf.dtype)


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU path + the kernels' oracle)
# ---------------------------------------------------------------------------

def _forward_ref(sdf, valid, delta, rgb, depth, normal, alpha, beta):
    """sdf/depth [...,K]; valid [...,K] bool; delta [...]; rgb/normal
    [...,K,3]; alpha/beta []. Returns (rgb_sum [...,3], depth_sum [...],
    normal_sum [...,3], opacity [...])."""
    s = _sigma(sdf, valid, alpha, beta) * delta[..., None]
    prefix = torch.cumsum(s, dim=-1) - s                 # strict prefix
    T = torch.exp(-prefix)
    w = T * (1.0 - torch.exp(-s))
    rgb_sum = torch.einsum("...k,...kc->...c", w, rgb)
    depth_sum = torch.sum(w * depth, dim=-1)
    normal_sum = torch.einsum("...k,...kc->...c", w, normal)
    opacity = torch.sum(w, dim=-1)
    return rgb_sum, depth_sum, normal_sum, opacity


def _backward_ref(res, g):
    """res: the forward's inputs; g: (g_rgb [...,3], g_depth [...],
    g_normal [...,3], g_op [...]), None for zero. Returns (d_sdf, d_delta
    [...] per ray, d_rgb, d_depth, d_normal, d_alpha, d_beta)."""
    sdf, valid, delta, rgb, depth, normal, alpha, beta = res
    lead = sdf.shape[:-1]
    z = lambda *s: torch.zeros(lead + s, dtype=sdf.dtype, device=sdf.device)  # noqa: E731
    g_rgb, g_depth, g_normal, g_op = (z(*s) if t is None else t for t, s in
                                      zip(g, ((3,), (), (3,), ())))
    vf = valid.to(sdf.dtype)
    sigma = _sigma(sdf, valid, alpha, beta)
    s = sigma * delta[..., None]
    prefix = torch.cumsum(s, dim=-1) - s
    T = torch.exp(-prefix)
    w = T * (1.0 - torch.exp(-s))

    G = (torch.einsum("...c,...kc->...k", g_rgb, rgb)
         + g_depth[..., None] * depth
         + torch.einsum("...c,...kc->...k", g_normal, normal)
         + g_op[..., None])
    Gw = G * w
    suffix = torch.flip(torch.cumsum(torch.flip(Gw, [-1]), dim=-1), [-1]) - Gw
    dL_ds = G * T * torch.exp(-s) - suffix

    d_delta = torch.sum(dL_ds * sigma, dim=-1)
    dL_dsigma = dL_ds * delta[..., None]
    expabs = torch.exp(-torch.abs(sdf) / beta)
    d_sdf = dL_dsigma * vf * alpha * (-(0.5 / beta)) * expabs
    psi = torch.where(sdf >= 0, 0.5 * expabs, 1.0 - 0.5 * expabs)
    d_alpha = torch.sum(dL_dsigma * vf * psi)
    d_beta = torch.sum(dL_dsigma * vf * alpha * (0.5 * sdf / beta ** 2) * expabs)
    d_rgb = g_rgb[..., None, :] * w[..., None]
    d_depth = g_depth[..., None] * w
    d_normal = g_normal[..., None, :] * w[..., None]
    return d_sdf, d_delta, d_rgb, d_depth, d_normal, d_alpha, d_beta


# ---------------------------------------------------------------------------
# input checks (no card needed)
# ---------------------------------------------------------------------------

def check_inputs(sdf, valid, delta, rgb, depth, normal, alpha, beta):
    """Raise ValueError unless the kernels take these inputs: dtypes,
    one device, shapes, contiguity, 16-byte aligned data and 0 < K <=
    MAX_K. Returns (R, K)."""
    if sdf.dim() < 2:
        raise ValueError(f"sdf: expected [...,K], got shape {tuple(sdf.shape)}")
    lead, K = tuple(sdf.shape[:-1]), sdf.shape[-1]
    if not 0 < K <= MAX_K:
        raise ValueError(f"K={K} outside the kernels' range 1..{MAX_K}")
    dev = sdf.device
    for name, t, shape, dtype in (
            ("sdf", sdf, lead + (K,), torch.float32),
            ("valid", valid, lead + (K,), torch.bool),
            ("delta", delta, lead, torch.float32),
            ("rgb", rgb, lead + (K, 3), torch.float32),
            ("depth", depth, lead + (K,), torch.float32),
            ("normal", normal, lead + (K, 3), torch.float32)):
        if t.dtype != dtype or t.device != dev:
            raise ValueError(f"{name}: expected {dtype} on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if t.shape != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data must be 16-byte aligned")
    for name, t in (("alpha", alpha), ("beta", beta)):
        if t.dtype != torch.float32 or t.device != dev or t.numel() != 1:
            raise ValueError(f"{name}: expected one float32 on {dev}")
    return math.prod(lead), K


def ray_group(lead):
    """Rays per leading index in the kernels' cotangent addressing: ray
    r = b * group + i. The renderer's [B,HW] gives HW; any other lead is
    one flat run of rays."""
    return max(lead[1] if len(lead) == 2 else math.prod(lead), 1)


def grad_strides(lead, name, g, channels):
    """(sb, sr, sc) addressing the per-ray cotangent ``g`` [*lead(,3)]:
    channel c of ray r = b * ray_group(lead) + i sits at element b * sb +
    i * sr + c * sc. A 1- or 2-d lead may have any strides (the slices and
    broadcasts autograd hands back); a longer one must be contiguous."""
    shape = tuple(lead) + ((channels,) if channels > 1 else ())
    if g.dtype != torch.float32 or g.shape != shape:
        raise ValueError(f"{name}: expected float32 {shape}, got {g.dtype} "
                         f"{tuple(g.shape)}")
    sc = g.stride(-1) if channels > 1 else 0
    if len(lead) == 2:
        return g.stride(0), g.stride(1), sc
    if len(lead) == 1:
        return 0, g.stride(0), sc
    if not g.is_contiguous():
        raise ValueError(f"{name}: a strided cotangent needs a 1- or 2-d ray shape")
    return 0, channels, 1


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: one zeroed int per (device, stream): the backward's ticket, which the
#: kernel's last block resets, so calls on one stream can share it
_TICKETS = {}


def _lib():
    lib = kernels.load("composite")
    if not getattr(lib, "_lc_typed", False):
        lib.lc_forward.restype = _I
        lib.lc_forward.argtypes = [_P] * 8 + [_I, _I] + [_P] * 5
        lib.lc_backward.restype = _I
        lib.lc_backward.argtypes = ([_P] * 8 + [_P, _LL, _LL, _LL] * 4
                                    + [_I, _I, _I] + [_P] * 8)
        lib.lc_empty.restype = _I
        lib.lc_empty.argtypes = [_P]
        for fn in (lib.lc_max_k, lib.lc_min_rays_per_block):
            fn.restype = _I
        if (lib.lc_max_k(), lib.lc_min_rays_per_block()) != (MAX_K, MIN_RAYS_PER_BLOCK):
            raise RuntimeError("composite.cu and fused_composite.py disagree "
                               "on MAX_K / MIN_RAYS_PER_BLOCK")
        lib._lc_typed = True
    return lib


def _on_cuda(t):
    if t.device.type != "cuda":
        raise ValueError("the CUDA composite takes CUDA tensors")


def _launch(dev, fn):
    """Run ``fn(stream)`` on PyTorch's current stream of ``dev`` (its raw
    handle); enters no device context when ``dev`` is already current."""
    if dev.index == torch.cuda.current_device():
        return fn(torch._C._cuda_getCurrentRawStream(dev.index))
    with torch.cuda.device(dev):
        return fn(torch._C._cuda_getCurrentRawStream(dev.index))


def forward_cuda(sdf, valid, delta, rgb, depth, normal, alpha, beta):
    """Launch ``lc_forward``. Returns (rgb [*lead,3], depth [*lead],
    normal [*lead,3], opacity [*lead])."""
    _on_cuda(sdf)
    R, K = check_inputs(sdf, valid, delta, rgb, depth, normal, alpha, beta)
    lib = _lib()
    lead = delta.shape
    rgb_o, nrm_o = rgb.new_empty((*lead, 3)), rgb.new_empty((*lead, 3))
    dep_o, op_o = delta.new_empty(lead), delta.new_empty(lead)
    st = _launch(sdf.device, lambda stream: lib.lc_forward(
        sdf.data_ptr(), valid.data_ptr(), delta.data_ptr(), rgb.data_ptr(),
        depth.data_ptr(), normal.data_ptr(), alpha.data_ptr(), beta.data_ptr(),
        R, K, rgb_o.data_ptr(), dep_o.data_ptr(), nrm_o.data_ptr(),
        op_o.data_ptr(), stream))
    kernels.check(st, "lc_forward")
    _count("fwd", R, K)
    return rgb_o, dep_o, nrm_o, op_o


def backward_cuda(sdf, valid, delta, rgb, depth, normal, alpha, beta,
                  g_rgb, g_depth, g_normal, g_op, need_delta=True):
    """Launch ``lc_backward``. A cotangent may be None (zero) or strided
    (see ``grad_strides``). Returns (d_sdf, d_delta or None, d_rgb,
    d_depth, d_normal, d_alpha, d_beta)."""
    _on_cuda(sdf)
    check_inputs(sdf, valid, delta, rgb, depth, normal, alpha, beta)
    return _backward_launch(sdf, valid, delta, rgb, depth, normal, alpha, beta,
                            g_rgb, g_depth, g_normal, g_op, need_delta)


def _backward_launch(sdf, valid, delta, rgb, depth, normal, alpha, beta,
                     g_rgb, g_depth, g_normal, g_op, need_delta):
    """``backward_cuda`` for inputs that passed ``check_inputs`` (the
    autograd op's saved tensors, checked by its forward)."""
    lead, K = delta.shape, sdf.shape[-1]
    R = delta.numel()
    gargs = []
    for name, g, ch in (("g_rgb", g_rgb, 3), ("g_depth", g_depth, 1),
                        ("g_normal", g_normal, 3), ("g_op", g_op, 1)):
        if g is None:
            gargs += [None, 0, 0, 0]
            continue
        if g.device != sdf.device:
            raise ValueError(f"{name}: expected a tensor on {sdf.device}")
        gargs += [g.data_ptr(), *grad_strides(lead, name, g, ch)]
    lib = _lib()
    d_sdf, d_depth = sdf.new_empty(sdf.shape), depth.new_empty(depth.shape)
    d_rgb, d_nrm = rgb.new_empty(rgb.shape), normal.new_empty(normal.shape)
    d_delta = delta.new_empty(lead) if need_delta else None
    # d_alpha, d_beta, then one (d_alpha, d_beta) slot per block
    d_ab = delta.new_empty(2 + 2 * -(-R // MIN_RAYS_PER_BLOCK))

    def run(stream):
        ticket = _TICKETS.get((sdf.device.index, stream))
        if ticket is None:
            ticket = _TICKETS[sdf.device.index, stream] = torch.zeros(
                1, device=sdf.device, dtype=torch.int32)
        return lib.lc_backward(
            sdf.data_ptr(), valid.data_ptr(), delta.data_ptr(), rgb.data_ptr(),
            depth.data_ptr(), normal.data_ptr(), alpha.data_ptr(), beta.data_ptr(),
            *gargs, ray_group(lead), R, K, d_sdf.data_ptr(), d_rgb.data_ptr(),
            d_depth.data_ptr(), d_nrm.data_ptr(),
            None if d_delta is None else d_delta.data_ptr(), d_ab.data_ptr(),
            ticket.data_ptr(), stream)

    kernels.check(_launch(sdf.device, run), "lc_backward")
    _count("bwd", R, K)
    return d_sdf, d_delta, d_rgb, d_depth, d_nrm, d_ab[0], d_ab[1]


def empty_cuda():
    """Launch an empty kernel through the same ctypes path: the floor a
    launch of this library costs (timed by ``chip_smoke.py``)."""
    lib = _lib()
    kernels.check(_launch(torch.device("cuda", torch.cuda.current_device()),
                          lib.lc_empty), "lc_empty")


# ---------------------------------------------------------------------------
# autograd op
# ---------------------------------------------------------------------------

class LaplaceComposite(torch.autograd.Function):
    """Fused composite; the kernels for CUDA tensors, the plain versions
    for CPU tensors. ``valid`` gets no gradient; ``delta``'s per-ray
    gradient is written only when autograd needs it."""

    @staticmethod
    def forward(ctx, sdf, valid, delta, rgb, depth, normal, alpha, beta):
        ctx.save_for_backward(sdf, valid, delta, rgb, depth, normal, alpha, beta)
        ctx.set_materialize_grads(False)    # unused outputs: no zero fills
        if sdf.is_cuda:
            return forward_cuda(sdf, valid, delta, rgb, depth, normal, alpha, beta)
        return _forward_ref(sdf, valid, delta, rgb, depth, normal, alpha, beta)

    @staticmethod
    def backward(ctx, g_rgb, g_depth, g_normal, g_op):
        res = ctx.saved_tensors
        alpha, beta = res[6], res[7]
        need_delta = ctx.needs_input_grad[2]
        if res[0].is_cuda:
            d = _backward_launch(*res, g_rgb, g_depth, g_normal, g_op, need_delta)
        else:
            d = _backward_ref(res, (g_rgb, g_depth, g_normal, g_op))
        d_sdf, d_delta, d_rgb, d_depth, d_normal, d_a, d_b = d
        return (d_sdf, None, d_delta if need_delta else None, d_rgb, d_depth,
                d_normal, d_a.reshape(alpha.shape), d_b.reshape(beta.shape))


def laplace_composite(sdf, valid, delta, rgb, depth, normal, alpha, beta):
    """Fused Laplace-sigma + composite. See the module docstring."""
    return LaplaceComposite.apply(sdf, valid, delta, rgb, depth, normal,
                                  alpha, beta)


def composite_fused(ray, rgb_samples, sdf_samples, valid, bin_w,
                    depth_samples, normals, alpha, beta):
    """The renderer's tensors as they are: ray [B,HW,3]; rgb_samples and
    normals [B,HW,K,3]; sdf_samples and depth_samples [B,HW,K]; valid
    [B,HW,K] bool; bin_w [B,HW], the uniform bin width, so that a ray's
    delta is bin_w * |ray|; alpha, beta one-element tensors.

    Returns (rgb [B,HW,3], depth [B,HW,1], normal [B,HW,3],
    opacity [B,HW,1]) with no copy. Background/last-sample blending stays
    with the caller.
    """
    delta = torch.linalg.norm(ray, dim=-1) * bin_w
    rgb, depth, normal, opacity = laplace_composite(
        sdf_samples, valid, delta, rgb_samples, depth_samples, normals,
        alpha, beta)
    return rgb, depth[..., None], normal, opacity[..., None]
