"""Ordered scatter-add: row sums in a fixed order, on the CPU and the card.

The hash grid's table cotangent is a scatter-add of the gathered rows'
cotangents into the [L*T, F] table. ``index_add_`` computes it; on the
CPU it adds each row's contributions one after another in ascending
contribution index, but on the card it uses float atomics, whose order
changes from run to run, so card runs of the port did not repeat. The
JAX package's runs do.

``ordered_scatter_add(gi, g, m)`` computes the same sum in the CPU's
order everywhere: for a CPU tensor it runs the plain version
(``index_add_``); for a CUDA tensor it launches ``hs_ordered_scatter``
(``csrc/hash_scatter.cu``: a stable radix sort of the keys' own bits,
written by hand, then a segment sum that adds each row in index order),
or raises. There is no fallback. The kernels replace no TPU kernel: the
JAX package scatters in XLA. Keys outside [0, m) touch no row.

``gather_rows`` (a row gather whose backward is the ordered scatter, and
the scatter's backward the gather, so graphs built with
``create_graph=True`` differentiate again) and ``take_along_last`` (the
same for ``torch.take_along_dim`` on the last axis, whose own backward is
an atomic ``scatter_add`` on the card) are the differentiable entries.

``LAUNCHES`` counts kernel launches and ``SHAPES`` counts them by
(contributions, rows, features).
"""
from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..utils import obs

#: kernel launches since the last reset; incremented only where the
#: kernel is launched
LAUNCHES = {"scatter": 0}
#: the same launches by shape: {(n, m, F): count}
SHAPES = {}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_INT32_MAX = 2 ** 31 - 1


def reset_launches():
    LAUNCHES["scatter"] = 0
    SHAPES.clear()


def scatter_plain(gi, g, m: int):
    """The plain version: ``zeros([m, F]).index_add_(0, gi, g)``. On the
    CPU it adds in ascending contribution index; on the card it is the
    atomic scatter the kernel replaces (timed beside it)."""
    d = torch.zeros((m, g.shape[-1]), dtype=g.dtype, device=g.device)
    return d.index_add_(0, gi, g)


def _lib():
    lib = kernels.load("hash_scatter")
    if not getattr(lib, "_hs_typed", False):
        lib.hs_ordered_scatter.restype = _I
        lib.hs_ordered_scatter.argtypes = [_P, _P, _LL, _I, _I, _P, _P, _P]
        lib.hs_scratch_words.restype = _LL
        lib.hs_scratch_words.argtypes = [_LL, _I]
        lib.hs_sort_tile.restype = _I
        lib.hs_sort_tile.argtypes = []
        lib.hs_supports_features.restype = _I
        lib.hs_supports_features.argtypes = [_I]
        lib._hs_typed = True
    return lib


def check_inputs(gi, g, m: int):
    """Shapes, types and sizes the kernel takes; returns (n, F)."""
    if gi.dtype != torch.int64 or gi.dim() != 1:
        raise ValueError(f"gi: expected a 1-D int64 tensor, got {gi.dtype} {tuple(gi.shape)}")
    if g.dim() != 2 or g.shape[0] != gi.shape[0]:
        raise ValueError(f"g: expected [{gi.shape[0]}, F], got {tuple(g.shape)}")
    if g.device != gi.device:
        raise ValueError(f"gi on {gi.device}, g on {g.device}")
    n, F = g.shape
    if not 0 <= m <= _INT32_MAX or n > _INT32_MAX:
        raise ValueError(f"the kernel takes fewer than 2^31 rows and contributions "
                         f"(rows {m}, contributions {n})")
    return n, F


def sort_tile():
    """Keys a block of a sort pass takes (the built kernel's tile)."""
    return int(_lib().hs_sort_tile())


def scatter_cuda(gi, g, m: int):
    """The ordered sum [m, F] of CUDA tensors: one call of
    ``hs_ordered_scatter`` (the state's memset, the digit histogram, one
    launch per sort pass, the segment sum), with its scratch from
    ``torch.empty``."""
    if gi.device.type != "cuda":
        raise ValueError("the CUDA scatter takes CUDA tensors")
    n, F = check_inputs(gi, g, m)
    if g.dtype != torch.float32:
        raise ValueError(f"the CUDA scatter takes float32 cotangents, got {g.dtype}")
    lib = _lib()
    if not lib.hs_supports_features(F):
        raise ValueError(f"the CUDA scatter takes 1, 2, 4 or 8 features a row, got {F}")
    gi, g = gi.contiguous(), g.contiguous()
    dev = g.device
    out = torch.empty((m, F), dtype=g.dtype, device=dev)
    scratch = torch.empty(lib.hs_scratch_words(n, m), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch._C._cuda_getCurrentRawStream(dev.index)
        st = lib.hs_ordered_scatter(gi.data_ptr(), g.data_ptr(), n, F, m, out.data_ptr(),
                                    scratch.data_ptr(), stream)
    kernels.check(st, "hs_ordered_scatter")
    LAUNCHES["scatter"] += 1
    SHAPES[n, m, F] = SHAPES.get((n, m, F), 0) + 1
    return out


def ordered_scatter_add(gi, g, m: int):
    """``zeros([m, F]).index_add_(0, gi, g)`` with each row summed in
    ascending contribution index: the plain version for CPU tensors, the
    kernel for CUDA tensors (or an error). Not differentiable itself;
    see ``OrderedScatter``."""
    if g.is_cuda:
        return scatter_cuda(gi, g, m)
    check_inputs(gi, g, m)
    return scatter_plain(gi, g, m)


class OrderedScatter(torch.autograd.Function):
    """``ordered_scatter_add`` with the row gather as its backward."""

    @staticmethod
    def forward(ctx, g, gi, m: int):
        ctx.save_for_backward(gi)
        return ordered_scatter_add(gi, g, m)

    @staticmethod
    def backward(ctx, gd):
        (gi,) = ctx.saved_tensors
        return RowGather.apply(gd, gi, False), None, None


class RowGather(torch.autograd.Function):
    """Row gather ``flat[gi]`` from a [M, F] tensor whose backward is the
    ordered scatter. With ``bf16`` the gathered values are rounded to
    bf16 and the cotangent is accumulated in f32 unrounded (a plain
    ``flat.to(bfloat16)[gi]`` would round it, which the JAX package
    measured to drive init training to NaN)."""

    @staticmethod
    def forward(ctx, flat, gi, bf16: bool):
        ctx.save_for_backward(gi)
        ctx.m = flat.shape[0]
        out = flat[gi]
        if bf16:
            out = out.to(torch.bfloat16).to(flat.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        (gi,) = ctx.saved_tensors
        with obs.span("hash_scatter.cotangent"):
            return OrderedScatter.apply(g, gi, ctx.m), None, None


def gather_rows(flat, gi, bf16: bool = False):
    """``flat[gi]`` for a [M, F] tensor and 1-D int64 ``gi``; its
    gradient is summed by ``ordered_scatter_add``."""
    return RowGather.apply(flat, gi, bf16)


def take_along_last(src, idx):
    """``torch.take_along_dim(src, idx, dim=-1)`` for ``src`` [..., S] and
    ``idx`` [..., K] with the same leading shape, whose gradient is
    summed by ``ordered_scatter_add`` (equal on the CPU to
    ``take_along_dim``'s; ordered on the card)."""
    lead, S = src.shape[:-1], src.shape[-1]
    if idx.shape[:-1] != lead:
        raise ValueError(f"src {tuple(src.shape)} and idx {tuple(idx.shape)} "
                         "differ in their leading shape")
    K = idx.shape[-1]
    rows = torch.arange(idx.numel() // max(K, 1), device=idx.device)[:, None] * S
    flat_idx = (idx.reshape(-1, K) + rows).reshape(-1)
    out = gather_rows(src.reshape(-1, 1), flat_idx)
    return out.reshape(idx.shape)
