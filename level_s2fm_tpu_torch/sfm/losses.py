"""Shared loss utilities for the optimization phases.

Counterpart of ``level_s2fm_tpu/sfm/losses.py``: weights are log10
(total = sum 10**w_k * loss_k; ``None`` disables a term), and masked
means use sum/count so padded batches keep static shapes.

Under an active data group (``parallel``), a term over rows that are
sharded over the ranks is asked for with ``sharded=True``: it is this
rank's sum over the GLOBAL count (all-reduced, detached), so that the
terms of all ranks add up to the global mean and so do their gradients;
masked-out rows enter neither sum (a ``where``, not a product, so that
nothing of theirs reaches the value) nor count. ``global_value`` turns
such a part into the global value where a decision or a nonlinear
metric needs it; ``replicated`` makes a term that every rank computes in
full count once. With no active group all of these are the plain forms.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..parallel import distributed as pdist
from ..parallel import mesh as pmesh


def l1(x, y=None):
    if y is None:
        return torch.mean(torch.abs(x))
    return torch.mean(torch.abs(x - y))


def count(mask, sharded=False):
    """The number of True entries of a bool mask, as a float tensor; the
    global number when ``sharded`` under an active group."""
    n = torch.sum(mask.to(torch.float32))
    if sharded and pmesh.get_group() is not None:
        n = pdist.global_sum([n])[0]
    return n


def masked_mean(x, mask, eps=1e-8, sharded=False):
    if sharded and pmesh.get_group() is not None:
        mask = mask.to(torch.bool)
        return (torch.sum(torch.where(mask, x, torch.zeros_like(x)))
                / (count(mask, sharded=True).to(x.dtype) + eps))
    mask = mask.to(x.dtype)
    return torch.sum(x * mask) / (torch.sum(mask) + eps)


def global_value(part):
    """The global value of a sharded term (the sum of the ranks' parts),
    detached. No active group: the part, detached."""
    return pdist.global_sum([part])[0]


def replicated(term):
    """A term that every rank computes in full from the same rows: it
    counts once in the sum over the ranks (rank 0's; the others give 0
    and no gradient)."""
    g = pmesh.get_group()
    if g is None or g.rank == 0:
        return term
    return torch.zeros_like(term).detach()


def safe_norm(x, dim=-1, eps=1e-12, keepdim=False):
    """L2 norm with a finite gradient at the origin: sqrt(sum(x^2) + eps)
    (``torch.linalg.norm``'s gradient is NaN at exactly 0, and a zero
    cotangent does not save it: 0 * NaN = NaN)."""
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim) + eps)


def smooth_l1(x, y):
    """Huber with beta=1 (torch smooth_l1_loss default), elementwise."""
    d = torch.abs(x - y)
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def psnr(rgb, rgb_gt, mask=None, sharded=False):
    """PSNR of the masked mean squared error; of the global one when
    ``sharded`` (a metric: detached there)."""
    if mask is None:
        mse = torch.mean((rgb - rgb_gt) ** 2)
    else:
        mse = masked_mean(torch.mean((rgb - rgb_gt) ** 2, dim=-1), mask,
                          sharded=sharded)
        if sharded and pmesh.get_group() is not None:
            mse = global_value(mse)
    return -10.0 * torch.log10(mse + 1e-12)


def weighted_total(loss: Dict[str, torch.Tensor],
                   weights: Dict[str, Optional[float]]):
    """total = sum 10**w_k * loss_k over keys with non-None weights."""
    total = 0.0
    for k, v in loss.items():
        w = weights.get(k, None)
        if w is None:
            continue
        total = total + 10.0 ** w * v
    return total
