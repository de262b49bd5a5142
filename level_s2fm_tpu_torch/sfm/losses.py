"""Shared loss utilities for the optimization phases.

Counterpart of ``level_s2fm_tpu/sfm/losses.py``: weights are log10
(total = sum 10**w_k * loss_k; ``None`` disables a term), and masked
means use sum/count so padded batches keep static shapes.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch


def l1(x, y=None):
    if y is None:
        return torch.mean(torch.abs(x))
    return torch.mean(torch.abs(x - y))


def masked_mean(x, mask, eps=1e-8):
    mask = mask.to(x.dtype)
    return torch.sum(x * mask) / (torch.sum(mask) + eps)


def safe_norm(x, dim=-1, eps=1e-12, keepdim=False):
    """L2 norm with a finite gradient at the origin: sqrt(sum(x^2) + eps)
    (``torch.linalg.norm``'s gradient is NaN at exactly 0, and a zero
    cotangent does not save it: 0 * NaN = NaN)."""
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim) + eps)


def smooth_l1(x, y):
    """Huber with beta=1 (torch smooth_l1_loss default), elementwise."""
    d = torch.abs(x - y)
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def psnr(rgb, rgb_gt, mask=None):
    if mask is None:
        mse = torch.mean((rgb - rgb_gt) ** 2)
    else:
        mse = masked_mean(torch.mean((rgb - rgb_gt) ** 2, dim=-1), mask)
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
