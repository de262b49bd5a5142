"""Per-phase optimizer: Adam per label with a shared exponential decay.

Counterpart of ``level_s2fm_tpu/sfm/optim.py``. The reference builds one
torch Adam with per-group learning rates and a single ExponentialLR whose
gamma = (lr_end/lr)**(1/max_iter) multiplies every group each iteration;
the JAX package implements that with one Adam per label on schedule
base_lr * gamma**t. This is the same math (``adam_stacked``'s, without
its stacked-moment layout, which only worked around a TPU compiler
limit), written as tensor code so that ``phases.guarded_update`` can skip
a step and sanitize the moments exactly as the JAX package does.
"""
from __future__ import annotations

from typing import Dict, List

import torch


def tree_leaves(tree) -> List[torch.Tensor]:
    """Tensors of a nested dict/list tree, in sorted-key order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    raise TypeError(f"unexpected leaf type {type(tree)}")


def decay_gamma(lr: float, lr_end: float, max_iter: int) -> float:
    return (lr_end / lr) ** (1.0 / max_iter)


#: the label whose leaves get no update (the JAX package's
#: ``optax.set_to_zero``)
FROZEN = "frozen"


class PhaseAdam:
    """Adam over the leaves of ``params`` (a dict of sub-trees), each
    top-level key mapped to a label with its base lr; the lr at step t
    (0-based) is base_lr * gamma**t. Leaves labelled ``frozen`` are left
    out: they get no moments, no gradient and no update, so they stay
    bit for bit as they were."""

    def __init__(self, params: Dict, label_of_key: Dict[str, str],
                 label_lrs: Dict[str, float], gamma: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.leaves: List[torch.Tensor] = []
        self.labels: List[str] = []
        self.lrs: List = []
        for k in sorted(params):
            if label_of_key[k] == FROZEN:
                continue
            for leaf in tree_leaves(params[k]):
                self.leaves.append(leaf)
                self.labels.append(label_of_key[k])
                self.lrs.append(label_lrs[label_of_key[k]])
        self.gamma, self.b1, self.b2, self.eps = gamma, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.leaves]
        self.nu = [torch.zeros_like(p) for p in self.leaves]
        self.count = 0

    @torch.no_grad()
    def updates(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Advance the moments and the step count; return the updates."""
        t = self.count
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        out = []
        for mu, nu, g, lr in zip(self.mu, self.nu, grads, self.lrs):
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
            step = -lr * self.gamma ** t
            out.append(step * (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps))
        return out

    @torch.no_grad()
    def sanitize(self):
        """Reset non-finite moment entries to 0 (a local restart)."""
        for m in self.mu + self.nu:
            torch.nan_to_num_(m, nan=0.0, posinf=0.0, neginf=0.0)
