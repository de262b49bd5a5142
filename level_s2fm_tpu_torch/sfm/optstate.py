"""Most recent phase optimizer state: carried by checkpoints and resumes.

Counterpart of ``level_s2fm_tpu/sfm/optstate.py``. After every completed
phase its ``PhaseAdam`` is recorded in one most-recent slot (a reference
to its device tensors; nothing is copied to the host); ``snapshot``
copies it out when a checkpoint is written; ``load`` fills the slot from
a checkpoint and arms a one-shot adoption: the first phase with the same
label then starts from the saved moments and step count instead of
zeros. Any mismatch (a leaf's count, shape or dtype) leaves the fresh
state as it is and disarms, as in the JAX package.

One deliberate difference: the checkpoint's state is kept apart from the
most-recent slot until it is adopted. In the JAX package a phase of
another label that runs first (a resumed registration starts with
geoinit) records over the loaded state, and the later phase of the saved
label then adopts moments recorded in this process instead of the saved
ones; here it adopts the saved ones, as both modules' documentation says.

The saved leaves are the flat leaves of the JAX package's
``optax.multi_transform`` state over ``adam_stacked`` chains, so a
checkpoint moves between the two packages either way: labels in sorted
order; per label an int32 step count, one ``[2, *leaf.shape]`` array
(mu; nu) per leaf of that label in parameter order, then the schedule's
int32 count; the ``frozen`` label gives no leaves.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .optim import PhaseAdam

_slot = {"label": None, "state": None}
#: the checkpoint's (label, host leaves), until adopted
_loaded = {"label": None, "leaves": None}
_armed = [False]
#: (label, leaf count) of every adoption in this process, for the logs
ADOPTED: List[Tuple[str, int]] = []


def _layout(opt: PhaseAdam):
    """[(kind, label, leaf index)] of the flat JAX layout: kind 'count'
    for a step count, 'moments' for a leaf's stacked (mu; nu)."""
    out = []
    for lab in sorted(set(opt.labels)):
        out.append(("count", lab, None))
        out.extend(("moments", lab, i) for i, l in enumerate(opt.labels)
                   if l == lab)
        out.append(("count", lab, None))
    return out


def flat_state(opt: PhaseAdam) -> List[torch.Tensor]:
    """The optimizer state as the JAX layout's flat leaves (on device)."""
    count = torch.tensor(opt.count, dtype=torch.int32)
    return [count if kind == "count"
            else torch.stack([opt.mu[i], opt.nu[i]])
            for kind, _, i in _layout(opt)]


def record(label: str, opt: PhaseAdam) -> None:
    """Remember a completed phase's optimizer (its device tensors)."""
    _slot["label"] = label
    _slot["state"] = opt


def snapshot() -> Optional[Tuple[str, List[np.ndarray]]]:
    """(label, host leaves) of the most recent phase, for checkpointing."""
    state = _slot["state"]
    if state is None:
        return None
    leaves = flat_state(state) if isinstance(state, PhaseAdam) else state
    return _slot["label"], [np.asarray(x.detach().cpu().numpy()
                                       if torch.is_tensor(x) else x)
                            for x in leaves]


def load(label: str, leaves: List[np.ndarray]) -> None:
    """Fill the slot from a checkpoint and arm one-shot adoption."""
    leaves = [np.asarray(x) for x in leaves]
    _slot["label"], _slot["state"] = label, leaves
    _loaded["label"], _loaded["leaves"] = label, leaves
    _armed[0] = True


def reset() -> None:
    _slot["label"] = _slot["state"] = None
    _loaded["label"] = _loaded["leaves"] = None
    _armed[0] = False


def adopt(label: str, opt: PhaseAdam) -> PhaseAdam:
    """Give ``opt`` (a fresh optimizer) the saved moments and step count
    if adoption is armed for ``label`` and every saved leaf matches the
    layout of ``opt`` in count, shape and dtype; otherwise leave it
    fresh. One-shot: the first adoption (or mismatch) disarms. Returns
    ``opt``."""
    if not _armed[0] or _loaded["label"] != label:
        return opt
    _armed[0] = False
    saved = _loaded["leaves"]
    layout = _layout(opt)
    if len(saved) != len(layout):
        return opt
    counts = set()
    for s, (kind, _, i) in zip(saved, layout):
        s = np.asarray(s)
        if kind == "count":
            if s.shape != () or s.dtype != np.int32:
                return opt
            counts.add(int(s))
        else:
            leaf = opt.leaves[i]
            if (s.shape != (2, *leaf.shape)
                    or s.dtype != np.dtype(str(leaf.dtype).split(".")[-1])):
                return opt
    if len(counts) > 1:     # one step count for every label in the port
        return opt
    with torch.no_grad():
        for s, (kind, _, i) in zip(saved, layout):
            if kind == "moments":
                st = torch.as_tensor(np.asarray(s)).to(opt.mu[i].device)
                opt.mu[i].copy_(st[0])
                opt.nu[i].copy_(st[1])
    opt.count = counts.pop() if counts else 0
    ADOPTED.append((label, len(saved)))
    print(f"[optstate] adopted the saved optimizer state of {label!r} "
          f"({len(saved)} leaves, step {opt.count})")
    return opt
