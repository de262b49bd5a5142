"""Move field parameters between the JAX package and the port as arrays.

The port keeps the JAX pytree's layout as nested dicts of tensors:

    {"sdf": {"table": [L,T,F], "mlp": {"layers": [{"V", "g", "b"}, ...]},
             "beta": [1]},
     "rad": {"rad_mlp": {"layers": [{"V", "g", "b"}, ...]}}}

``params_from_jax`` takes that tree with numpy arrays at the leaves (e.g.
``jax.tree.map(np.asarray, params)`` on the JAX side) and returns float32
tensors on ``device`` (``cuda`` unless the caller passes another);
``params_to_jax`` is the reverse, for the later checkpoint cross-restore.
Neither imports jax.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def params_from_jax(np_tree, device=None):
    """numpy pytree -> dict of float32 tensors (copies) on ``device``."""
    device = resolve_device(device)
    return _map(np_tree, lambda a: torch.tensor(np.array(a, np.float32),
                                                device=device))


def params_to_jax(params):
    """dict of tensors -> numpy pytree (float32 copies on the host)."""
    return _map(params, lambda t: t.detach().cpu().numpy().astype(np.float32))
