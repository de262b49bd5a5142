"""Geometry and radiance MLPs (plain dicts of tensors) with SAL-style
geometric init.

Counterpart of ``level_s2fm_tpu/fields/mlp.py``. Layers are
weight-normalized: W = g * V / ||V||_row, g initialised to ||V||_row.
Parameters are ``{"layers": [{"V", "g", "b"}, ...]}``, the JAX pytree's
layout, so weights move between the two packages as arrays.

Reference quirks kept:
  * geometry MLP: softplus(beta=100) on all but the last layer;
  * geometric init: last layer ~ N(sqrt(pi)/sqrt(fan_in), 1e-4) with
    bias -sphere_bias; the first layer's hash-feature columns start at 0;
  * radiance MLP: the reference's inner ReLU is dead code, so hidden
    layers have NO activation by default (``activation='relu'`` opts in).

``geometry_mlp_with_input_grad`` returns the geometry feature together
with d(feature[0])/d(input), written out as tensor ops (the chain of
weight matrices and softplus derivatives), so the SDF normal is one
forward pass that an outer loss can differentiate again.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def get_layer_dims(layers: Sequence[Optional[int]]):
    """[null,64,16] -> [(null,64),(64,16)]."""
    return list(zip(layers[:-1], layers[1:]))


def _weight_norm_params(W: torch.Tensor, b: torch.Tensor):
    g = torch.linalg.norm(W, dim=1, keepdim=True)
    return {"V": W, "g": g, "b": b}


def _weight(p):
    return p["g"] * p["V"] / torch.linalg.norm(p["V"], dim=1, keepdim=True)


def _apply_weight_norm_layer(p, x):
    return x @ _weight(p).T + p["b"]


def _normal(gen, mean, std, size):
    return torch.randn(size, generator=gen, dtype=torch.float64) * std + mean


def _uniform(gen, lo, hi, size):
    return torch.rand(size, generator=gen, dtype=torch.float64) * (hi - lo) + lo


def init_geometry_mlp(gen: torch.Generator, input_dim: int,
                      layers: Sequence[Optional[int]], skip: Sequence[int] = (),
                      sphere_bias: float = 1.0, tf_init: bool = True,
                      device=None):
    """Init the SDF MLP. layers like [null,64,16]; the last layer gets one
    more output, the sdf channel in front of the feature vector."""
    dims = get_layer_dims(layers)
    params = []
    for li, (k_in, k_out) in enumerate(dims):
        if li == 0:
            k_in = input_dim
        if li in skip:
            k_in += input_dim
        if li == len(dims) - 1:
            k_out += 1
        if tf_init:
            if li == len(dims) - 1:
                W = _normal(gen, math.sqrt(math.pi) / math.sqrt(dims[li][0]),
                            1e-4, (k_out, k_in))
                b = torch.full((k_out,), -sphere_bias, dtype=torch.float64)
            elif li == 0:
                W = torch.zeros((k_out, k_in), dtype=torch.float64)
                W[:, :3] = _normal(gen, 0.0, math.sqrt(2) / math.sqrt(k_out),
                                   (k_out, 3))
                b = torch.zeros((k_out,), dtype=torch.float64)
            else:
                W = _normal(gen, 0.0, math.sqrt(2) / math.sqrt(k_out),
                            (k_out, k_in))
                if li in skip:
                    W[:, -(input_dim - 3):] = 0.0
                b = torch.zeros((k_out,), dtype=torch.float64)
        else:
            bound = 1.0 / math.sqrt(k_in)
            W = _uniform(gen, -bound, bound, (k_out, k_in))
            b = _uniform(gen, -bound, bound, (k_out,))
        params.append(_weight_norm_params(W.float().to(device),
                                          b.float().to(device)))
    return {"layers": params}


def _softplus100(z):
    return F.softplus(z, beta=100.0)


def apply_geometry_mlp(params, points_enc: torch.Tensor,
                       skip: Sequence[int] = ()) -> torch.Tensor:
    """Softplus(beta=100) hidden activations."""
    feat = points_enc
    n = len(params["layers"])
    for li, p in enumerate(params["layers"]):
        if li in skip:
            feat = torch.cat([feat, points_enc], dim=-1) / math.sqrt(2.0)
        feat = _apply_weight_norm_layer(p, feat)
        if li <= n - 2:
            feat = _softplus100(feat)
    return feat


def geometry_mlp_with_input_grad(params, points_enc: torch.Tensor,
                                 skip: Sequence[int] = ()):
    """(feat [...,out], d feat[...,0] / d points_enc [...,in])."""
    feat = points_enc
    n = len(params["layers"])
    Ws, zs, in_dims = [], [], []
    for li, p in enumerate(params["layers"]):
        if li in skip:
            feat = torch.cat([feat, points_enc], dim=-1) / math.sqrt(2.0)
        in_dims.append(feat.shape[-1])
        W = _weight(p)
        z = feat @ W.T + p["b"]
        Ws.append(W)
        zs.append(z)
        feat = _softplus100(z) if li <= n - 2 else z
    D = points_enc.shape[-1]
    g = Ws[-1][0].expand(*points_enc.shape[:-1], in_dims[-1])
    g_enc = torch.zeros_like(points_enc)
    for li in range(n - 1, -1, -1):
        if li < n - 1:
            g = (g * torch.sigmoid(100.0 * zs[li])) @ Ws[li]
        if li in skip:
            prev = in_dims[li] - D
            g_enc = g_enc + g[..., prev:] / math.sqrt(2.0)
            g = g[..., :prev] / math.sqrt(2.0)
    return feat, g + g_enc


def init_radiance_mlp(gen: torch.Generator, input_dim: int,
                      layers: Sequence[Optional[int]], device=None):
    """Init the radiance decoder MLP (uniform +-1/sqrt(fan_in))."""
    params = []
    for li, (k_in, k_out) in enumerate(get_layer_dims(layers)):
        if li == 0:
            k_in = input_dim
        bound = 1.0 / math.sqrt(k_in)
        W = _uniform(gen, -bound, bound, (k_out, k_in)).float()
        b = _uniform(gen, -bound, bound, (k_out,)).float()
        params.append(_weight_norm_params(W.to(device), b.to(device)))
    return {"layers": params}


def apply_radiance_mlp(params, x: torch.Tensor,
                       activation: str = "none") -> torch.Tensor:
    feat = x
    n = len(params["layers"])
    for li, p in enumerate(params["layers"]):
        feat = _apply_weight_norm_layer(p, feat)
        if activation == "relu" and li <= n - 2:
            feat = torch.relu(feat)
    return torch.sigmoid(feat)
