"""The fields' initial parameters, made on the device from the seed.

The port's geometric init (``level_s2fm_tpu_torch/fields/mlp.py``): the
hash table uniform in (-1e-4, 1e-4); the geometry MLP's first layer zero
except its three point columns ~ N(0, sqrt(2/width)), hidden layers ~
N(0, sqrt(2/width)), the last layer ~ N(sqrt(pi/fan_in), 1e-4) with the
bias -sphere_bias, so that the SDF starts as a sphere of that radius; the
radiance MLP uniform in +-1/sqrt(fan_in); every layer weight-normalised
(V, g = |V| by row, b); beta = log(beta_init) / beta_speed. One
``torch.Generator`` on the device, a few calls, float32 throughout.
"""
from __future__ import annotations

import math

import torch


def _layer(W, b):
    return {"V": W, "g": torch.linalg.norm(W, dim=1, keepdim=True), "b": b}


def make(opt, seed: int, device) -> dict:
    """{"sdf": {"table", "mlp", "beta"}, "rad": {"rad_mlp"}} in the port's
    layout, from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = {"generator": gen, "device": device, "dtype": torch.float32}
    hc, sdf = opt["SDF"]["Hash_config"], opt["SDF"]
    L, F = hc["n_levels"], hc["n_features_per_level"]
    table = torch.rand((L, 1 << hc["log2_hashmap_size"], F), **kw) * 2e-4 - 1e-4

    in_dim = L * F + 3
    dims = list(zip(sdf["arch"]["layers"][:-1], sdf["arch"]["layers"][1:]))
    bias = float(sdf["NN_Init"]["bias"])
    geo = []
    for i, (k_in, k_out) in enumerate(dims):
        k_in = in_dim if i == 0 else k_in
        last = i == len(dims) - 1
        k_out = k_out + 1 if last else k_out
        if last:
            W = torch.randn((k_out, k_in), **kw) * 1e-4 + math.sqrt(math.pi) / math.sqrt(dims[i][0])
            b = torch.full((k_out,), -bias, device=device)
        elif i == 0:
            W = torch.zeros((k_out, k_in), device=device)
            W[:, :3] = torch.randn((k_out, 3), **kw) * (math.sqrt(2) / math.sqrt(k_out))
            b = torch.zeros((k_out,), device=device)
        else:
            W = torch.randn((k_out, k_in), **kw) * (math.sqrt(2) / math.sqrt(k_out))
            b = torch.zeros((k_out,), device=device)
        geo.append(_layer(W, b))

    feat = sdf["arch"]["layers"][-1]
    rad_in = 3 + 27 + 3 + feat          # point, Fourier view (4 bands), normal, feature
    rad = []
    for i, (k_in, k_out) in enumerate(zip(opt["RadF"]["arch"]["layers"][:-1],
                                          opt["RadF"]["arch"]["layers"][1:])):
        k_in = rad_in if i == 0 else k_in
        bound = 1.0 / math.sqrt(k_in)
        W = torch.rand((k_out, k_in), **kw) * (2 * bound) - bound
        b = torch.rand((k_out,), **kw) * (2 * bound) - bound
        rad.append(_layer(W, b))

    vs = sdf["VolSDF"]
    beta = torch.tensor([math.log(float(vs["beta_init"])) / float(vs["beta_speed"])],
                        dtype=torch.float32, device=device)
    return {"sdf": {"table": table, "mlp": {"layers": geo}, "beta": beta},
            "rad": {"rad_mlp": {"layers": rad}}}


def clone(tree, device=None):
    """A detached copy of a parameter tree (on ``device``, if given)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device, copy=True) if device else tree.detach().clone()
    if isinstance(tree, dict):
        return {k: clone(v, device) for k, v in tree.items()}
    return [clone(v, device) for v in tree]
