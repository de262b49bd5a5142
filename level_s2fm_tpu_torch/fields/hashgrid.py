"""Multiresolution hash-grid encoding (instant-NGP style) in PyTorch.

Counterpart of ``level_s2fm_tpu/fields/hashgrid.py``. Plain tensor ops: the 8-corner gather from
the [L,T,F] table, trilinear interpolation, and the analytic spatial
Jacobian from the same gathered corners. The table cotangent is summed
by ``hash_scatter.ordered_scatter_add``: on the card a hand kernel
(``csrc/hash_scatter.cu``) adds each row's contributions in the CPU's
order, so card runs repeat without deterministic mode. The gather and
the rest of the backward are hand kernels of a later slice (ROADMAP
H1/H2).

Hash indices are uint32 arithmetic in the JAX package
(``x*1 ^ y*2654435761 ^ z*805459861 mod T``); torch has no general
uint32, so products are taken in int64 and masked with ``& 0xFFFFFFFF``.

``compute_dtype="bfloat16"`` rounds the gathered table rows to bf16 (the
JAX package's half-width reads) while the table cotangent stays f32
(``hash_scatter.RowGather``): a plain ``table.to(bfloat16)[idx]`` would
round the cotangent to bf16, which the JAX package measured to drive
init training to NaN.

``paired_dense`` (the JAX package's two-row gather of x-adjacent corners
on the dense levels) changed only the fetch shape, because a TPU gather
costs per row; its values, spatial Jacobian (zero where a position is
clamped to the grid edge), table gradient and double backward are the
default path's. The key is accepted and the default gather runs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import hash_scatter
from ..utils import obs

# tcnn-compatible hashing primes (public constants of the NGP paper)
_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    n_levels: int = 16
    n_features_per_level: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = 1.38
    include_input: bool = True
    compute_dtype: str = "float32"
    # accepted for the JAX package's configs; the same math runs either way
    paired_dense: bool = False

    @property
    def table_size(self) -> int:
        return 1 << self.log2_hashmap_size

    @property
    def out_dim(self) -> int:
        d = self.n_levels * self.n_features_per_level
        if self.include_input:
            d += 3
        return d

    def resolutions(self) -> np.ndarray:
        ls = np.arange(self.n_levels)
        return np.floor(self.base_resolution * self.per_level_scale ** ls).astype(np.int32)


def config_from_opt(opt, bound_extent: Optional[float] = None) -> HashGridConfig:
    """Per-level scale b = exp(ln(2048*scale/N_min)/(L-1)) with scale =
    half the bound extent."""
    hc = opt.SDF.Hash_config
    L = hc.get("n_levels", 16)
    F = hc.get("n_features_per_level", 2)
    log2_T = hc.get("log2_hashmap_size", 19)
    N_min = hc.get("base_resolution", 16)
    if bound_extent is None:
        bound_extent = float(opt.data.bound_max[0] - opt.data.bound_min[0])
    scale = bound_extent / 2
    b = float(np.exp(np.log(2048 * scale / N_min) / (L - 1)))
    return HashGridConfig(n_levels=L, n_features_per_level=F,
                          log2_hashmap_size=log2_T, base_resolution=N_min,
                          per_level_scale=b,
                          compute_dtype=str(hc.get("compute_dtype", "float32")),
                          paired_dense=bool(hc.get("paired_dense", False)))


def init_table(cfg: HashGridConfig, generator: torch.Generator,
               device=None) -> torch.Tensor:
    """[L, T, F] feature table; uniform(-1e-4, 1e-4) like tcnn's default."""
    shape = (cfg.n_levels, cfg.table_size, cfg.n_features_per_level)
    t = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (t * 2e-4 - 1e-4).to(device)


def _level_indices(grid_int: torch.Tensor, res: torch.Tensor,
                   dense_fits: torch.Tensor, table_size: int) -> torch.Tensor:
    """Map integer corner coords [..., 3] (int64, per level) to table
    indices: dense row-major indexing where the level's grid fits in the
    table, the xor-prime spatial hash otherwise."""
    res1 = res + 1
    x, y, z = grid_int[..., 0], grid_int[..., 1], grid_int[..., 2]
    dense_idx = (x + res1 * (y + res1 * z)) & _U32
    hashed = (((x * _PRIMES[0]) & _U32) ^ ((y * _PRIMES[1]) & _U32)
              ^ ((z * _PRIMES[2]) & _U32))
    hashed = hashed % table_size
    return torch.where(dense_fits, dense_idx % table_size, hashed)


def flat_indices(idx: torch.Tensor, table_size: int) -> torch.Tensor:
    """Per-level indices [L,...] into the [L,T,F] table -> flat row
    indices [L*...] into its [L*T, F] view."""
    lvl = torch.arange(idx.shape[0], device=idx.device) * table_size
    return (idx + lvl.reshape(-1, *([1] * (idx.dim() - 1)))).reshape(-1)


def _flat_gather(table: torch.Tensor, idx: torch.Tensor,
                 cfg: HashGridConfig) -> torch.Tensor:
    """Gather [L,N,8] per-level indices from the [L,T,F] table as one flat
    gather on [L*T, F]."""
    L, T, F = table.shape
    flat = table.reshape(L * T, F)
    out = hash_scatter.gather_rows(flat, flat_indices(idx, T),
                                   cfg.compute_dtype == "bfloat16")
    return out.reshape(*idx.shape, F)


_OFFSETS8 = tuple((i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1))


def corner_indices(x: torch.Tensor, cfg: HashGridConfig):
    """Table indices of the 8 trilerp corners of every level.

    x: [N,3] in [0,1]^3. Returns (idx [L,N,8] int64, frac [L,N,3]).
    """
    dev = x.device
    res_np = cfg.resolutions().astype(np.int64)
    res = torch.as_tensor(res_np, device=dev)
    pos = x[None, :, :] * res[:, None, None].to(x.dtype)        # [L,N,3]
    offsets = torch.as_tensor(_OFFSETS8, dtype=torch.int64, device=dev)
    pos_floor = torch.floor(pos)
    frac = pos - pos_floor
    base = pos_floor.to(torch.int64)
    corners = base[:, :, None, :] + offsets[None, None, :, :]   # [L,N,8,3]
    corners = torch.minimum(torch.clamp(corners, min=0),
                            res[:, None, None, None])
    dense_fits = torch.as_tensor((res_np + 1) ** 3 <= cfg.table_size,
                                 device=dev)[:, None, None]
    idx = _level_indices(corners, res[:, None, None], dense_fits,
                         cfg.table_size)
    return idx, frac


def _corner_data(table: torch.Tensor, x: torch.Tensor, cfg: HashGridConfig):
    """Gather the 8 trilerp corner features for every level.

    x: [N,3] in [0,1]^3. Returns (feats [L,N,8,F], frac [L,N,3]).
    """
    idx, frac = corner_indices(x, cfg)
    feats = _flat_gather(table, idx, cfg)                        # [L,N,8,F]
    return feats, frac


def _corner_weights(frac: torch.Tensor):
    """Per-dim trilerp factors wd [L,N,8,3] and the sign pattern [8,3]."""
    offsets = torch.as_tensor(_OFFSETS8, dtype=torch.int64, device=frac.device)
    hi = offsets[None, None, :, :] == 1
    wd = torch.where(hi, frac[:, :, None, :], 1.0 - frac[:, :, None, :])
    sgn = torch.where(offsets == 1, 1.0, -1.0).to(frac.dtype)
    return wd, sgn


@obs.traced("hashgrid.encode")
def encode(table: torch.Tensor, x_unit: torch.Tensor,
           cfg: HashGridConfig) -> torch.Tensor:
    """table [L,T,F]; x_unit [...,3] in [0,1]^3 -> [..., L*F] features."""
    orig_shape = x_unit.shape[:-1]
    x = x_unit.reshape(-1, 3)
    N = x.shape[0]
    feats, frac = _corner_data(table, x, cfg)
    wd, _ = _corner_weights(frac)
    w = wd[..., 0] * wd[..., 1] * wd[..., 2]                     # [L,N,8]
    out = torch.sum(feats * w[..., None], dim=2)                 # [L,N,F]
    out = out.transpose(0, 1).reshape(N, cfg.n_levels * cfg.n_features_per_level)
    return out.reshape(*orig_shape, -1)


@obs.traced("hashgrid.encode")
def encode_with_grad(table: torch.Tensor, x_unit: torch.Tensor,
                     cfg: HashGridConfig):
    """Hash-encode positions AND the analytic spatial Jacobian in one
    gather pass. Returns (enc [...,L*F], denc_dx [...,L*F,3]) with the
    derivative w.r.t. x_unit: d(trilerp)/dx_j = sum_c feat_c * (±prod of
    the other two dims' weights) * N_l."""
    orig_shape = x_unit.shape[:-1]
    x = x_unit.reshape(-1, 3)
    N = x.shape[0]
    res = torch.as_tensor(cfg.resolutions().astype(np.int64), device=x.device)
    feats, frac = _corner_data(table, x, cfg)
    wd, sgn = _corner_weights(frac)
    w = wd[..., 0] * wd[..., 1] * wd[..., 2]
    enc = torch.sum(feats * w[..., None], dim=2)                 # [L,N,F]
    others = torch.stack([wd[..., 1] * wd[..., 2],
                          wd[..., 0] * wd[..., 2],
                          wd[..., 0] * wd[..., 1]], dim=-1)      # [L,N,8,3]
    dscale = res[:, None, None, None].to(x.dtype)
    dw_dx = sgn * others * dscale
    denc = torch.einsum("lncf,lncj->lnfj", feats, dw_dx)         # [L,N,F,3]
    D = cfg.n_levels * cfg.n_features_per_level
    enc = enc.transpose(0, 1).reshape(N, D)
    denc = denc.transpose(0, 1).reshape(N, D, 3)
    return enc.reshape(*orig_shape, D), denc.reshape(*orig_shape, D, 3)


def _bounds(bound_min, bound_max, like):
    return (torch.as_tensor(bound_min, dtype=like.dtype, device=like.device),
            torch.as_tensor(bound_max, dtype=like.dtype, device=like.device))


def embed_with_grad(table, xyz, cfg: HashGridConfig, bound_min, bound_max,
                    rescale: float = 1.0):
    """Like ``embed`` but also returns d(embedding)/d(xyz) [...,D,3]."""
    bmin, bmax = _bounds(bound_min, bound_max, xyz)
    scale = 1.0 / (bmax - bmin)
    x_unit = (xyz - bmin) * scale
    enc, denc_unit = encode_with_grad(table, x_unit, cfg)
    denc = denc_unit * scale
    if cfg.include_input:
        enc = torch.cat([xyz / rescale, enc], dim=-1)
        eye = (torch.eye(3, dtype=xyz.dtype, device=xyz.device) / rescale
               ).expand(*xyz.shape[:-1], 3, 3)
        denc = torch.cat([eye, denc], dim=-2)
    return enc, denc


def embed(table, xyz, cfg: HashGridConfig, bound_min, bound_max,
          rescale: float = 1.0) -> torch.Tensor:
    """Normalize into the AABB, hash-encode, optionally prepend raw
    xyz/rescale."""
    bmin, bmax = _bounds(bound_min, bound_max, xyz)
    x_unit = (xyz - bmin) / (bmax - bmin)
    enc = encode(table, x_unit, cfg)
    if cfg.include_input:
        enc = torch.cat([xyz / rescale, enc], dim=-1)
    return enc
