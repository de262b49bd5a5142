"""Radiance (appearance) field.

Counterpart of ``level_s2fm_tpu/fields/radiance.py``: a decoder MLP over
[xyz, sdf normal, Fourier-embedded view dir, SDF geometry feature].
Parameters are ``{"rad_mlp": {"layers": [...]}}``. The ``dual_field``
ablation adds a second hash grid (``table``, read at ``compute_dtype``
like the SDF's) and geometry MLP (``geo_mlp``), built like the SDF's,
whose feature is appended to the decoder's input.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from . import embedder, hashgrid, mlp


@dataclasses.dataclass(frozen=True)
class RadFConfig:
    layers: Tuple[Optional[int], ...] = (None, 64, 64, 3)
    geo_feat_dim: int = 16           # last layer width of the SDF arch
    dual_field: bool = False
    fourier: embedder.FourierConfig = embedder.FourierConfig()
    rescale: float = 1.0
    activation: str = "none"         # reference's dead inner ReLU (see mlp.py)
    # the dual-field geometry encoder (mirrors the SDF's)
    grid: Optional[hashgrid.HashGridConfig] = None
    geo_layers: Tuple[Optional[int], ...] = (None, 64, 16)
    geo_skip: Tuple[int, ...] = ()
    sphere_bias: float = 1.0
    tf_init: bool = True
    bound_min: Tuple[float, float, float] = (-1.0, -1.0, -1.0)
    bound_max: Tuple[float, float, float] = (1.0, 1.0, 1.0)

    @property
    def input_enc_dim(self) -> int:
        # 3 point + view_emb + 3 normal + geo_feat (+ the dual geo_feat)
        d = 3 + self.fourier.out_dim + 3 + self.geo_feat_dim
        if self.dual_field:
            d += self.geo_feat_dim
        return d


def config_from_opt(opt) -> RadFConfig:
    dual = bool(opt.Ablate_config.get("dual_field", False))
    return RadFConfig(
        layers=tuple(opt.RadF.arch.layers),
        geo_feat_dim=int(opt.SDF.arch.layers[-1]),
        dual_field=dual,
        rescale=float(opt.SDF.VolSDF.rescale),
        activation=str(opt.RadF.get("activation", "none")),
        grid=hashgrid.config_from_opt(opt) if dual else None,
        geo_layers=tuple(opt.SDF.arch.layers),
        geo_skip=tuple(opt.SDF.arch.get("skip", ())),
        sphere_bias=float(opt.SDF.NN_Init.bias),
        tf_init=bool(opt.SDF.NN_Init.get("tf_init", True)),
        bound_min=tuple(opt.data.bound_min),
        bound_max=tuple(opt.data.bound_max),
    )


def init_params(cfg: RadFConfig, gen: torch.Generator, device=None):
    params = {"rad_mlp": mlp.init_radiance_mlp(gen, cfg.input_enc_dim,
                                               cfg.layers, device=device)}
    if cfg.dual_field:
        params["table"] = hashgrid.init_table(cfg.grid, gen, device=device)
        params["geo_mlp"] = mlp.init_geometry_mlp(
            gen, cfg.grid.out_dim, cfg.geo_layers, cfg.geo_skip,
            sphere_bias=cfg.sphere_bias, tf_init=cfg.tf_init, device=device)
    return params


def geometry_feat(params, cfg: RadFConfig, xyz: torch.Tensor) -> torch.Tensor:
    """The dual field's geometry output [...,1+geo_feat_dim] at ``xyz``."""
    enc = hashgrid.embed(params["table"], xyz, cfg.grid,
                         cfg.bound_min, cfg.bound_max, rescale=cfg.rescale)
    return mlp.apply_geometry_mlp(params["geo_mlp"], enc, skip=cfg.geo_skip)


def embed_view(cfg: RadFConfig, view_dir: torch.Tensor) -> torch.Tensor:
    return embedder.fourier_embed(view_dir, cfg.fourier)


def infer_app(params, cfg: RadFConfig, all_enc: torch.Tensor) -> torch.Tensor:
    """[...,input_enc_dim] -> rgb [...,3] in (0,1)."""
    return mlp.apply_radiance_mlp(params["rad_mlp"], all_enc,
                                  activation=cfg.activation)
