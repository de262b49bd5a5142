"""Radiance (appearance) field.

Counterpart of ``level_s2fm_tpu/fields/radiance.py``: a decoder MLP over
[xyz, sdf normal, Fourier-embedded view dir, SDF geometry feature].
Parameters are ``{"rad_mlp": {"layers": [...]}}``. The ``dual_field``
ablation waits.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from . import embedder, mlp


@dataclasses.dataclass(frozen=True)
class RadFConfig:
    layers: Tuple[Optional[int], ...] = (None, 64, 64, 3)
    geo_feat_dim: int = 16           # last layer width of the SDF arch
    fourier: embedder.FourierConfig = embedder.FourierConfig()
    rescale: float = 1.0
    activation: str = "none"         # reference's dead inner ReLU (see mlp.py)

    @property
    def input_enc_dim(self) -> int:
        # 3 point + view_emb + 3 normal + geo_feat
        return 3 + self.fourier.out_dim + 3 + self.geo_feat_dim


def config_from_opt(opt) -> RadFConfig:
    if opt.Ablate_config.get("dual_field", False):
        raise NotImplementedError("Ablate_config.dual_field is not ported yet")
    return RadFConfig(
        layers=tuple(opt.RadF.arch.layers),
        geo_feat_dim=int(opt.SDF.arch.layers[-1]),
        rescale=float(opt.SDF.VolSDF.rescale),
        activation=str(opt.RadF.get("activation", "none")),
    )


def init_params(cfg: RadFConfig, gen: torch.Generator, device=None):
    return {"rad_mlp": mlp.init_radiance_mlp(gen, cfg.input_enc_dim,
                                             cfg.layers, device=device)}


def embed_view(cfg: RadFConfig, view_dir: torch.Tensor) -> torch.Tensor:
    return embedder.fourier_embed(view_dir, cfg.fourier)


def infer_app(params, cfg: RadFConfig, all_enc: torch.Tensor) -> torch.Tensor:
    """[...,input_enc_dim] -> rgb [...,3] in (0,1)."""
    return mlp.apply_radiance_mlp(params["rad_mlp"], all_enc,
                                  activation=cfg.activation)
