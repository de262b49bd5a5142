"""Fourier (positional) embedding of view directions.

Counterpart of ``level_s2fm_tpu/fields/embedder.py::fourier_embed``: 4
log-spaced frequency bands, sin/cos, raw input included (divided by
``rescale``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FourierConfig:
    input_dim: int = 3
    max_freq_log2: float = 3.0
    n_freqs: int = 4
    log_sampling: bool = True
    include_input: bool = True

    @property
    def out_dim(self) -> int:
        d = self.input_dim * self.n_freqs * 2
        if self.include_input:
            d += self.input_dim
        return d

    def freq_bands(self) -> np.ndarray:
        if self.log_sampling:
            return 2.0 ** np.linspace(0.0, self.max_freq_log2, self.n_freqs)
        return np.linspace(2.0 ** 0.0, 2.0 ** self.max_freq_log2, self.n_freqs)


def fourier_embed(x: torch.Tensor, cfg: FourierConfig = FourierConfig(),
                  rescale: float = 1.0) -> torch.Tensor:
    out = []
    if cfg.include_input:
        out.append(x / rescale)
    for freq in cfg.freq_bands():
        out.append(torch.sin(x * float(freq)))
        out.append(torch.cos(x * float(freq)))
    return torch.cat(out, dim=-1)
