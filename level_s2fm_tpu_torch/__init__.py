"""level_s2fm_tpu_torch — the PyTorch/CUDA port of level_s2fm_tpu for
NVIDIA Hopper (H100).

Incremental neural Structure-from-Motion on a hash-grid SDF and a
radiance field, ported slice by slice from the JAX package beside it
(which stays the numerical reference). This package imports torch, numpy
and the standard library only — never jax, and nothing of
``level_s2fm_tpu``.

Device policy:
  * TF32 is off for matmuls and cuDNN: the JAX package forces "highest"
    matmul precision because low-precision matmuls gave degree-level
    pose errors (``level_s2fm_tpu/__init__.py``).
  * Entry points run on ``cuda`` unless the caller asks for the CPU
    (``device="cpu"`` in the tests, ``--cpu`` on the command line). With
    no GPU and no explicit CPU request they raise; they never fall back.
"""

__version__ = "0.1.0"

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> _torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    passes another; raises when CUDA is asked for and absent."""
    dev = _torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not _torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (or --cpu) to run "
            "on the CPU explicitly")
    return dev
