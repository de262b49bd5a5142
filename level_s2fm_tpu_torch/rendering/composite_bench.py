"""Inputs, byte counts and an ablation of the composite kernels on the card.

``composite_inputs`` and ``composite_bytes`` serve ``chip_smoke.py``.
Run as a script on a machine with an NVIDIA GPU and ``nvcc``:

    python3 -m level_s2fm_tpu_torch.rendering.composite_bench

it builds variants of ``csrc/composite.cu`` (by text substitution, into
``_build/ablation/``) and times each against the kernel as it is at the
main path's shape (R = 4096, K = 32) and beyond L2 (R = 65,536), in the
order kernel, variants, variants reversed, kernel:

- ``no_dab_reduction``: the backward without its in-launch dalpha/dbeta
  reduction (ticket and last-block sum); the reduction's cost;
- ``no_sample_stores``: the backward without its per-sample stores
  (d_sdf, d_rgb, d_depth, d_normal); their cost;
- ``fence_then_atomicadd``: the ticket taken after a ``__threadfence``
  with a plain ``atomicAdd`` (and a fence in the last block), in place of
  one acquire-release atomic add.

The variants are for measurement only; their outputs are not checked.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os

import torch

from .. import devtime, kernels
from . import fused_composite as fc


def composite_inputs(R, K, seed, dev):
    """Inputs in the kernels' layout (the renderer's): sdf/depth [R,K],
    valid [R,K] bool, delta [R], rgb/normal [R,K,3], alpha/beta scalars,
    and the per-ray cotangents."""
    g = torch.Generator().manual_seed(seed)
    u = lambda *s: torch.rand(*s, generator=g)  # noqa: E731
    sdf = (u(R, K) - 0.5) * 0.2
    valid = u(R, K) > 0.3
    delta = 0.01 + 0.09 * u(R)
    rgb = u(R, K, 3)
    depth = 0.5 + 2.5 * u(R, K)
    normal = u(R, K, 3) * 2 - 1
    grads = (u(R, 3) - 0.5, u(R) - 0.5, u(R, 3) - 0.5, u(R) - 0.5)
    ab = torch.tensor([20.0, 0.05], device=dev)
    args = [x.to(dev) for x in (sdf, valid, delta, rgb, depth, normal)]
    return args + [ab[0], ab[1]], [x.to(dev) for x in grads]


def composite_bytes(R, K):
    """(forward, backward) bytes: each input read once, each output
    written once. Per sample sdf, depth 4 B, valid 1 B, rgb, normal 12 B;
    per ray delta 4 B; alpha, beta 8 B; forward out 8 floats per ray;
    backward in adds 8 floats per ray of cotangents, out 8 floats per
    sample, d_delta one float per ray and d_ab 2 floats."""
    inputs = R * K * 33 + 4 * R + 8
    return inputs + 32 * R, inputs + 32 * R + 32 * R * K + 4 * R + 8


_TICKET = '''    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\\n"
                 : "=r"(ticket) : "l"(d.ticket) : "memory");'''

#: variant name -> [(text in composite.cu, its replacement at every place)]
VARIANTS = {
    "no_dab_reduction": [("  reduce_ab(pa, pb, d);\n}",
                          "  if (pa == 12345.f) d.ab[0] = pb;\n}")],
    "no_sample_stores": [("  if (in) {\n    *reinterpret_cast<float4*>(d.sdf + e) =",
                          "  if (in && pa == 12345.f) {\n    *reinterpret_cast<float4*>(d.sdf + e) =")],
    "fence_then_atomicadd": [
        (_TICKET, "    __threadfence();\n    ticket = atomicAdd(d.ticket, 1);"),
        ("  if (!last) return;\n", "  if (!last) return;\n  __threadfence();\n")],
}


def build_variants():
    """Build every variant; returns {name: ctypes library}."""
    src = open(os.path.join(kernels.CSRC, "composite.cu")).read()
    libs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer has {old!r}")
            text = text.replace(old, new)
        stem = os.path.join(kernels.BUILD_DIR, "ablation", f"{name}-"
                            + hashlib.sha1(text.encode()).hexdigest()[:12])
        os.makedirs(os.path.dirname(stem), exist_ok=True)
        with open(stem + ".cu", "w") as f:
            f.write(text)
        libs[name] = ctypes.CDLL(kernels.compile_source(stem + ".cu", stem + ".so", name))
    return libs


def _timed(lib, args, grads):
    """(forward, backward) device ms with ``lib`` as the composite library."""
    saved = kernels._LIBS.get("composite")
    kernels._LIBS["composite"] = lib
    try:
        tf = devtime.time_ms(lambda: fc.forward_cuda(*args))[0]
        tb = devtime.time_ms(lambda: fc.backward_cuda(*args, *grads,
                                                      need_delta=False))[0]
    finally:
        kernels._LIBS["composite"] = saved
    return tf, tb


def main():
    if not torch.cuda.is_available():
        raise SystemExit("composite_bench needs an NVIDIA GPU")
    dev = torch.device("cuda")
    libs = {"kernel": kernels.load("composite"), **build_variants()}
    order = list(libs) + list(libs)[::-1]
    res = {}
    for R in (4096, 65536):
        args, grads = composite_inputs(R, 32, 7, dev)
        for name in order:
            tf, tb = _timed(libs[name], args, grads)
            res.setdefault(f"R={R}", {}).setdefault(name, []).append([tf * 1e3, tb * 1e3])
            print(f"[ablation] R={R} K=32 {name}: fwd {tf * 1e3:.3f} us, "
                  f"bwd (no d_delta) {tb * 1e3:.3f} us", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "us": res}))


if __name__ == "__main__":
    main()
