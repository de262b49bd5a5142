"""Phase segments with occupancy refresh.

Counterpart of ``run_phase_occ_refresh`` / ``maybe_build_occ`` in
``level_s2fm_tpu/sfm/bundle.py``. The bundler and refiner wait for the
BA slice.
"""
from __future__ import annotations

import torch

from ..fields import sdf as sdf_mod
from ..rendering import raymarch as rm


def run_phase_occ_refresh(opt, cfgs, phase, state, batch, gen, n_iters,
                          segments: int = 4):
    """Run a phase in outer segments, rebuilding the occupancy grid from
    the CURRENT SDF between segments (the surface moves during a phase;
    the compaction band must follow it). The optimizer's step count runs
    on across segments."""
    seg = max(n_iters // segments, 1)
    done = 0
    parts = []
    while done < n_iters:
        n = min(seg, n_iters - done)
        b = dict(batch)
        b["occ"] = maybe_build_occ(opt, cfgs, state["params"])
        state, m = phase.run(state, b, gen, n_iters=n)
        parts.append(m)
        done += n
    return state, {k: torch.cat([m[k] for m in parts]) for k in parts[0]}


def maybe_build_occ(opt, cfgs, params):
    """Occupancy grid for compacted rendering (None unless
    Renderer.compact_samples is set)."""
    if cfgs.ren.compact_samples is None:
        return None
    ren = opt.get("Renderer", {})
    table = params["sdf"]["table"]
    return rm.build_occupancy_grid(
        lambda p: sdf_mod.infer_sdf(params["sdf"], cfgs.sdf, p),
        cfgs.sdf.center, cfgs.sdf.half_size,
        resolution=int(ren.get("occ_res", 64)),
        threshold=float(ren.get("occ_threshold", 0.25)), one_sided=True,
        device=table.device)
