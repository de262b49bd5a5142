"""Faults planted in the program under the timed path, for the check to
catch (``portbench.calibrate`` reads them on the card; the CPU tests
drive whole runs with them). Each is a context manager that patches a
module attribute of the port and restores it.

- ``unchanged``: a step that leaves the parameters and the optimizer's
  state as they were (the update is never applied);
- ``half_batch``: the render's loss bundle on half of the step's rays,
  the means taken over the rest (the draws are made as before);
- ``scatter_altered``: the ordered scatter's answer altered where it is
  produced: every row's sum halved (the hash table's gradient, and the
  compaction gather's);
- ``pose_identity`` (the init's set-up, which the reference takes from
  the program): the two-view estimate's rotation replaced by the
  identity.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(mod, name, value):
    orig = getattr(mod, name)
    setattr(mod, name, value)
    try:
        yield
    finally:
        setattr(mod, name, orig)


def unchanged():
    import torch
    from level_s2fm_tpu_torch.sfm import phases

    def no_update(opt, grads):
        return torch.zeros((), device=grads[0].device)
    return _patched(phases, "guarded_update", no_update)


def half_batch():
    import torch
    from level_s2fm_tpu_torch.sfm import phases
    orig = phases.render_core

    def half(params, cfgs, gen, poses, intr, images, grid, *a, rays_idx=None, **k):
        if rays_idx is None:
            HW = cfgs.H * cfgs.W
            n = min(max(cfgs.rand_rays // poses.shape[0], 1), HW)
            rays_idx = torch.randperm(HW, generator=gen)[:n]
        return orig(params, cfgs, gen, poses, intr, images, grid, *a,
                    rays_idx=rays_idx[:len(rays_idx) // 2], **k)
    return _patched(phases, "render_core", half)


def scatter_altered():
    from level_s2fm_tpu_torch.fields import hash_scatter
    orig = hash_scatter.ordered_scatter_add

    def halved(gi, g, m):
        return orig(gi, g, m) * 0.5
    return _patched(hash_scatter, "ordered_scatter_add", halved)


def pose_identity():
    import dataclasses

    import numpy as np
    from level_s2fm_tpu_torch.sfm import hostgeom
    orig = hostgeom.estimate_essential

    def identity(*a, **k):
        return dataclasses.replace(orig(*a, **k), R=np.eye(3))
    return _patched(hostgeom, "estimate_essential", identity)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "scatter_altered": scatter_altered, "pose_identity": pose_identity}
