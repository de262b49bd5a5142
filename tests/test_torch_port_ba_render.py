"""The BA ``sfm_refine`` and the refine steps against the JAX package, from
the state and with the tolerances of ``test_torch_port_ba.py``.
Kept apart so that it runs after the suite's long files have started: pytest-xdist's loadfile queue starts the files with more tests first.
"""
import jax
import numpy as np
import pytest

from level_s2fm_tpu.sfm import bundle as jbundle
from level_s2fm_tpu_torch.sfm import bundle as tbundle

from torch_port_helpers import jit_jax_occ

from test_torch_port_ba import (  # noqa: F401
    _batches_match, _bundlers, _check_metrics, _poses_match, _render_draws, _start_from_jax, _tree_to, state)


@pytest.mark.parametrize("mode", ["sfm_refine", "refine"])
def test_rendering_steps_match(state, mode):
    """BA ``sfm_refine`` of view 1 alone (pose cotangents through the
    composite) and ``RefinePhase`` over both views, three steps each."""
    jm, tm = state
    if mode == "sfm_refine":
        jb, js, tb, ts = _bundlers(state, [1], "sfm_refine")
        jphase, tphase = jb.phase, tb.phase
        jbatch, tbatch = dict(jb.batch), dict(tb.batch)
    else:
        jr = jbundle.Refiner(jm.opt, jm.cfgs, jm.camera_set, jm.point_set)
        tr = tbundle.Refiner(tm.opt, tm.cfgs, tm.camera_set, tm.point_set,
                             device="cpu")
        _batches_match(tr.batch, jr.batch)
        jphase, tphase = jr.phase, tr.phase
        jbatch, tbatch = dict(jr.batch), dict(tr.batch)
        js = jphase.init_state(jm.params)
        ts = tphase.init_state(_tree_to(tm.params, "cpu"))
    jbatch["occ"] = jit_jax_occ()(jm.opt, jm.cfgs, js["params"])
    tbatch["occ"] = tbundle.maybe_build_occ(tm.opt, tm.cfgs, ts["params"])
    C, HW = tbatch["images"].shape[:2]
    n_rays = min(tm.cfgs.rand_rays // C, HW)
    for i in range(3):
        key = jax.random.PRNGKey(20 + i)
        if mode == "sfm_refine" and i == 2:
            _start_from_jax(ts, js)
        js, jmet = jphase.step(js, jbatch, key)
        tmet = tphase.step(ts, tbatch, None,
                           **_render_draws(key, HW, n_rays, tbatch["n_real"]))
        _check_metrics(tmet, jmet, i)
        if mode == "sfm_refine" and i == 0:
            _poses_match(ts, js, 1e-6)
    assert float(jmet["rgb"]) > 0 and float(jmet["tracing_loss"]) > 0
    if mode == "sfm_refine":
        moved = ts["params"]["se3_r"].detach().numpy() - tm.camera_set(1).se3[:3]
        assert np.abs(moved).max() > 1e-3      # the pose did move
        _poses_match(ts, js, 5e-4)
