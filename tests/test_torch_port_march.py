"""The port's sphere march / re-eval / tracing against the JAX package's
on the same rays and weights (CPU, small widths).

The march is a chain of threshold decisions (|sdf| <= thr, acc_s <
acc_e); both sides see float32 values that agree to ~1e-6, so the
decisions agree and the tracks match to 1e-5 relative. The random draws
of ``march_samples`` are taken from the JAX key here and handed to the
port, so the sample points match too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from level_s2fm_tpu.data import synthetic as jsyn
from level_s2fm_tpu.fields import sdf as jsdf
from level_s2fm_tpu.geometry import transforms as jT
from level_s2fm_tpu_torch.convert import params_from_jax
from level_s2fm_tpu_torch.fields import sdf as tsdf

from torch_port_helpers import jax_opt, jax_params_np, perturb_table, rel_err, torch_opt

TOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    opt_j, opt_t = jax_opt(), torch_opt()
    pnp = perturb_table(jax_params_np(opt_j), seed=1, scale=0.01)
    scene = jsyn.make_scene(n_views=2, H=16, W=16, n_points=64, seed=0)
    rng = np.random.default_rng(0)
    pix = rng.uniform(0, 16, size=(90, 2)).astype(np.float32)
    c, r = jT.get_center_and_ray(jnp.asarray(scene.poses_gt), jnp.asarray(scene.intrs[0]),
                                 jnp.asarray(pix))
    c, r = np.array(c).reshape(1, -1, 3), np.array(r).reshape(1, -1, 3)
    # a few rays that miss the AABB entirely
    c[0, :4] = [3.0, 3.0, 3.0]
    r[0, :4] = [1.0, 0.0, 0.0]
    return (jsdf.config_from_opt(opt_j), tsdf.config_from_opt(opt_t), pnp,
            c.astype(np.float32), r.astype(np.float32))


@pytest.mark.parametrize("iters", [10, 60])
def test_sphere_march_matches_jax(setup, iters):
    """At 10 steps some rays are still unfinished at the cap; at 60 every
    ray converges early and the port's loop stops there."""
    jcfg, tcfg, pnp, c, r = setup
    jcfg = dataclasses.replace(jcfg, iters_max=iters)
    tcfg = dataclasses.replace(tcfg, iters_max=iters)
    jm = jax.jit(lambda p, c_, r_: jsdf.sphere_march(p, jcfg, c_, r_))(
        jax.tree.map(jnp.asarray, pnp["sdf"]), jnp.asarray(c), jnp.asarray(r))
    tm = tsdf.sphere_march(params_from_jax(pnp["sdf"], device="cpu"), tcfg,
                           torch.as_tensor(c), torch.as_tensor(r))
    np.testing.assert_array_equal(tm.contrib.numpy(), np.asarray(jm.contrib))
    assert tm.last_idx == int(jm.last_idx)
    if iters == 10:
        assert tm.last_idx == iters - 1
    else:
        assert 0 < tm.last_idx < iters - 1    # the early-out is exercised
    # positions accumulate one sdf step per iteration: the ~1e-7 relative
    # differences of the two evals add up to ~5e-5 over a 40-step march
    assert rel_err(tm.track, jm.track) < (TOL if iters == 10 else 1e-4)
    np.testing.assert_array_equal(tm.valid.numpy(), np.asarray(jm.valid))
    for a in ("min_dis", "max_dis", "acc_e"):
        assert rel_err(getattr(tm, a), getattr(jm, a)) < TOL, a
