"""The port's renderer against the JAX package's on the CPU: the
occupancy grid, ``compact_by_occupancy`` and ``render`` on both the
compacted path (the fused composite's plain version on the CPU; the JAX side
takes its jnp composite on the CPU) and the uncompacted path, with
chunking and gradients.

Tolerance: 1e-5 relative to the largest magnitude for values, 1e-4 for
parameter gradients (sums over thousands of samples in another order).
Sample selection is compared exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from level_s2fm_tpu.data import synthetic as jsyn
from level_s2fm_tpu.fields import radiance as jradf
from level_s2fm_tpu.fields import sdf as jsdf
from level_s2fm_tpu.geometry import transforms as jT
from level_s2fm_tpu.rendering import raymarch as jrm
from level_s2fm_tpu.rendering import renderer as jren
from level_s2fm_tpu_torch.convert import params_from_jax
from level_s2fm_tpu_torch.fields import radiance as tradf
from level_s2fm_tpu_torch.fields import sdf as tsdf
from level_s2fm_tpu_torch.rendering import raymarch as trm
from level_s2fm_tpu_torch.rendering import renderer as tren

from torch_port_helpers import jax_opt, jax_params_np, perturb_table, rel_err, torch_opt

TOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    opt_j, opt_t = jax_opt(), torch_opt()
    pnp = perturb_table(jax_params_np(opt_j), seed=2, scale=0.01)
    scene = jsyn.make_scene(n_views=2, H=16, W=16, n_points=64, seed=0)
    pix = np.random.default_rng(5).uniform(0, 16, size=(45, 2)).astype(np.float32)
    c, r = jT.get_center_and_ray(jnp.asarray(scene.poses_gt),
                                 jnp.asarray(scene.intrs[0]), jnp.asarray(pix))
    jcfgs = (jsdf.config_from_opt(opt_j), jradf.config_from_opt(opt_j),
             dataclasses.replace(jren.config_from_opt(opt_j), ray_chunk=32))
    tcfgs = (tsdf.config_from_opt(opt_t), tradf.config_from_opt(opt_t),
             dataclasses.replace(tren.config_from_opt(opt_t), ray_chunk=32))
    jp = jax.tree.map(jnp.asarray, pnp)
    sdf_fn = jax.jit(lambda p: jsdf.infer_sdf(jp["sdf"], jcfgs[0], p))
    jocc = jrm.build_occupancy_grid(
        sdf_fn,
        jnp.asarray(jcfgs[0].center, jnp.float32),
        jnp.asarray(jcfgs[0].half_size, jnp.float32),
        resolution=16, threshold=0.25, one_sided=True)
    return opt_t, pnp, jp, jcfgs, tcfgs, np.array(c), np.array(r), jocc


def _tocc(jocc):
    return trm.OccupancyGrid(occ=torch.as_tensor(np.asarray(jocc.occ)),
                             center=torch.as_tensor(np.asarray(jocc.center)),
                             half_size=torch.as_tensor(np.asarray(jocc.half_size)))


def test_occupancy_grid_matches_jax(setup):
    opt_t, pnp, jp, jcfgs, tcfgs, c, r, jocc = setup
    from level_s2fm_tpu_torch.sfm import bundle
    from level_s2fm_tpu_torch.sfm.phases import PhaseCfgs
    cfgs = PhaseCfgs(sdf=tcfgs[0], rad=tcfgs[1], ren=tcfgs[2], H=16, W=16)
    occ = bundle.maybe_build_occ(opt_t, cfgs, params_from_jax(pnp, device="cpu"))
    assert occ.resolution == 16
    np.testing.assert_array_equal(occ.occ.numpy(), np.asarray(jocc.occ))
    assert 0 < int(occ.occ.sum()) < 16 ** 3


def test_compact_by_occupancy_matches_jax(setup):
    opt_t, pnp, jp, jcfgs, tcfgs, c, r, jocc = setup
    depths = np.array(jax.jit(lambda c_, r_: jren.volsdf_sampling(
        jp["sdf"], jcfgs[0], jcfgs[2], c_, r_))(jnp.asarray(c), jnp.asarray(r)))
    td = tren.volsdf_sampling(None, tcfgs[0], tcfgs[2], torch.as_tensor(c),
                              torch.as_tensor(r))
    assert rel_err(td, depths) < TOL
    jd, jv = jax.jit(lambda d_, c_, r_, o_: jren.compact_by_occupancy(
        d_, c_, r_, o_, 8))(jnp.asarray(depths), jnp.asarray(c), jnp.asarray(r), jocc)
    d, v = tren.compact_by_occupancy(torch.as_tensor(depths), torch.as_tensor(c),
                                     torch.as_tensor(r), _tocc(jocc), 8)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    assert v.any() and not v.all()
