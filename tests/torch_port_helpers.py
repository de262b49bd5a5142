"""Shared fixtures of the port's parity tests (tests/test_torch_port_*.py).

A tiny configuration of the default config chain, built once per side:
the JAX package's options and the port's from the same YAML and the same
overrides, at a size that keeps each test file well under its budget.
"""
import numpy as np
import torch

# the suite runs in several worker processes at once: keep each worker's
# torch to two threads so the port's tests do not crowd the others
torch.set_num_threads(2)

#: small widths: 4 hash levels x 2 features x 2^13 (level 0 dense, the
#: rest hashed), 16x16 images, 16 samples compacted to 8, all 256 pixels
#: of both views drawn every step (rand_rays // 2 == H*W), so the
#: losses do not depend on the ray permutation
TINY_ARGS = [
    "--yaml=configs/synthetic.yaml",
    "--data.image_size=[16,16]",
    "--data.n_views=2",
    "--data.n_points=64",
    "--SDF.Hash_config.n_levels=4",
    "--SDF.Hash_config.log2_hashmap_size=13",
    "--SDF.arch.layers=[null,16,8]",
    "--RadF.arch.layers=[null,16,16,3]",
    "--SDF.VolSDF.sample_intvs=16",
    "--SDF.VolSDF.iters_max_st=10",
    "--Renderer.rand_rays=512",
    "--Renderer.compact_samples=8",
    "--Renderer.occ_res=16",
    "--optim.init.max_iter=3",
]


def jax_opt(extra=()):
    from level_s2fm_tpu.config import build_options
    return build_options(TINY_ARGS + list(extra))


def torch_opt(extra=()):
    from level_s2fm_tpu_torch.config import build_options
    return build_options(TINY_ARGS + list(extra))


def jax_params_np(opt, seed=0):
    """JAX-initialised field parameters as a numpy pytree."""
    import jax
    from level_s2fm_tpu.fields import radiance as radf
    from level_s2fm_tpu.fields import sdf as sdf_mod
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    params = {"sdf": sdf_mod.init_params(k1, sdf_mod.config_from_opt(opt)),
              "rad": radf.init_params(k2, radf.config_from_opt(opt))}
    return jax.tree.map(np.asarray, params)


def perturb_table(params_np, seed=0, scale=0.05):
    """Give the near-zero initial hash table visible features, so the
    parity tests exercise the table's contribution and gradient."""
    rng = np.random.default_rng(seed)
    t = params_np["sdf"]["table"]
    params_np["sdf"]["table"] = (t + scale * rng.standard_normal(t.shape)
                                 ).astype(np.float32)
    return params_np


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30))


def _scene_var(n_views):
    from level_s2fm_tpu_torch.data import synthetic as tsyn
    return tsyn.scene_to_var(tsyn.make_scene(n_views=n_views, H=16, W=16,
                                             n_points=64, seed=0))


def copy_scene(jm, tm):
    """Give the port's engine the JAX engine's state: the field
    parameters (``convert.params_from_jax``), cameras and points."""
    import jax
    from level_s2fm_tpu_torch.convert import params_from_jax
    from level_s2fm_tpu_torch.sfm import entities
    tm.params = params_from_jax(jax.tree.map(np.array, jm.params), device="cpu")
    tm.camera_set = entities.CameraSet()
    for c in jm.camera_set.cameras:
        tm.camera_set.add(entities.Camera(
            id=c.id, img=c.img, intr=c.intr, pose_gt=c.pose_gt, kypts=c.kypts,
            matches=c.matches, inlier_masks=c.inlier_masks, se3=c.se3,
            idx2d_to_3d=c.idx2d_to_3d))
    tm.point_set = entities.PointSet()
    tm.point_set.add_points(jm.point_set.all_xyzs().copy(),
                            [list(t) for t in jm.point_set.tracks])


def two_view_state(n_views=3, extra=()):
    """The JAX package's two-view start of the tiny configuration on an
    ``n_views`` scene, and the port's engine given the same state by
    ``copy_scene``. Returns (jax engine, port engine).

    The JAX ``Initializer`` bootstraps the two poses (5-point RANSAC)
    and triangulates the keypoints by sphere tracing; its field fitting
    (``InitPhase``, held to the port by ``test_torch_port_slice.py``) is
    skipped, since compiling it would take most of a test file's time
    budget. Instead the hash table gets visible features
    (``perturb_table``), so the table's contribution and gradient are
    exercised."""
    import jax
    import jax.numpy as jnp
    from level_s2fm_tpu.sfm import initialization as jinit
    from level_s2fm_tpu.sfm import pipeline as jpipe
    from level_s2fm_tpu_torch.sfm import pipeline as tpipe
    args = [f"--data.n_views={n_views}", *extra]
    jm = jpipe.LevelSfM(jax_opt(args), seed=0)
    jm.load_data(_scene_var(n_views))
    params = perturb_table(jax.tree.map(np.array, jm.params), seed=1, scale=0.01)
    jm.params = jax.tree.map(jnp.asarray, params)
    var = jm.var
    init = jinit.Initializer(jm.opt, jm.cfgs, jm.camera_set, jm.point_set, {
        "indx_init": [0, 1], "imgs_init": [var["images"][0], var["images"][1]],
        "kypts_init": [var["kypts"][0], var["kypts"][1]],
        "intrs_init": [var["intrs"][0], var["intrs"][1]],
        "mchs_init": [var["matches"][0], var["matches"][1]],
        "inliers_init": [var["masks"][0], var["masks"][1]],
        "poses_gt": var["poses_gt"]})
    pts, finish = init.phase.triangulate(jm.params, init.batch,
                                         jax.random.PRNGKey(0))
    init._triangulate_host(np.asarray(pts), np.asarray(finish))
    tm = tpipe.LevelSfM(torch_opt(args), seed=0, device="cpu")
    tm.load_data(_scene_var(n_views))
    copy_scene(jm, tm)
    return jm, tm
