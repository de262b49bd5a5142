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
