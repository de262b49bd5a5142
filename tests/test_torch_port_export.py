"""The port's result export against the JAX package's, on the same
parameters and scene (three cameras at their GT poses, a few tracked
points). The CLI's ``--get_result`` is tested with the checkpoints
(``test_torch_port_checkpoint.py``).

Tolerances: marching cubes bitwise (the same numpy code on the same
volume); mesh vertices within 1e-4 (the SDF grids agree to ~1e-7, and a
vertex moves by that over the local SDF slope); renders within 1e-4 (the
plain composite over 16 samples, float32: measured ~1e-6) and the trace's
finish mask identical; the depth metrics within 1e-5; files byte for
byte except where a float comes from a pose (``cam.pose()`` is computed
by each package's own se(3) exponential, equal to ~1e-7), which are
compared parsed within 1e-6; ``colorize`` within 1/255 of matplotlib.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from level_s2fm_tpu.utils import export as jexp
from level_s2fm_tpu.utils import marching_cubes as jmc
from level_s2fm_tpu_torch.geometry import lie as tlie
from level_s2fm_tpu_torch.utils import export as texp
from level_s2fm_tpu_torch.utils import marching_cubes as tmc
from level_s2fm_tpu_torch.utils import vis as tvis

from torch_port_helpers import _scene_var, copy_scene, jax_opt, perturb_table, torch_opt


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


@pytest.fixture(scope="module", autouse=True)
def _jit_jax_trace():
    """The JAX package's ``render_traced_depth`` traces eagerly, op by op;
    the same functions jitted (one compile per shape) keep this file
    inside its time budget. The results are the same functions'."""
    from level_s2fm_tpu.fields import sdf as jsdf
    trace, grad = jsdf.sphere_tracing, jsdf.gradient
    jsdf.sphere_tracing = jax.jit(
        lambda p, cfg, o, d, key=None: trace(p, cfg, o, d, key=key),
        static_argnums=1)
    jsdf.gradient = jax.jit(grad, static_argnums=1)
    yield
    jsdf.sphere_tracing, jsdf.gradient = trace, grad


@pytest.fixture(scope="module")
def scene():
    """(JAX engine, port engine) with the same parameters (the JAX
    initialisation with a perturbed hash table) and the same scene: the
    three views of the tiny synthetic scene at their GT poses, and 24
    points tracked by views 0 and 1."""
    from level_s2fm_tpu.sfm import pipeline as jpipe
    from level_s2fm_tpu_torch.sfm import pipeline as tpipe
    args = ["--data.n_views=3"]
    jm = jpipe.LevelSfM(jax_opt(args), seed=0)
    jm.load_data(_scene_var(3))
    jm.params = jax.tree.map(jnp.asarray, perturb_table(
        jax.tree.map(np.array, jm.params), seed=1, scale=0.01))
    for cid in range(3):
        cam = jm._make_camera(cid)
        cam.se3 = tlie.SE3_to_se3(torch.as_tensor(
            jm.var["poses_gt"][cid][None]))[0].numpy()
        jm.camera_set.add(cam)
    a, b = jm.camera_set(0).matched_kypt_ids(1)
    n = min(24, len(a))
    xyz = np.random.default_rng(2).uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    jm.point_set.add_points(xyz, [[(0, int(a[i])), (1, int(b[i]))] for i in range(n)])
    jm.camera_set.cameras[0].idx2d_to_3d[a[:n]] = np.arange(n)
    jm.camera_set.cameras[1].idx2d_to_3d[b[:n]] = np.arange(n)
    tm = tpipe.LevelSfM(torch_opt(args), seed=0, device="cpu")
    tm.load_data(_scene_var(3))
    copy_scene(jm, tm)
    return jm, tm


def test_marching_cubes_is_bitwise_the_jax_copy(tmp_path):
    vol = np.random.default_rng(0).standard_normal((9, 10, 11)).astype(np.float32)
    jv, jf = jmc.marching_cubes(vol, level=0.1, origin=(-1, -1, -1),
                                spacing=(0.2, 0.2, 0.2))
    tv, tf = tmc.marching_cubes(vol, level=0.1, origin=(-1, -1, -1),
                                spacing=(0.2, 0.2, 0.2))
    assert len(jf) > 0 and np.array_equal(jv, tv) and np.array_equal(jf, tf)
    jmc.write_ply(str(tmp_path / "j.ply"), jv, jf)
    tmc.write_ply(str(tmp_path / "t.ply"), tv, tf)
    assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "t.ply").read_bytes()


@pytest.mark.parametrize("fn", ["extract_mesh", "extract_mesh_high_res"])
def test_mesh_extraction_matches_jax(scene, tmp_path, fn):
    jm, tm = scene
    kw = dict(resolution=24, grid_boundary=(-0.6, 0.6))
    if fn == "extract_mesh_high_res":
        kw["low_resolution"] = 24
    jv, jf = getattr(jexp, fn)(jm.params, jm.sdf_cfg, str(tmp_path / "j.ply"), **kw)
    tv, tf = getattr(texp, fn)(tm.params, tm.sdf_cfg, str(tmp_path / "t.ply"), **kw)
    assert len(tf) == len(jf) > 0
    # vertices are welded on rounded keys, so their order may differ where
    # two SDF values differ in the last bits: match them as point sets
    from scipy.spatial import cKDTree
    assert cKDTree(jv).query(tv)[0].max() <= 1e-4
    assert cKDTree(tv).query(jv)[0].max() <= 1e-4


def test_render_full_image_matches_jax(scene):
    jm, tm = scene
    cam_j, cam_t = jm.camera_set.cameras[0], tm.camera_set.cameras[0]
    a = jexp.render_full_image(jm.params, jm.cfgs, cam_j.pose(), cam_j.intr,
                               16, 16, ray_batch=128)
    b = texp.render_full_image(tm.params, tm.cfgs, cam_t.pose(), cam_t.intr,
                               16, 16, ray_batch=128)
    for k in ("rgb", "depth", "normal"):
        assert b[k].shape == a[k].shape and _err(a[k], b[k]) <= 1e-4, k


def test_render_traced_depth_matches_jax(scene):
    """The JAX trace draws its eikonal samples from PRNGKey(0); the same
    draws are given to the port (the outputs do not depend on them)."""
    jm, tm = scene
    cam_j, cam_t = jm.camera_set.cameras[1], tm.camera_set.cameras[1]
    a = jexp.render_traced_depth(jm.params, jm.sdf_cfg, cam_j.pose(), cam_j.intr,
                                 16, 16)
    k1, k2, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    draws = {"factor_rand": np.array(jax.random.uniform(k1, (256,))),
             "pick": np.array(jax.random.permutation(k2, 256))}
    b = texp.render_traced_depth(tm.params, tm.sdf_cfg, cam_t.pose(), cam_t.intr,
                                 16, 16, draws=draws)
    assert np.array_equal(a["finish"], b["finish"]) and b["finish"].any()
    fin = b["finish"]
    for k in ("depth", "normal"):
        assert _err(a[k][fin], b[k][fin]) <= 1e-4, k


def _parse_floats(text):
    out = []
    for t in text.split():
        try:
            out.append(float(t))
        except ValueError:
            pass
    return out


def test_colorize_matches_matplotlib():
    from level_s2fm_tpu.utils import vis as jvis
    g = np.random.default_rng(3).standard_normal((30, 40))
    g[0, 0], g[1, 1] = np.nan, np.inf
    assert _err(jvis.colorize(g), tvis.colorize(g)) <= 1.0 / 255
    ramp = np.linspace(-1.0, 2.0, 4001)[None]
    assert _err(jvis.colorize(ramp, vmin=0.0, vmax=1.0),
                tvis.colorize(ramp, vmin=0.0, vmax=1.0)) <= 1.0 / 255
