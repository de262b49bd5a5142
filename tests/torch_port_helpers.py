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


def visible_params(opt, seed=0, scale=0.05):
    """The JAX package's parameters with visible hash tables and
    first-layer weights on their hash features (the geometric init
    zeroes those weights, which makes the table gradient zero)."""
    p = perturb_table(jax_params_np(opt), seed=seed, scale=scale)
    rng = np.random.default_rng(seed + 1)
    for tree in [p["sdf"]["mlp"]] + ([p["rad"]["geo_mlp"]] if "geo_mlp" in p["rad"] else []):
        V = tree["layers"][0]["V"]
        tree["layers"][0]["V"] = (V + scale * rng.standard_normal(V.shape)).astype(np.float32)
    if "table" in p["rad"]:
        t = p["rad"]["table"]
        p["rad"]["table"] = (t + scale * rng.standard_normal(t.shape)).astype(np.float32)
    return p




def field_cfgs(opt, port=False):
    """(sdf, radiance, renderer) configs of either package from ``opt``."""
    if port:
        from level_s2fm_tpu_torch.fields import radiance as radf, sdf
        from level_s2fm_tpu_torch.rendering import renderer as ren
    else:
        from level_s2fm_tpu.fields import radiance as radf, sdf
        from level_s2fm_tpu.rendering import renderer as ren
    return sdf.config_from_opt(opt), radf.config_from_opt(opt), ren.config_from_opt(opt)


def sphere_rays(n=48, seed=0):
    """``n`` rays [1,n,3] from (0,0,-2) towards the sphere at the origin."""
    rng = np.random.default_rng(seed)
    o = np.tile(np.float32([0.0, 0.0, -2.0]), (1, n, 1))
    d = np.concatenate([rng.uniform(-0.3, 0.3, (1, n, 2)), np.ones((1, n, 1))], -1)
    return o, d.astype(np.float32)


def render_both(extra, o, d):
    """The compacted render of both packages from the same parameters
    (``visible_params``) and occupancy grid, and the gradients of a loss
    over rgb, depth and normals w.r.t. every field parameter. Returns
    (jax output, jax gradients, port output, {id(port leaf): gradient},
    port parameters)."""
    import jax
    import jax.numpy as jnp
    from level_s2fm_tpu.rendering import raymarch as jrm
    from level_s2fm_tpu.rendering import renderer as jren
    from level_s2fm_tpu_torch.convert import params_from_jax
    from level_s2fm_tpu_torch.rendering import renderer as tren
    from level_s2fm_tpu_torch.sfm import bundle as tbundle
    from level_s2fm_tpu_torch.sfm import optim as toptim
    from level_s2fm_tpu_torch.sfm.phases import PhaseCfgs
    jopt, topt = jax_opt(extra), torch_opt(extra)
    jc, tc = field_cfgs(jopt), field_cfgs(topt, port=True)
    pnp = visible_params(jopt)
    tp = params_from_jax(pnp, device="cpu")
    occ = tbundle.maybe_build_occ(
        topt, PhaseCfgs(sdf=tc[0], rad=tc[1], ren=tc[2], H=16, W=16), tp)
    jocc = jrm.OccupancyGrid(occ=jnp.asarray(occ.occ.numpy()),
                             center=jnp.asarray(occ.center.numpy()),
                             half_size=jnp.asarray(occ.half_size.numpy()))

    def jloss(p):
        out = jren.render(p["sdf"], jc[0], p["rad"], jc[1], jc[2], o, d, occ_grid=jocc)
        return (out["rgb"].sum() + out["depth_mlp"].sum()
                + jnp.linalg.norm(out["normals"], axis=-1).sum()), out

    (_, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, pnp))
    leaves = toptim.tree_leaves(tp)
    for x in leaves:
        x.requires_grad_(True)
    tout = tren.render(tp["sdf"], tc[0], tp["rad"], tc[1], tc[2], torch.as_tensor(o),
                       torch.as_tensor(d), occ_grid=occ)
    loss = (tout["rgb"].sum() + tout["depth_mlp"].sum()
            + torch.linalg.norm(tout["normals"], dim=-1).sum())
    tg = torch.autograd.grad(loss, leaves, allow_unused=True)
    return jout, jg, tout, dict(zip([id(x) for x in leaves], tg)), tp


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


def use_jax_minigeom(monkeypatch, timeout_s=30.0):
    """Make the JAX package's host geometry answer from its minigeom
    library, as it does whenever the library loads at import.

    ``level_s2fm_tpu.sfm.hostgeom`` decides once, at import, between
    minigeom and its OpenCV fallback. Under ``pytest -n`` several workers
    import it while another one's g++ (``cpp/minigeom.py::_try_build``,
    ``tests/test_minigeom.py``) writes ``libminigeom.so`` in place; a
    worker that loads the half-written file silently takes the fallback,
    and a bitwise comparison with the port (which always uses minigeom)
    then fails. This loads the library, retrying for up to ``timeout_s``
    while a build finishes, and sets ``_HAS_MINIGEOM`` through
    ``monkeypatch``. If the library cannot be loaded the test fails
    saying so: it never compares against the fallback."""
    import time
    import pytest
    from level_s2fm_tpu.cpp import minigeom as jmg
    from level_s2fm_tpu.sfm import hostgeom as jhg
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            if jmg._load() is not None:
                break
            why = "the library is missing and its build failed"
        except OSError as e:        # a file another process is still writing
            jmg._LIB = None
            why = str(e)
        if time.monotonic() > deadline:
            pytest.fail(f"the JAX package's minigeom library did not load within "
                        f"{timeout_s:.0f} s ({why}); its host geometry would "
                        "answer from the OpenCV fallback")
        time.sleep(0.5)
    monkeypatch.setattr(jhg, "_mg", jmg, raising=False)
    monkeypatch.setattr(jhg, "_HAS_MINIGEOM", True)


def jit_jax_occ(monkeypatch=None):
    """The JAX package's ``bundle.maybe_build_occ`` under one ``jax.jit``
    per configuration. The package builds the occupancy grid op by op,
    which compiles each op of the SDF on first use (a few seconds a
    test file); jitted it is one compile. With ``monkeypatch`` the
    package's phases (``run_phase_occ_refresh``) take it too. Returns
    the jitted builder."""
    import jax
    from level_s2fm_tpu.sfm import bundle as jbundle
    plain = jbundle.maybe_build_occ
    jitted = {}

    def occ(opt, cfgs, params):
        if id(cfgs) not in jitted:
            jitted[id(cfgs)] = (cfgs, jax.jit(lambda p: plain(opt, cfgs, p)))
        return jitted[id(cfgs)][1](params)
    if monkeypatch is not None:
        monkeypatch.setattr(jbundle, "maybe_build_occ", occ)
    return occ


def two_view_state(n_views=3, extra=(), *, monkeypatch):
    """The JAX package's two-view start of the tiny configuration on an
    ``n_views`` scene, and the port's engine given the same state by
    ``copy_scene``. Returns (jax engine, port engine).

    The JAX ``Initializer`` bootstraps the two poses (5-point RANSAC)
    and triangulates the keypoints by sphere tracing; its field fitting
    (``InitPhase``, held to the port by ``test_torch_port_slice.py``) is
    skipped, since compiling it would take most of a test file's time
    budget. Instead the hash table gets visible features
    (``perturb_table``), so the table's contribution and gradient are
    exercised. The JAX side's RANSAC runs on minigeom
    (``use_jax_minigeom`` on ``monkeypatch``, which the caller keeps
    open while it compares the two engines)."""
    import jax
    import jax.numpy as jnp
    from level_s2fm_tpu.sfm import initialization as jinit
    from level_s2fm_tpu.sfm import pipeline as jpipe
    from level_s2fm_tpu_torch.sfm import pipeline as tpipe
    use_jax_minigeom(monkeypatch)
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


def dlt_scene(n_views=3, size=16, n_points=64, noise=0.01, seed=0):
    """Camera and point sets of the synthetic scene, built alike in both
    packages without running a phase: the cameras at their GT poses
    (se3 with ``noise`` added), the points DLT-triangulated from the
    GT poses of views 0 and 1 (then moved by ``noise``), and every later
    view's matches with view 0 joined to those points' tracks.
    Returns (var, jax (CameraSet, PointSet), port (CameraSet, PointSet))."""
    from level_s2fm_tpu.sfm import entities as jent
    from level_s2fm_tpu_torch.data import synthetic as tsyn
    from level_s2fm_tpu_torch.geometry import lie as tlie
    from level_s2fm_tpu_torch.sfm import entities as tent
    from level_s2fm_tpu_torch.sfm import hostgeom as thg
    var = tsyn.scene_to_var(tsyn.make_scene(n_views=n_views, H=size, W=size,
                                            n_points=n_points, seed=seed))
    rng = np.random.default_rng(seed + 1)
    se3 = [tlie.SE3_to_se3(torch.as_tensor(np.asarray(p, np.float32))[None])[0].numpy()
           + noise * rng.standard_normal(6).astype(np.float32)
           for p in var["poses_gt"][:n_views]]
    cams = [tent.Camera(id=i, img=np.asarray(var["images"][i], np.float32),
                        intr=np.asarray(var["intrs"][i], np.float32),
                        pose_gt=np.asarray(var["poses_gt"][i], np.float32),
                        kypts=np.asarray(var["kypts"][i], np.float32),
                        matches=var["matches"][i], inlier_masks=var["masks"][i],
                        se3=se3[i]) for i in range(n_views)]
    k0, k1 = cams[0].matched_kypt_ids(1)
    P = [c.intr @ np.asarray(c.pose_gt, np.float64) for c in cams[:2]]
    X = thg.triangulate_dlt(cams[0].kypts[k0], cams[1].kypts[k1], P[0], P[1])
    X = (X + noise * rng.standard_normal(X.shape)).astype(np.float32)
    tracks = [[(0, int(a)), (1, int(b))] for a, b in zip(k0, k1)]
    cams[0].idx2d_to_3d[k0] = np.arange(len(k0))
    cams[1].idx2d_to_3d[k1] = np.arange(len(k0))
    for v in range(2, n_views):
        a0, av = cams[0].matched_kypt_ids(v)
        for a, b in zip(a0, av):
            pid = cams[0].idx2d_to_3d[a]
            if pid >= 0:
                tracks[pid].append((v, int(b)))
                cams[v].idx2d_to_3d[b] = pid
    out = []
    for ent in (jent, tent):
        cs, ps = ent.CameraSet(), ent.PointSet()
        for c in cams:
            cs.add(ent.Camera(id=c.id, img=c.img, intr=c.intr, pose_gt=c.pose_gt,
                              kypts=c.kypts, matches=c.matches,
                              inlier_masks=c.inlier_masks, se3=c.se3.copy(),
                              idx2d_to_3d=c.idx2d_to_3d.copy()))
        ps.add_points(X.copy(), [list(t) for t in tracks])
        out.append((cs, ps))
    return var, out[0], out[1]
