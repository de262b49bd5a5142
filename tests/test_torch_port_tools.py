"""The port's three tool modules against the JAX package's scripts, on the
CPU at small widths: the frontier-PnP diagnosis
(``level_s2fm_tpu_torch.diag_frontier_pnp``), the adaptive-sampler A/B
(``ab_adaptive_sampler``) and the two-view demo (``two_view_init_demo``).

Tolerances. The diagnosis counts are integers from the same minigeom
RANSAC on the same pairs: equal. The A/B losses: both sides render in
float32 from the same parameters and pixels, so step 0 agrees to 1e-5
relative; after an Adam step, hash-table entries whose gradient is
rounding noise move by up to the learning rate either way (as in
``test_torch_port_slice.py``), so later steps and the held-out PSNR are
held to 1e-3 relative. The adaptive arm is held at step 0 only: its
far-bound gradient is rounding noise in both packages (ROADMAP Queue 3),
so its Adam steps part at once.
"""
import ast
import io
import os
import runpy
import sys
import types
from contextlib import redirect_stdout

import numpy as np
import pytest

from torch_port_helpers import TINY_ARGS, use_jax_minigeom

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the run the diagnosis reads: 5 views of 16x16, 3 registered
RUN_ARGS = TINY_ARGS + ["--data.n_views=5", "--optim.geoinit.max_iter=1",
                        "--optim.ba.max_iter=4", "--sfm_mode=fast", "--freq.vis=0"]
AB = dict(steps=2, rays=64, hw=16)
#: the A/B's and the demo's hash grid and MLPs cut to the test widths
#: (their own are configs/levels2fm.yaml's: 16 levels x 2^19 rows)
SMALL = {"n_levels": 4, "log2_hashmap_size": 13}
DEMO_ARGS = ["--SDF.Hash_config.n_levels=4", "--SDF.Hash_config.log2_hashmap_size=13",
             "--SDF.arch.layers=[null,16,8]", "--RadF.arch.layers=[null,16,16,3]",
             "--SDF.VolSDF.sample_intvs=16", "--SDF.VolSDF.iters_max_st=10",
             "--Renderer.rand_rays=512", "--Renderer.compact_samples=8",
             "--Renderer.occ_res=16"]


def script_ab(path=os.path.join(REPO, "scripts", "ab_adaptive_sampler.py")):
    """What an A/B script fixes, read from its source: (its options for
    an arm as a function of (mode, H, W, rays), its arms, its flags'
    defaults). The JAX side of the tests builds from these, and
    ``test_ab_options_arms_and_flags_are_the_scripts`` holds the port's
    module to them."""
    with open(path) as f:
        src = f.read()
    tree = ast.parse(src)
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)]
    opt_src = ast.get_source_segment(src, next(
        n.args[0] for n in calls if getattr(n.func, "id", None) == "Opt"))
    arms = next((ast.literal_eval(n.iter) for n in ast.walk(tree)
                 if isinstance(n, ast.For) and getattr(n.target, "id", None) == "mode"
                 and isinstance(n.iter, ast.Tuple)), None)
    flags = {n.args[0].value: ast.literal_eval(k.value) for n in calls
             if getattr(n.func, "attr", None) == "add_argument"
             for k in n.keywords if k.arg == "default"}

    def opt(mode, H, W, rays):
        return eval(opt_src, {"mode": mode, "H": H, "W": W,
                              "args": types.SimpleNamespace(rays=rays)})
    return opt, arms, flags


@pytest.fixture
def small_ab(monkeypatch):
    """The A/B's options with the test's hash grid, on both sides."""
    from level_s2fm_tpu_torch import ab_adaptive_sampler as tab
    full = tab.ab_opt

    def ab_opt(*a, **k):
        opt = full(*a, **k)
        opt.SDF.Hash_config.update(SMALL)
        return opt
    monkeypatch.setattr(tab, "ab_opt", ab_opt)
    return tab


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A port-written v3 checkpoint of 3 registered views of 5."""
    from level_s2fm_tpu_torch import train
    out = str(tmp_path_factory.mktemp("diag") / "run")
    train.main(["--cpu", *RUN_ARGS, "--max_views=3", f"--output_path={out}"])
    return out


def _jax_diag(run_dir, overrides, monkeypatch):
    use_jax_minigeom(monkeypatch)
    ns = runpy.run_path(os.path.join(REPO, "scripts", "diag_frontier_pnp.py"))
    monkeypatch.setattr(sys, "argv", ["diag_frontier_pnp.py", run_dir, *overrides])
    buf = io.StringIO()
    with redirect_stdout(buf):
        ns["main"]()
    return buf.getvalue()


def test_diag_rows_match_the_jax_script(run_dir, monkeypatch):
    from level_s2fm_tpu_torch import diag_frontier_pnp as diag
    want = _jax_diag(run_dir, RUN_ARGS, monkeypatch).splitlines()
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert diag.main([run_dir, "--cpu", *RUN_ARGS]) == 0
    got = buf.getvalue().splitlines()
    assert got[:2] == ["registered cams: [0, 1, 2]", "unregistered: [3, 4]"]
    jax_lines = [line for line in want if line.split()[:1] in (["registered"], ["unregistered:"],
                                                               ["view"], ["3"], ["4"])]
    assert got == jax_lines, (got, want)
    rows = [list(map(int, line.split())) for line in got[3:]]
    assert all(r[1] >= r[2] >= max(r[3:]) for r in rows), rows


def test_diag_gate_under_ba_trad_passes_every_pair(run_dir):
    """Under ``ba_trad`` the pipeline's gate is 5000: every pair passes."""
    from level_s2fm_tpu_torch import diag_frontier_pnp as diag
    plain = diag.sweep(run_dir, ["--cpu", *RUN_ARGS])
    trad = diag.sweep(run_dir, ["--cpu", *RUN_ARGS, "--Ablate_config.ba_trad"])
    assert plain["sdf_gate"] == 0.05 and trad["sdf_gate"] == 5000.0
    assert [r["view"] for r in trad["rows"]] == [3, 4]
    for r in trad["rows"]:
        assert r["pairs"] > 0 and r["gated"] == r["pairs"], r


def _jax_ab(params_np):
    """The JAX script's loss path (``scripts/ab_adaptive_sampler.py``,
    its arms, draws and jitted Adam step) from injected parameters, with
    the occupancy grid's SDF and the held-out render jitted too (the
    script runs them op by op, which compiles every op here). The
    adaptive arm gives its step-0 loss only (see the module's note):
    {mode: (losses, psnr or None)}."""
    import dataclasses
    import functools
    import jax
    import jax.numpy as jnp
    import optax
    from level_s2fm_tpu.config import Opt
    from level_s2fm_tpu.data import synthetic
    from level_s2fm_tpu.fields import radiance as radf, sdf as sdf_mod
    from level_s2fm_tpu.geometry import transforms as T
    from level_s2fm_tpu.rendering import raymarch as rm, renderer as ren_mod

    script_opt, arms, _ = script_ab()
    H = W = AB["hw"]
    scene = synthetic.make_scene(n_views=4, H=H, W=W, n_points=64, seed=0, detail=0.35)

    def build(mode):
        opt = script_opt(mode, H, W, AB["rays"])
        opt["SDF"]["Hash_config"].update(SMALL)
        opt = Opt(opt)
        ren_cfg = ren_mod.config_from_opt(opt)
        if mode == "uniform128+occ32":
            ren_cfg = dataclasses.replace(ren_cfg, compact_samples=32)
        return sdf_mod.config_from_opt(opt), radf.config_from_opt(opt), ren_cfg

    grid = np.asarray(T.mesh_grid(H, W))

    def rays_for(view, pix):
        c, r = T.get_center_and_ray(jnp.asarray(scene.poses_gt[view])[None],
                                    jnp.asarray(scene.intrs[view]), jnp.asarray(grid[pix]))
        return c, r

    @functools.partial(jax.jit, static_argnums=(1, 2, 3))
    def render_rgb(p, sdf_cfg, rad_cfg, ren_cfg, c, r):
        return ren_mod.render(p["sdf"], sdf_cfg, p["rad"], rad_cfg, ren_cfg, c, r)["rgb"]

    rng = np.random.default_rng(0)
    out = {}
    for mode in arms:
        sdf_cfg, rad_cfg, ren_cfg = build(mode)
        params = jax.tree.map(jnp.asarray, params_np)
        occ = None
        if ren_cfg.compact_samples is not None:
            occ = rm.build_occupancy_grid(
                jax.jit(lambda p: sdf_mod.infer_sdf(params["sdf"], sdf_cfg, p)),
                jnp.zeros(3), jnp.ones(3), resolution=64, threshold=0.25, one_sided=True)
        opt_x = optax.adam(1e-3)

        def loss_fn(p, center, ray, rgb_gt):
            o = ren_mod.render(p["sdf"], sdf_cfg, p["rad"], rad_cfg, ren_cfg,
                               center, ray, occ_grid=occ)
            n = jnp.linalg.norm(o["normals"], axis=-1)
            return jnp.mean(jnp.abs(o["rgb"] - rgb_gt)) + 0.01 * jnp.mean(jnp.abs(n - 1.0))

        @jax.jit
        def step(p, st, center, ray, rgb_gt):
            l, g = jax.value_and_grad(loss_fn)(p, center, ray, rgb_gt)
            up, st = opt_x.update(g, st)
            return optax.apply_updates(p, up), st, l

        batches = []
        for _ in range(AB["steps"]):
            view = int(rng.integers(0, 3))
            pix = rng.integers(0, H * W, size=AB["rays"])
            batches.append((*rays_for(view, pix),
                            jnp.asarray(scene.images[view].reshape(-1, 3)[pix])[None]))
        if mode == "adaptive":
            out[mode] = ([float(jax.jit(loss_fn)(params, *batches[0]))], None)
            continue
        st, losses = opt_x.init(params), []
        for b in batches:
            params, st, l = step(params, st, *b)
            losses.append(float(l))
        _, _, eval_cfg = build("uniform128")
        est = np.asarray(render_rgb(params, sdf_cfg, rad_cfg, eval_cfg,
                                    *rays_for(3, np.arange(H * W)))[0]).reshape(H, W, 3)
        gt_img = scene.images[3]
        fg = np.any(gt_img > 0.02, axis=-1)
        out[mode] = (losses, -10 * np.log10(float(np.mean((est[fg] - gt_img[fg]) ** 2))))
    return out
