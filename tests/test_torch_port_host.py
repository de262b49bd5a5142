"""Host-side parity of the port with the JAX package, import hygiene and
the port's device policy.

* ``make_scene`` arrays are bitwise equal; ``estimate_essential`` gives
  identical R, t and inliers (the same C++ source, built by each package);
* the options of every ``configs/*.yaml`` resolve to the same dict;
* pose math, rays and projection agree to float32 rounding (1e-5);
* the optimizer reproduces the JAX Adam schedule, and ``guarded_update``
  skips non-finite steps and resets poisoned moments as the JAX one does;
* importing the whole port loads no ``jax*`` and no ``level_s2fm_tpu``
  module (checked in a fresh interpreter).
"""
import glob
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from level_s2fm_tpu import config as jconfig
from level_s2fm_tpu.data import synthetic as jsyn
from level_s2fm_tpu.geometry import lie as jlie
from level_s2fm_tpu.geometry import transforms as jT
from level_s2fm_tpu.sfm import hostgeom as jhg
from level_s2fm_tpu.sfm import optim as joptim
from level_s2fm_tpu.sfm import phases as jphases
from level_s2fm_tpu_torch import config as tconfig
from level_s2fm_tpu_torch import resolve_device
from level_s2fm_tpu_torch.data import synthetic as tsyn
from level_s2fm_tpu_torch.geometry import lie as tlie
from level_s2fm_tpu_torch.geometry import transforms as tT
from level_s2fm_tpu_torch.sfm import hostgeom as thg
from level_s2fm_tpu_torch.sfm import optim as toptim
from level_s2fm_tpu_torch.sfm import phases as tphases

from torch_port_helpers import use_jax_minigeom

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_make_scene_is_bitwise_equal():
    a = jsyn.make_scene(n_views=3, H=24, W=20, n_points=80, seed=5, noise_px=0.3)
    b = tsyn.make_scene(n_views=3, H=24, W=20, n_points=80, seed=5, noise_px=0.3)
    for k in ("images", "intrs", "poses_gt", "surface_pts"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    for x, y in zip(a.kypts, b.kypts):
        np.testing.assert_array_equal(x, y)
    for i in range(3):
        for x, y in zip(a.matches[i] + a.masks[i], b.matches[i] + b.masks[i]):
            np.testing.assert_array_equal(x, y)
    assert a.pose_graph == b.pose_graph
    assert sorted(tsyn.scene_to_var(b)) == sorted(jsyn.scene_to_var(a))


def test_estimate_essential_is_identical(monkeypatch):
    use_jax_minigeom(monkeypatch)      # the JAX side must not take its cv2 fallback
    s = tsyn.make_scene(n_views=2, H=64, W=64, n_points=128, seed=1, noise_px=0.5)
    m = s.matches[0][0]
    kp0, kp1 = s.kypts[0][m[:, 0]], s.kypts[1][m[:, 1]]
    a = jhg.estimate_essential(kp0, kp1, s.intrs[0])
    b = thg.estimate_essential(kp0, kp1, s.intrs[0])
    assert a.success and b.success
    np.testing.assert_array_equal(a.R, b.R)
    np.testing.assert_array_equal(a.t, b.t)
    np.testing.assert_array_equal(a.inliers, b.inliers)
    assert not thg.estimate_essential(kp0[:4], kp1[:4], s.intrs[0]).success


def test_minigeom_library_is_keyed_by_its_source(tmp_path, monkeypatch):
    """The port builds its own minigeom copy under ``_build/``, named by the
    hash of the source, so an edited source is never served a stale
    library."""
    from level_s2fm_tpu_torch.cpp import minigeom
    built = minigeom.build()
    assert os.path.dirname(built) == minigeom._BUILD_DIR
    assert built == minigeom._lib_path() and os.path.exists(built)
    edited = tmp_path / "minigeom.cpp"
    edited.write_bytes(open(minigeom._SOURCE, "rb").read() + b"// edited\n")
    monkeypatch.setattr(minigeom, "_SOURCE", str(edited))
    assert minigeom._lib_path() != built


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml"))))
def test_options_resolve_identically(path):
    argv = [f"--yaml={path}", "--optim.init.max_iter=7", "--Renderer.compact_samples!",
            "--data.image_size=[8,12]"]
    a = jconfig.to_plain(jconfig.build_options(argv))
    b = tconfig.to_plain(tconfig.build_options(argv))
    assert a == b
    opt = tconfig.build_options(argv)
    assert opt.deepcopy() == opt and opt.deepcopy() is not opt
    assert (opt.H, opt.W) == (8, 12)


@jax.jit
def _jax_geometry(wu, K, grid, pts):
    P = jlie.se3_to_SE3(wu)
    out = {"P": P, "log": jlie.SE3_to_se3(P), "inv": jlie.pose_invert(P),
           "comp": jlie.pose_compose_pair(P[2], P[3]),
           "rd": jlie.rotation_distance(P[2, :, :3], P[3, :, :3]),
           "ta": jlie.translation_angle_deg(P[2, :, 3], P[4, :, 3])}
    for ax in "XYZ":
        out[ax] = jlie.angle_to_rotation_matrix(jnp.asarray([0.3, -1.2]), ax)
    out["c"], out["r"] = jT.get_center_and_ray(P[2:4], K, grid)
    out["uv"], out["d"] = jT.project_points(pts, P[2][None], K[None])
    out["uvp"], out["zp"] = jphases.project_points_per(pts[0, :4], P[:4], K)
    return out


def test_lie_and_transforms_match_jax():
    rng = np.random.default_rng(0)
    wu = rng.normal(size=(6, 6)).astype(np.float32) * 0.7
    wu[0, :3] = 0.0                       # the small-angle branches
    wu[1, :3] = 1e-6
    K = np.asarray([[20.0, 0, 8], [0, 20.0, 8], [0, 0, 1]], np.float32)
    grid = tT.mesh_grid(6, 5).numpy()
    np.testing.assert_array_equal(grid, np.asarray(jT.mesh_grid(6, 5)))
    pts = rng.normal(size=(1, 30, 3)).astype(np.float32)
    j = {k: np.asarray(v) for k, v in _jax_geometry(wu, K, grid, pts).items()}

    tP = tlie.se3_to_SE3(torch.as_tensor(wu))
    close = lambda a, b, **kw: np.testing.assert_allclose(  # noqa: E731
        a.numpy() if isinstance(a, torch.Tensor) else a, b, **kw)
    close(tP, j["P"], atol=1e-5)
    close(tlie.SE3_to_se3(tP), j["log"], atol=1e-4)
    close(tlie.SE3_to_se3(tP)[2:], wu[2:], atol=1e-4)
    close(tlie.pose_invert(tP), j["inv"], atol=1e-5)
    close(tlie.pose_compose_pair(tP[2], tP[3]), j["comp"], atol=1e-5)
    for ax in "XYZ":
        close(tlie.angle_to_rotation_matrix(torch.tensor([0.3, -1.2]), ax), j[ax],
              atol=1e-6)
    close(tlie.rotation_distance(tP[2, :, :3], tP[3, :, :3]), j["rd"], atol=1e-5)
    close(tlie.translation_angle_deg(tP[2, :, 3], tP[4, :, 3]), j["ta"], atol=1e-3)
    tK, tpts = torch.as_tensor(K), torch.as_tensor(pts)
    tc, tr = tT.get_center_and_ray(tP[2:4], tK, torch.as_tensor(grid))
    close(tc, j["c"], atol=1e-5)
    close(tr, j["r"], atol=1e-5)
    tuv, td = tT.project_points(tpts, tP[2][None], tK[None])
    close(tuv, j["uv"], rtol=1e-4, atol=1e-3)
    close(td, j["d"], atol=1e-5)
    tuv, tz = tphases.project_points_per(tpts[0, :4], tP[:4], tK)
    close(tuv, j["uvp"], rtol=1e-4, atol=1e-3)
    close(tz, j["zp"], atol=1e-5)


def _tree(rng):
    return {"sdf": {"table": rng.normal(size=(2, 5, 2)).astype(np.float32),
                    "beta": rng.normal(size=(1,)).astype(np.float32)},
            "rad": {"w": rng.normal(size=(3, 4)).astype(np.float32)}}


def test_phase_adam_matches_the_jax_optimizer():
    """Per-label lr, the SDF gamma applied to both labels, bias correction:
    10 steps of the port's Adam == the JAX package's phase optimizer."""
    rng = np.random.default_rng(1)
    p0 = _tree(rng)
    grads = [_tree(rng) for _ in range(10)]
    gamma = joptim.decay_gamma(1e-3, 1e-4, 10)
    assert toptim.decay_gamma(1e-3, 1e-4, 10) == gamma
    tx = joptim.make_phase_optimizer(p0, {"sdf": "sdf", "rad": "color"},
                                     {"sdf": 1e-3, "color": 1e-2}, gamma)
    jp = jax.tree.map(jnp.asarray, p0)
    st = tx.init(jp)
    tp = {k: {n: torch.tensor(v) for n, v in d.items()} for k, d in p0.items()}
    opt = toptim.PhaseAdam(tp, {"sdf": "sdf", "rad": "color"},
                           {"sdf": 1e-3, "color": 1e-2}, gamma)
    upd = jax.jit(lambda g_, s_, p_: jphases.guarded_update(tx, g_, s_, p_))
    for g in grads:
        jg = jax.tree.map(jnp.asarray, g)
        jp, st, bad = upd(jg, st, jp)
        tbad = tphases.guarded_update(opt, [torch.tensor(x) for x in
                                            jax.tree.leaves(g)])
        assert float(bad) == float(tbad) == 0.0
    for a, b in zip(opt.leaves, jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)


def test_guarded_update_skips_and_sanitizes():
    p = {"sdf": {"x": torch.ones(4)}, "rad": {"y": torch.ones(3)}}
    opt = toptim.PhaseAdam(p, {"sdf": "sdf", "rad": "color"},
                           {"sdf": 0.1, "color": 0.1}, 1.0)
    assert opt.leaves[0] is p["rad"]["y"]          # sorted keys, as jax.tree
    ok = [torch.full((3,), 0.5), torch.full((4,), 0.5)]
    assert float(tphases.guarded_update(opt, ok)) == 0.0
    x1 = p["sdf"]["x"].clone()
    mu1 = [m.clone() for m in opt.mu]
    # a NaN gradient anywhere: no parameter moves, moments decay, count runs on
    bad = [torch.full((3,), 0.5), torch.tensor([0.5, float("nan"), 0.5, 0.5])]
    assert float(tphases.guarded_update(opt, bad)) == 1.0
    torch.testing.assert_close(p["sdf"]["x"], x1)
    torch.testing.assert_close(opt.mu[1], mu1[1] * 0.9)
    assert opt.count == 2
    # finite gradients but an overflowed (inf) moment: the update is
    # non-finite, the step is skipped and the moments are reset
    opt.mu[1].fill_(float("inf"))
    assert float(tphases.guarded_update(opt, ok)) == 1.0
    torch.testing.assert_close(p["sdf"]["x"], x1)
    assert all(torch.isfinite(m).all() for m in opt.mu + opt.nu)
    assert float(tphases.guarded_update(opt, ok)) == 0.0
    assert not torch.equal(p["sdf"]["x"], x1)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import level_s2fm_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import importlib.util\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k.startswith('jaxlib') or k == 'level_s2fm_tpu'\n"
        "             or k.startswith('level_s2fm_tpu.'))\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n"
        "n = sum(1 for k in sys.modules if k.startswith('level_s2fm_tpu_torch'))\n"
        "assert n >= 20, n\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_device_policy():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device()
        from level_s2fm_tpu_torch.sfm.pipeline import LevelSfM
        with pytest.raises(RuntimeError):
            LevelSfM(tconfig.build_options(["--yaml=configs/synthetic.yaml"]))
        from level_s2fm_tpu_torch.convert import params_from_jax
        with pytest.raises(RuntimeError):
            params_from_jax({"beta": np.ones(1, np.float32)})


def test_entry_registers_three_views():
    """The port's CLI entry runs registration past the two-view init:
    ``--max_views=3`` on the CPU at tiny widths registers three views."""
    from level_s2fm_tpu_torch import train
    from torch_port_helpers import TINY_ARGS
    m = train.main(TINY_ARGS + ["--cpu", "--max_views=3", "--data.n_views=3",
                                "--optim.geoinit.max_iter=1",
                                "--optim.ba.max_iter=4",
                                "--optim.refine.max_iter=2"])
    assert m.camera_set.cam_ids == [0, 1, 2]
    assert [r["view"] for r in m.view_log] == [2]
    assert np.isfinite(m.view_log[0]["reproj_px"])
