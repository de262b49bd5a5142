"""The port's hard and multiroom scene generators and its dataset writer
against the JAX package, bitwise (both are numpy, so every array must be
equal, not close).

* ``hard_scene_sdf`` / ``multiroom_sdf`` on 4,096 seeded points;
* ``render_hard_view`` / ``render_multiroom_view`` at 48x48, two poses
  each (images and depths);
* ``make_hard_scene_images`` / ``make_multiroom_scene`` at 3 views, 32x32,
  and their cameras alone (``hard_scene_cameras`` / ``multiroom_cameras``);
* ``python -m level_s2fm_tpu_torch.make_synthetic_dataset`` (its ``main``,
  in this process) against ``scripts/make_synthetic_dataset.py`` (run by
  ``runpy``) for every preset at 3 views, 32 px: the same files, equal
  decoded images and depths, equal ``cameras.npz`` and pose / intrinsic
  texts.

The committed full-size scenes are held on the card by ``chip_smoke.py``
phase ``scenes``.
"""
import os
import runpy
import sys

import numpy as np
import pytest

from level_s2fm_tpu.data import synthetic as jsyn
from level_s2fm_tpu_torch import make_synthetic_dataset as tmake
from level_s2fm_tpu_torch.data import synthetic as tsyn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _points(seed, lo, hi):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, size=(4096, 3))


@pytest.mark.parametrize("name,lo,hi", [("hard_scene_sdf", -1.0, 1.0),
                                        ("multiroom_sdf", (-3.6, -1.7, -2.4),
                                         (3.6, 1.7, 2.4))])
def test_scene_sdfs_are_bitwise_equal(name, lo, hi):
    p = _points(7, np.asarray(lo), np.asarray(hi))
    (jd, jid), (td, tid) = getattr(jsyn, name)(p), getattr(tsyn, name)(p)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tid, jid)
    assert len(np.unique(tid)) > 3          # several surfaces are nearest


def _K(size, f):
    return np.asarray([[f * size, 0, size / 2], [0, f * size, size / 2],
                       [0, 0, 1]], np.float32)


def test_render_hard_view_is_bitwise_equal():
    _, intrs, poses = jsyn.make_hard_scene_images(n_views=8, H=4, W=4)
    K, tposes = tsyn.hard_scene_cameras(n_views=8, H=4, W=4)
    np.testing.assert_array_equal(K, intrs[0])
    np.testing.assert_array_equal(tposes, poses)
    for pose in poses[[0, 5]]:
        a = jsyn.render_hard_view(pose, _K(48, 0.9), 48, 48)
        b = tsyn.render_hard_view(pose, _K(48, 0.9), 48, 48)
        assert b.dtype == np.float32 and b.shape == (48, 48, 3)
        np.testing.assert_array_equal(b, a)
        assert (b.max(-1) > 0).mean() > 0.2      # objects are in view


def test_render_multiroom_view_is_bitwise_equal():
    _, _, intrs, poses = jsyn.make_multiroom_scene(n_views=6, H=4, W=4)
    K, tposes = tsyn.multiroom_cameras(n_views=6, H=4, W=4)
    np.testing.assert_array_equal(K, intrs[0])
    np.testing.assert_array_equal(tposes, poses)
    for pose in poses[[0, 4]]:
        a_img, a_dep = jsyn.render_multiroom_view(pose, _K(48, 0.75), 48, 48)
        b_img, b_dep = tsyn.render_multiroom_view(pose, _K(48, 0.75), 48, 48)
        np.testing.assert_array_equal(b_img, a_img)
        np.testing.assert_array_equal(b_dep, a_dep)
        assert (b_dep > 0).mean() > 0.9          # indoor: almost every ray hits


def test_scene_makers_are_bitwise_equal():
    for a, b in zip(jsyn.make_hard_scene_images(n_views=3, H=32, W=32),
                    tsyn.make_hard_scene_images(n_views=3, H=32, W=32)):
        np.testing.assert_array_equal(b, a)
    for a, b in zip(jsyn.make_multiroom_scene(n_views=3, H=32, W=32),
                    tsyn.make_multiroom_scene(n_views=3, H=32, W=32)):
        np.testing.assert_array_equal(b, a)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("preset", ["sphere", "multi", "multiroom"])
def test_dataset_writer_matches_the_script(preset, tmp_path, monkeypatch, capsys):
    import imageio.v2 as imageio     # the script writes through it; the GPU machine lacks it
    args = ["--scene", "s", "--views", "3", "--size", "32", "--preset", preset]
    monkeypatch.setattr(sys, "path", list(sys.path))   # the script prepends REPO
    monkeypatch.setattr(sys, "argv", ["make_synthetic_dataset.py", "--out",
                                      str(tmp_path / "jax")] + args)
    runpy.run_path(os.path.join(REPO, "scripts", "make_synthetic_dataset.py"),
                   run_name="__main__")
    jout = capsys.readouterr().out
    tmake.main(["--out", str(tmp_path / "port")] + args)
    tout = capsys.readouterr().out
    ja, tb = tmp_path / "jax" / "s", tmp_path / "port" / "s"
    files = _files(ja)
    assert _files(tb) == files and len(files) == (10 if preset == "multiroom" else 4)
    for rel in files:
        a, b = str(ja / rel), str(tb / rel)
        if rel.endswith((".png", ".jpg")):
            # JPEGs: both written by imageio at quality 95 from equal arrays
            x, y = imageio.imread(a), imageio.imread(b)
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(y, x)
        elif rel.endswith(".npz"):
            with np.load(a) as x, np.load(b) as y:
                assert sorted(x.files) == sorted(y.files)
                for k in x.files:
                    np.testing.assert_array_equal(y[k], x[k])
        else:
            assert open(b).read() == open(a).read(), rel
    # the same report lines, the render time and the output root aside
    def strip(text, root):
        return [ln.replace(str(root), "OUT") for ln in text.splitlines()
                if not ln.startswith("rendered")]
    assert strip(tout, tmp_path / "port") == strip(jout, tmp_path / "jax")
    if preset != "multiroom":
        assert "rad_init" in tout
