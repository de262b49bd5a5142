"""The port's scene loaders, PNG reader and area resize against the JAX
package's (which read through imageio and resize with OpenCV), and the
CLI entry's files (options.yaml, metrics.jsonl, the ``--get_result``
results).

Tolerances: images within 1e-6 (the port's area resize sums in float64,
OpenCV in float32: measured 6e-8 at 2x, 1.2e-7 at 968x1296 -> 333x443);
intrinsics and GT poses within 1e-6 (the port decomposes the projection
in float64, OpenCV takes the camera centre from a float32 SVD: measured
2.4e-7); keypoints, matches, masks, pose graphs and PNG pixels exact.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from level_s2fm_tpu.config import Opt as JOpt
from level_s2fm_tpu.config import build_options as jbuild
from level_s2fm_tpu.data import base as jbase
from level_s2fm_tpu.data import loaders as jl
from level_s2fm_tpu.data import synthetic as jsyn
from level_s2fm_tpu_torch.config import Opt as TOpt
from level_s2fm_tpu_torch.config import build_options as tbuild
from level_s2fm_tpu_torch.data import base as tbase
from level_s2fm_tpu_torch.data import loaders as tl
from level_s2fm_tpu_torch.utils import png

from torch_port_helpers import TINY_ARGS, jax_opt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-6


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _assert_same_var(a, b):
    assert set(a) == set(b)
    for k in ("images", "intrs", "poses_gt", "depth_gt"):
        if k in a:
            assert np.asarray(a[k]).shape == np.asarray(b[k]).shape, k
            assert _max_err(a[k], b[k]) <= TOL, (k, _max_err(a[k], b[k]))
    for k in ("matches", "masks", "kypts"):
        if k not in a:
            continue
        assert len(a[k]) == len(b[k]), k
        for x, y in zip(a[k], b[k]):
            if k == "kypts":
                assert np.array_equal(np.asarray(x), np.asarray(y)), k
            else:
                assert len(x) == len(y) and all(
                    np.array_equal(u, v) for u, v in zip(x, y)), k
    if "pose_graph" in a:
        assert [int(v) for v in a["pose_graph"]] == [int(v) for v in b["pose_graph"]]
    for k in ("factor_x", "factor_y"):
        if k in a:
            assert a[k] == b[k], k


@pytest.mark.parametrize("yaml_name", ["synthhard.yaml", "scannet_multiroom_synth.yaml"])
def test_prepared_scene_matches_jax(yaml_name):
    """The same YAML through both packages' ``load_prepared_scene``: the
    32-view DTU-layout synthhard scene (400 -> 200 px PNGs) and the
    ScanNet-layout multiroom scene (384 -> 192 px JPEGs, uint16 depth
    PNGs as ``depth_gt``)."""
    argv = ["--yaml=" + os.path.join(REPO, "configs", yaml_name)]
    a = jl.load_prepared_scene(jbuild(argv))
    b = tl.load_prepared_scene(tbuild(argv))
    _assert_same_var(a, b)
    if "scannet" in yaml_name:
        assert "depth_gt" in b and b["depth_gt"].dtype == np.float32


def test_png_reader_is_bitwise_imageio_on_scene_files():
    """Every PNG of data/synthhard/scan1 (Pillow-written RGB, all five
    filter types) and of data/scannet/multiroom0/depth (16-bit gray)."""
    import imageio.v2 as imageio
    dirs = [os.path.join(REPO, "data", "synthhard", "scan1", "images"),
            os.path.join(REPO, "data", "scannet", "multiroom0", "depth")]
    n = 0
    for d in dirs:
        for f in sorted(os.listdir(d)):
            if not f.endswith(".png"):
                continue
            a = png.read_png(os.path.join(d, f))
            b = imageio.imread(os.path.join(d, f))
            assert a.dtype == b.dtype and a.shape == b.shape, f
            assert np.array_equal(a, b), f
            n += 1
    assert n >= 32


@pytest.mark.parametrize("kind", ["gray8", "gray16", "rgb8", "rgba8"])
def test_png_reader_and_writer_kinds(tmp_path, kind):
    """PNGs written by imageio read back bitwise equal to imageio's read;
    the port's writer round-trips through both readers."""
    import imageio.v2 as imageio
    rng = np.random.default_rng(0)
    shape = {"gray8": (23, 17), "gray16": (23, 17), "rgb8": (19, 21, 3),
             "rgba8": (19, 21, 4)}[kind]
    dtype = np.uint16 if kind == "gray16" else np.uint8
    arr = rng.integers(0, np.iinfo(dtype).max, shape, dtype=dtype)
    arr[:5] = arr[0, 0]        # flat rows: encoders pick other filters there
    path = str(tmp_path / f"{kind}.png")
    imageio.imwrite(path, arr)
    a, b = png.read_png(path), imageio.imread(path)
    assert a.dtype == b.dtype and np.array_equal(a, b) and np.array_equal(a, arr)
    out = str(tmp_path / f"{kind}_port.png")
    png.write_png(out, arr)
    assert np.array_equal(imageio.imread(out), arr)
    assert np.array_equal(png.read_png(out), arr)


@pytest.mark.parametrize("src,dst", [((400, 400), (200, 200)),
                                     ((968, 1296), (333, 443))])
def test_area_resize_matches_opencv(src, dst):
    """2x (a box mean) and ScanNet's 968x1296 -> 333x443 (fractional
    cells), seeded float32 images in [0,1]."""
    import cv2
    x = np.random.default_rng(1).random((*src, 3)).astype(np.float32)
    ref = cv2.resize(x, (dst[1], dst[0]), interpolation=cv2.INTER_AREA)
    got = tbase.resize_area(x, dst)
    assert got.shape == ref.shape and got.dtype == np.float32
    assert _max_err(got, ref) <= TOL


def test_color_jitter_matches_jax():
    """All four jitter factors from the same seed; the port's HSV
    conversion reproduces OpenCV's float formulas (the JAX package calls
    cv2.cvtColor): within 1e-5 (hue is in degrees, 0..360)."""
    img = np.random.default_rng(2).random((12, 10, 3)).astype(np.float32)
    kw = dict(brightness=0.2, contrast=0.3, saturation=0.4, hue=0.1)
    a = jbase.color_jitter(img, np.random.default_rng(5), **kw)
    b = tbase.color_jitter(img, np.random.default_rng(5), **kw)
    assert _max_err(a, b) <= 1e-5


@pytest.fixture(scope="module")
def txt_root(tmp_path_factory):
    """Two txt-layout scenes: ETH3D (w2c pose files, ``.cam`` init poses
    for frames 0 and 1) and BlendedMVS (c2w pose files), 48x48 raw
    frames resized to 24x24."""
    import imageio.v2 as imageio
    root = tmp_path_factory.mktemp("txt_root")
    scene = jsyn.make_scene(n_views=3, H=48, W=48, n_points=64, seed=2)
    K4 = np.eye(4)
    K4[:3, :3] = scene.intrs[0]
    for name, file_is_w2c in (("bmvs", False), ("eth", True)):
        d = root / name
        (d / "images").mkdir(parents=True)
        (d / "pose").mkdir()
        np.savetxt(d / "intrinsics.txt", K4)
        for i in range(3):
            imageio.imwrite(d / "images" / f"{i:04d}.png",
                            (scene.images[i] * 255).astype(np.uint8))
            w2c = np.eye(4, dtype=np.float32)
            w2c[:3, :4] = scene.poses_gt[i]
            np.savetxt(d / "pose" / f"{i:04d}.txt",
                       w2c if file_is_w2c else np.linalg.inv(w2c))
    cams = root / "eth" / "cams"
    cams.mkdir()
    for i in range(2):
        R, t = scene.poses_gt[i][:, :3], scene.poses_gt[i][:, 3]
        (cams / f"{i:04d}.cam").write_text(
            " ".join(f"{v:.9f}" for v in list(t) + list(R.ravel())) + "\n0 0 0\n")
    return root


@pytest.mark.parametrize("dataset", ["ETH3D", "BlendedMVS"])
def test_txt_scene_matches_jax(txt_root, dataset):
    """ETH3D with ``.cam`` init poses (frame 2 dropped) and recentering;
    BlendedMVS with its white background lift."""
    d = {"root": str(txt_root), "dataset": dataset, "image_size": [24, 24],
         "raw_size": [48, 48], "scene": "eth" if dataset == "ETH3D" else "bmvs"}
    if dataset == "ETH3D":
        d.update(init=True, cam_dir=str(txt_root / "eth" / "cams"), center=True)
    a = jl.LOADERS[dataset](JOpt({"data": d, "rad": 2.5}))
    b = tl.LOADERS[dataset](TOpt({"data": d, "rad": 2.5}))
    _assert_same_var(a, b)
    assert len(b["images"]) == (2 if dataset == "ETH3D" else 3)


def test_non_png_formats_need_an_image_library(tmp_path, monkeypatch):
    """Without Pillow and imageio a JPEG raises an ImportError that names
    the format; a PNG still reads."""
    arr = np.zeros((4, 5, 3), np.uint8)
    png.write_png(str(tmp_path / "a.png"), arr)
    (tmp_path / "a.jpg").write_bytes(b"\xff\xd8\xff")
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    with pytest.raises(ImportError, match=r"\.jpg"):
        tbase.imread(str(tmp_path / "a.jpg"))
    assert np.array_equal(tbase.imread(str(tmp_path / "a.png")), arr)


def test_port_modules_import_no_image_or_plot_library():
    """Every module of the port imports without matplotlib, Pillow,
    imageio, OpenCV or the preparation scripts: those are imported inside
    the functions that need them (the GPU machine has no imageio and no
    matplotlib)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import level_s2fm_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('matplotlib', 'PIL', 'imageio', 'cv2', 'preparation'))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_cli_writes_options_metrics_and_results(tmp_path, monkeypatch):
    """``python -m level_s2fm_tpu_torch.train --cpu`` at tiny widths: its
    options.yaml is the JAX package's text for the same argv, its
    metrics.jsonl rows carry the JAX package's keys, and then
    ``--get_result --refine_again`` (the same ``main``, called in this
    process) writes every result file."""
    from level_s2fm_tpu.config import save_options_file
    out = tmp_path / "run"
    argv = TINY_ARGS + ["--data.n_views=3", "--optim.geoinit.max_iter=1",
                        "--optim.ba.max_iter=4", "--optim.refine.max_iter=2",
                        f"--output_path={out}", "--freq.vis=0"]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")

    def cli(extra):
        p = subprocess.run([sys.executable, "-m", "level_s2fm_tpu_torch.train",
                            "--cpu", *argv, *extra], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=300)
        assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]

    cli(["--max_views=3"])
    text = (out / "options.yaml").read_text()
    jopt = jax_opt(argv[len(TINY_ARGS):] + ["--cpu", "--max_views=3"])
    jopt.output_path = str(tmp_path / "jax")
    os.makedirs(jopt.output_path)
    save_options_file(jopt)
    jtext = (tmp_path / "jax" / "options.yaml").read_text()
    assert text == jtext.replace(str(tmp_path / "jax"), str(out))
    rows = [json.loads(l) for l in (out / "metrics.jsonl").read_text().splitlines()]
    view_rows = [r for r in rows if "view" in r]
    assert [r["view"] for r in view_rows] == [2]
    assert set(view_rows[0]) == {"step", "t", "view", "n_cams", "n_points",
                                 "reproj_px", "rot_err_deg", "t_err", "ate"}

    # the second invocation in this process (the same entry, ``main``),
    # with the export's mesh at resolution 24 instead of 256
    import functools
    from level_s2fm_tpu_torch import train
    from level_s2fm_tpu_torch.utils import export as texp
    monkeypatch.setattr(texp, "export_results",
                        functools.partial(texp.export_results, resolution=24))
    train.main(["--cpu", *argv, "--get_result", "--refine_again",
                "--refine_again_iters=3"])
    for rel in ("model.ckpt", "pointcloud.ply", "cameras.json", "mesh/high_res.ply",
                "sparse/0/cameras.bin", "sparse/0/images.bin",
                "sparse/0/points3D.bin", "viewer.html", "render_cam0.png"):
        assert (out / rel).stat().st_size > 0, rel
    assert png.read_png(str(out / "render_cam0.png")).shape == (16, 16, 3)


@pytest.mark.parametrize("yaml_name,value,cards,world", [
    ("scannet_multiroom", "2", 1, None), ("scannet_multiroom", None, 2, 2),
    ("scannet_multiroom", None, 1, 1), ("scannet_multiroom", "1", 8, 1),
    ("synthetic", None, 8, 1)])
def test_data_devices_beyond_one_are_refused(yaml_name, value, cards, world,
                                             tmp_path, monkeypatch):
    """``parallel.data_devices`` as ``train.data_devices`` resolves it:
    asking for more GPUs than are visible raises before any data is
    loaded or any file written (``world`` None); ``all``
    (configs/scannet_multiroom.yaml) is one rank per visible GPU, over
    NCCL; empty (configs/base.yaml), 1, and ``all`` on one card are one
    rank with no process group."""
    import torch
    from level_s2fm_tpu_torch import train
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    out = tmp_path / "run"
    argv = [f"--yaml=configs/{yaml_name}.yaml", f"--output_path={out}"]
    if value is not None:
        argv.append(f"--parallel.data_devices={value}")
    opt = tbuild(argv)
    expect = value or ("all" if yaml_name == "scannet_multiroom" else None)
    got = opt.parallel.data_devices
    assert (str(got) if got is not None else None) == expect
    if world is None:
        monkeypatch.setattr(train, "build_var", lambda o: pytest.fail("data loaded"))
        with pytest.raises(ValueError, match="parallel.data_devices"):
            train.main(argv)
        assert not out.exists()
        # under --cpu the same value is that many gloo ranks on the CPU
        assert train.data_devices(tbuild(argv + ["--cpu"])) == ["cpu"] * int(value)
        return
    devices = train.data_devices(opt)
    if world == 1:
        assert devices is None
    else:
        assert devices == [f"cuda:{i}" for i in range(world)]
        from level_s2fm_tpu_torch.parallel import distributed as pdist
        assert pdist.default_backend(devices) == "nccl"
    # `all` under --cpu is the one CPU
    assert train.data_devices(tbuild(argv + ["--cpu"])) is None
