"""The depth evaluation and the export's files in the port against the
JAX package, on the CPU (see ``test_torch_port_export.py``, which also
holds ``colorize``). Kept to two tests so that it runs after the suite's
long files have started: pytest-xdist's loadfile queue starts the files
with more tests first.
"""
import json

import numpy as np

from level_s2fm_tpu.utils import export as jexp
from level_s2fm_tpu.viz import html_viewer as jhtml
from level_s2fm_tpu_torch.utils import export as texp
from level_s2fm_tpu_torch.viz import html_viewer as thtml

from test_torch_port_export import (  # noqa: F401
    _err, _jit_jax_trace, _parse_floats, scene)


def test_eval_depth_vs_gt_matches_jax(scene):
    """Three cameras (the Procrustes scale path); GT depth maps at 8x8
    with a row unmeasured, nearest-resampled to the 16x16 grid (factor 1:
    the traces have the previous test's shape, so the JAX side compiles
    nothing new)."""
    jm, tm = scene
    rng = np.random.default_rng(1)
    gt = rng.uniform(0.5, 3.0, (3, 8, 8)).astype(np.float32)
    gt[:, 0, :] = 0.0
    a = jexp.eval_depth_vs_gt(jm.params, jm.sdf_cfg, jm.camera_set, gt, factor=1,
                              verbose=False)
    b = texp.eval_depth_vs_gt(tm.params, tm.sdf_cfg, tm.camera_set, gt, factor=1,
                              verbose=False)
    assert a["n_px"] == b["n_px"] > 0
    for k in ("abs_rel", "rmse"):
        assert abs(a[k] - b[k]) <= 1e-5, (k, a[k], b[k])
    assert set(a["per_view"]) == set(b["per_view"])


def test_export_files_match_jax(scene, tmp_path):
    """Point cloud, cameras JSON, COLMAP text model and viewer page."""
    jm, tm = scene
    jd, td = tmp_path / "j", tmp_path / "t"
    for d, exp, m in ((jd, jexp, jm), (td, texp, tm)):
        exp.export_pointcloud(m.point_set, str(d / "pointcloud.ply"))
        exp.export_cameras_json(m.camera_set, str(d / "cameras.json"))
        exp.export_colmap_model(m.camera_set, m.point_set, str(d / "sparse"),
                                ext=".txt")
    assert (jd / "pointcloud.ply").read_bytes() == (td / "pointcloud.ply").read_bytes()
    ja, ta = (json.loads((d / "cameras.json").read_text()) for d in (jd, td))
    assert [c["id"] for c in ja] == [c["id"] for c in ta]
    for c, d in zip(ja, ta):
        assert c["K"] == d["K"] and c["img_size"] == d["img_size"]
        assert _err(c["W2C"], d["W2C"]) <= 1e-6
    for f in ("cameras.txt", "points3D.txt"):
        assert (jd / "sparse" / f).read_bytes() == (td / "sparse" / f).read_bytes(), f
    ji, ti = ((d / "sparse" / "images.txt").read_text() for d in (jd, td))
    assert [l.split()[-1] for l in ji.splitlines()[3::2]] == \
        [l.split()[-1] for l in ti.splitlines()[3::2]]
    assert _err(_parse_floats(ji), _parse_floats(ti)) <= 1e-6
    # the viewer page of the same run directory, byte for byte
    assert open(jhtml.export_html(str(jd), str(tmp_path / "j.html"))).read() == \
        open(thtml.export_html(str(jd), str(tmp_path / "t.html"))).read()
