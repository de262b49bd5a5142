"""The port's scene preparation (``level_s2fm_tpu_torch.preparation``,
``python -m level_s2fm_tpu_torch.prepare``) against ``preparation/`` in
the same process, on a 3-view, 96 px DTU-layout sphere scene:

* the SIFT backend: keypoints, match lists, inlier masks and the pose
  graph equal; the three ``.npy`` artifacts load equal;
* ``guided_rematch`` on a hand-built case, ``parse_mapper_log`` on a
  mapper log;
* ``ColmapDatabase`` written by one package and read by the other; the
  COLMAP model reader on the ``.bin`` and ``.txt`` models that
  ``preparation/colmap_model.py`` writes;
* the COLMAP backend of both packages on one pre-populated ``colmap_ws/``
  and ``mapper.log`` (no ``colmap`` binary needed);
* the port's ``load_prepared_scene`` reads the port's artifacts;
* one subprocess generates a scene with ``make_synthetic_dataset``,
  prepares it with ``python -m level_s2fm_tpu_torch.prepare`` (run as
  ``-m`` runs it) and finds no jax, ``level_s2fm_tpu``, ``preparation``
  or ``scripts`` module loaded.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from level_s2fm_tpu_torch.data import synthetic as tsyn
from level_s2fm_tpu_torch.preparation import colmap_db as tdb
from level_s2fm_tpu_torch.preparation import main as tprep
from level_s2fm_tpu_torch.utils import colmap_model as tcm
from level_s2fm_tpu_torch.utils import png
from preparation import colmap_db as jdb
from preparation import colmap_model as jcm
from preparation import main as jprep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def dtu_root(tmp_path_factory):
    """A scene in DTU layout, written as tests/test_data_prep.py writes
    its sphere (3 views, 96 px). The scene is the hard one on a partial
    orbit (13.5 deg steps): its texture is made for SIFT, where the
    untextured sphere at 96 px yields a handful of keypoints and no
    verified pair. Pair 1-2 passes the 8-inlier floor and runs the
    guided re-match; pair 0-1 stays below it, pair 0-2 has no match."""
    root = tmp_path_factory.mktemp("dtu_root")
    img_dir = root / "scanX" / "images"
    img_dir.mkdir(parents=True)
    images, intrs, poses = tsyn.make_hard_scene_images(n_views=3, H=96, W=96,
                                                       full_orbit=False)
    cams = {}
    for i in range(3):
        png.write_png(str(img_dir / f"{i:06d}.png"),
                      (images[i] * 255).astype(np.uint8))
        K4 = np.eye(4, dtype=np.float32)
        K4[:3, :3] = intrs[i]
        W4 = np.eye(4, dtype=np.float32)
        W4[:3, :4] = poses[i]
        cams[f"world_mat_{i}"] = K4 @ W4
        cams[f"scale_mat_{i}"] = np.eye(4, dtype=np.float32)
    np.savez(root / "scanX" / "cameras.npz", **cams)
    return root


def _assert_same_prep(a, b):
    (ka, ma, ga), (kb, mb, gb) = a, b
    assert len(kb) == len(ka)
    for x, y in zip(ka, kb):
        np.testing.assert_array_equal(y, x)
    assert sorted(mb) == sorted(ma)
    for k in ma:
        np.testing.assert_array_equal(mb[k][0], ma[k][0])
        np.testing.assert_array_equal(mb[k][1], ma[k][1])
        assert mb[k][0].dtype == ma[k][0].dtype and mb[k][1].dtype == ma[k][1].dtype
    assert gb == ga


def _assert_same_artifacts(da, db):
    for name in ("n_views.npy", "pose_graph.npy", "two_view.npy"):
        a = np.load(os.path.join(da, name), allow_pickle=True)
        b = np.load(os.path.join(db, name), allow_pickle=True)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if name == "pose_graph.npy":
            np.testing.assert_array_equal(b, a)
        elif name == "two_view.npy":
            assert b[0] == a[0]
        else:
            for x, y in zip(a, b):
                np.testing.assert_array_equal(y["kypts"], x["kypts"])
                for key in ("indxes", "mask"):
                    assert len(y[key]) == len(x[key])
                    for u, v in zip(x[key], y[key]):
                        assert u.dtype == v.dtype
                        np.testing.assert_array_equal(v, u)


def test_sift_backend_and_artifacts_match(dtu_root, tmp_path, capsys):
    scene_dir = str(dtu_root / "scanX")
    a = jprep.run_sift_backend(scene_dir, max_kypts=2048)
    b = tprep.run_sift_backend(scene_dir, max_kypts=2048)
    _assert_same_prep(a, b)
    assert sum(int(m[1].sum()) for m in b[1].values()) > 20   # real matches
    jprep.write_artifacts(str(tmp_path / "jax"), *a)
    tprep.write_artifacts(str(tmp_path / "port"), *b)
    _assert_same_artifacts(str(tmp_path / "jax"), str(tmp_path / "port"))
    # the greedy pose graph on the counts the artifacts carry
    counts = np.zeros((3, 3), np.int64)
    for (i, j), c in np.load(str(tmp_path / "port" / "two_view.npy"),
                             allow_pickle=True)[0]["counts"].items():
        counts[i, j] = counts[j, i] = c
    assert tprep.greedy_pose_graph(counts) == jprep.greedy_pose_graph(counts) == b[2]
    out = capsys.readouterr().out
    assert "[sift]" in out and "[match] 0-1" in out


class _DMatch:  # stand-in for cv2.DMatch
    def __init__(self, q, t, d):
        self.queryIdx, self.trainIdx, self.distance = q, t, d


def test_guided_rematch_matches():
    """tests/test_data_prep.py::test_guided_rematch_unit's case in both
    packages: in-band best wins, an ambiguous in-band pair is rejected,
    out-of-band candidates are ignored, the train-side dedupe keeps the
    closer query; plus a ratio tie and an empty result."""
    F = np.asarray([[0, 0, 0], [0, 0, 1], [0, 0, 0]], np.float64)
    kp0 = np.asarray([[0, 0], [5, 5], [9, 1]], np.float32)
    kp1 = np.asarray([[0, 0.5], [1, 50.0], [2, 1.0], [3, 0.0]], np.float32)
    C = _DMatch
    cases = [[[C(0, 1, 10.0), C(0, 0, 11.0)], [C(1, 2, 10.0), C(1, 3, 10.5)],
              [C(2, 3, 10.0), C(2, 0, 30.0)]],
             [[C(0, 0, 20.0)], [C(1, 0, 10.0)]],
             [[C(0, 0, 9.0), C(0, 3, 10.0)]],        # a ratio tie is rejected
             [[C(0, 1, 10.0)], []]]
    wants = [[[0, 0], [2, 3]], [[1, 0]], [], []]
    for knn, want in zip(cases, wants):
        a = jprep.guided_rematch(kp0, kp1, knn, F, band_px=3.0, g_ratio=0.9)
        b = tprep.guided_rematch(kp0, kp1, knn, F, band_px=3.0, g_ratio=0.9)
        assert b.dtype == a.dtype == np.int64
        np.testing.assert_array_equal(b, a)
        assert b.tolist() == want


MAPPER_LOG = """
==============================================================================
Finding good initial image pair
==============================================================================
  Initializing with image pair #7 and #3
==============================================================================
Registering image #5 (3)
==============================================================================
  => Image sees 182 / 257 points
Registering image #1 (4)
  => Image sees 120 / 200 points
Retriangulation
Registering image #5 (4)
Registering image #9 (5)
"""


def test_parse_mapper_log_matches():
    assert tprep.parse_mapper_log(MAPPER_LOG) == jprep.parse_mapper_log(MAPPER_LOG) \
        == [7, 3, 5, 1, 9]
    assert tprep.parse_mapper_log("no registration here") == []


def _fill_db(mod, path, rng):
    """A COLMAP database of 3 images: a camera, keypoints, descriptors,
    raw matches and verified inliers for pairs (1,2), (3,1) and (2,3)."""
    db = mod.ColmapDatabase(path)
    db.create_tables()
    cam = db.add_camera("PINHOLE", 96, 96, [86.4, 86.4, 48.0, 48.0])
    kps = {}
    for k, name in enumerate(["000000.png", "000001.png", "000002.png"]):
        iid = db.add_image(name, cam)
        kps[iid] = rng.uniform(0, 96, (30 + 5 * k, 2)).astype(np.float32)
        db.add_keypoints(iid, kps[iid])
        db.add_descriptors(iid, rng.integers(0, 255, (len(kps[iid]), 128)))
    for i, j in ((1, 2), (3, 1), (2, 3)):
        m = np.stack([rng.permutation(len(kps[i]))[:20],
                      rng.permutation(len(kps[j]))[:20]], 1)
        db.add_matches(i, j, m)
        db.add_two_view_geometry(i, j, m[::2])
    db.commit()
    db.close()


def _read_db(mod, path):
    db = mod.ColmapDatabase(path)
    out = (db.image_names(), db.cameras(), db.keypoints(), db.descriptors(),
           db.matches(), db.two_view_geometries())
    db.close()
    return out


def _assert_same_tree(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_same_tree(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same_tree(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
    else:
        assert b == a


@pytest.mark.parametrize("writer,reader", [(tdb, jdb), (jdb, tdb)],
                         ids=["port_writes", "jax_writes"])
def test_colmap_database_round_trip(writer, reader, tmp_path):
    path = str(tmp_path / "database.db")
    _fill_db(writer, path, np.random.default_rng(0))
    got = _read_db(reader, path)
    _assert_same_tree(_read_db(writer, path), got)
    assert got[0] == {1: "000000.png", 2: "000001.png", 3: "000002.png"}
    assert sorted(got[4]) == [(1, 2), (1, 3), (2, 3)]
    assert tdb.image_ids_to_pair_id(3, 1) == jdb.image_ids_to_pair_id(1, 3)
    assert tdb.pair_id_to_image_ids(jdb.image_ids_to_pair_id(1, 3)) == (1, 3)


def _jax_model(rng):
    cams = {1: jcm.ColmapCamera(1, "PINHOLE", 96, 80, np.asarray([86.4, 85.0, 48.0, 40.0])),
            2: jcm.ColmapCamera(2, "SIMPLE_RADIAL", 64, 64, np.asarray([50.0, 32.0, 32.0, 0.01]))}
    images = {}
    for iid, name, cid, n2d in ((2, "000000.png", 1, 6), (1, "000001.png", 2, 0),
                                (3, "000002.png", 1, 4)):
        q = rng.normal(size=4)
        images[iid] = jcm.ColmapImage(
            iid, q / np.linalg.norm(q), rng.normal(size=3), cid, name,
            rng.uniform(0, 64, (n2d, 2)) if n2d else None,
            rng.integers(-1, 5, n2d) if n2d else None)
    pts = {pid: jcm.ColmapPoint3D(pid, rng.normal(size=3),
                                  rng.integers(0, 255, 3).astype(np.uint8),
                                  float(rng.uniform()), np.asarray([2, 3]),
                                  np.asarray([0, pid]))
           for pid in (0, 1, 4)}
    return cams, images, pts


@pytest.mark.parametrize("ext", [".bin", ".txt"])
def test_colmap_model_reader_reads_the_jax_writer(ext, tmp_path):
    cams, images, pts = _jax_model(np.random.default_rng(2))
    jcm.write_model(cams, images, pts, str(tmp_path), ext=ext)
    jc, ji, jp = jcm.read_model(str(tmp_path))
    tc, ti, tp = tcm.read_model(str(tmp_path))
    assert sorted(ti) == [1, 2, 3] and sorted(tc) == [1, 2] and sorted(tp) == [0, 1, 4]
    for a, b in ((jc, tc), (ji, ti), (jp, tp)):
        _assert_same_tree({k: vars(v) for k, v in a.items()},
                          {k: vars(v) for k, v in b.items()})
    for k in tc:
        np.testing.assert_array_equal(tc[k].K(), jc[k].K())
    np.testing.assert_array_equal(tcm.read_images(str(tmp_path))[2].xys, ti[2].xys)
    q = ti[2].qvec
    np.testing.assert_array_equal(tcm.qvec_to_rotmat(q), jcm.qvec_to_rotmat(q))
    np.testing.assert_allclose(tcm.rotmat_to_qvec(tcm.qvec_to_rotmat(q)),
                               q * np.sign(q[0]), atol=1e-12)


@pytest.mark.parametrize("with_log", [True, False], ids=["mapper_log", "model_order"])
def test_colmap_backend_matches(with_log, tmp_path):
    """Both packages' COLMAP backend on the same pre-populated workspace:
    the database exists, so no colmap binary runs; the pose graph is the
    mapper log's order (ids that left the model dropped, the rest
    appended) or, without a log, the model's sorted image ids."""
    scene = tmp_path / "scene"
    (scene / "images").mkdir(parents=True)
    ws = scene / "colmap_ws"
    (ws / "sparse").mkdir(parents=True)
    _fill_db(tdb, str(ws / "database.db"), np.random.default_rng(1))
    cams, images, pts = _jax_model(np.random.default_rng(3))
    images = {i: im for i, im in images.items() if i != 2}     # image 2 not registered
    tcm.write_model(cams, images, pts, str(ws / "sparse" / "0"), ext=".bin")
    if with_log:
        (scene / "mapper.log").write_text(
            "Initializing with image pair #3 and #1\nRegistering image #2 (3)\n")
    a = jprep.run_colmap_backend(str(scene))
    b = tprep.run_colmap_backend(str(scene))
    _assert_same_prep(a, b)
    # image ids 1, 2, 3 are views 0, 1, 2
    assert b[2] == ([2, 0, 1] if with_log else [0, 2, 1])
    assert sorted(b[1]) == [(0, 1), (0, 2), (1, 2)]
    for m, mask in b[1].values():
        assert m.dtype == np.int64 and mask.dtype == bool and 0 < mask.sum() < len(m)
    tprep.write_artifacts(str(tmp_path / "port"), *b)
    jprep.write_artifacts(str(tmp_path / "jax"), *a)
    _assert_same_artifacts(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_load_prepared_scene_reads_the_port_output(dtu_root, tmp_path):
    from level_s2fm_tpu_torch.config import Opt
    from level_s2fm_tpu_torch.data import loaders
    prep = tmp_path / "prep"
    tprep.write_artifacts(str(prep), *tprep.run_sift_backend(
        str(dtu_root / "scanX"), max_kypts=2048))
    opt = Opt({"data": {"root": str(dtu_root), "scene": "scanX", "dataset": "DTU",
                        "image_size": [48, 48], "raw_size": [96, 96],
                        "prep_dir": str(prep)}})
    var = loaders.load_prepared_scene(opt)
    n_views = np.load(str(prep / "n_views.npy"), allow_pickle=True)
    assert var["images"].shape == (3, 48, 48, 3)
    assert var["pose_graph"] == list(np.load(str(prep / "pose_graph.npy")))
    for i in range(3):
        np.testing.assert_allclose(var["kypts"][i], n_views[i]["kypts"] / 2.0)
        assert len(var["matches"][i]) == len(var["masks"][i]) == 2


def test_generate_and_prepare_without_jax(tmp_path):
    code = (
        "import runpy, sys\n"
        "out, = sys.argv[1:]\n"
        "sys.argv = ['make_synthetic_dataset', '--out', out, '--scene', 's',\n"
        "            '--views', '3', '--size', '96', '--preset', 'multi']\n"
        "runpy.run_module('level_s2fm_tpu_torch.make_synthetic_dataset',\n"
        "                 run_name='__main__', alter_sys=True)\n"
        "sys.argv = ['prepare', '--data', out, '--scene', 's', '--backend', 'sift',\n"
        "            '--max_kypts', '2048']\n"
        "runpy.run_module('level_s2fm_tpu_torch.prepare', run_name='__main__',\n"
        "                 alter_sys=True)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'level_s2fm_tpu', 'preparation', 'scripts'))\n"
        "assert not bad, bad\n"
        "assert 'cv2' in sys.modules\n"
        "assert 'level_s2fm_tpu_torch.preparation.main' in sys.modules\n")
    p = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    assert "rad_init" in p.stdout and "wrote n_views.npy" in p.stdout
    pg = np.load(str(tmp_path / "s" / "pose_graph.npy"))
    assert sorted(pg.tolist()) == [0, 1, 2]
