"""Per-dataset scene loaders + prepared-matches plumbing.

Counterpart of ``level_s2fm_tpu/data/loaders.py``, for the same four
dataset layouts:
  * DTU: ``cameras.npz`` with scale_mat_%d/world_mat_%d, raw images
    downscaled to opt.data.image_size (``data.raw_size`` overrides the
    1200x1600 default for self-rendered scenes);
  * ETH3D: ``intrinsics.txt`` + per-image ``pose/*.txt`` (w2c), optional
    ``.cam`` init poses and recenter/rescale;
  * BlendedMVS: the same txt layout (c2w), black background lifted to
    white;
  * ScanNet: ``intrinsic/intrinsic_color.txt`` + ``pose/*.txt``, frame
    subsampling by opt.data.freq_frame, GT depth from ``depth/*.png``.

``load_prepared_scene`` adds the preparation artifacts (``n_views.npy``,
``pose_graph.npy``) and returns the pipeline's ``var`` dict, keypoints
rescaled by the image downscale factors.
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from . import base


def _frame_preproc(opt):
    """(center_crop, augment, rng) from opt.data — None/None when the
    default fast path applies (reference ships both off:
    `options/base.yaml:23-24`). The augment rng is seeded from opt.seed
    so a resumed run re-draws the same jitter."""
    dc = opt.data
    crop = dc.get("center_crop", None) or None
    aug = dc.get("augment", None) or None
    if aug is not None and not any(aug.get(k, None)
                                   for k in ("brightness", "contrast",
                                             "saturation", "hue")):
        aug = None
    rng = np.random.default_rng(int(opt.get("seed") or 0)) if aug else None
    return crop, aug, rng


def _raw_size(dataset: str, opt=None) -> Tuple[int, int]:
    """Native capture resolution per dataset. ``opt.data.raw_size``
    overrides (needed for self-rendered DTU-format scenes whose images
    are not 1200x1600)."""
    if opt is not None:
        rs = opt.data.get("raw_size") or None
        if rs:
            return tuple(rs)
    return {"DTU": (1200, 1600), "ETH3D": (4134, 6204),
            "BlendedMVS": (576, 768), "scannet": (968, 1296)}.get(
        dataset, (None, None))


def load_dtu(opt) -> Dict:
    root = opt.data.get("root") or "data/DTU"
    path = os.path.join(root, opt.data.scene)
    inner = os.path.join(path, opt.data.scene)
    root_data = inner if os.path.exists(inner) else path
    img_dir = os.path.join(root_data, "images")
    fnames = base.sorted_images(img_dir)
    n = len(fnames)
    cams = np.load(os.path.join(root_data, "cameras.npz"))
    H, W = opt.data.image_size
    rawH, rawW = _raw_size("DTU", opt)
    fx, fy = rawW / W, rawH / H
    intrs, poses, images = [], [], []
    crop, aug, rng = _frame_preproc(opt)
    for i in range(n):
        P = (cams[f"world_mat_{i}"] @ cams[f"scale_mat_{i}"]).astype(np.float32)[:3, :4]
        intr, c2w = base.decompose_projection(P)
        poses.append(base.w2c_from_c2w(c2w))
        if crop or aug:
            img, K = base.preprocess_frame(fnames[i], intr[:3, :3], (H, W),
                                           center_crop=crop, augment=aug, rng=rng)
        else:
            img = base.load_rgb(fnames[i], (H, W))
            K = base.scale_intrinsics(intr[:3, :3], fx, fy)
        intrs.append(K)
        images.append(img)
    return {"images": np.stack(images), "intrs": np.stack(intrs),
            "poses_gt": np.stack(poses), "factor_x": fx, "factor_y": fy}


def _read_cam_init(path: str) -> np.ndarray:
    """Parse a COLMAP-exported ``.cam`` file into a c2w [3,4] matrix
    (ref `data/ETH3D.py:61-67`): the first line is 12 floats — t (3)
    then row-major R (9) — forming a w2c [R|t]; c2w is its rigid
    inverse."""
    with open(path, "r") as f:
        vals = [float(a.strip("\n")) for a in f.readlines()[0].split(" ")]
    w2c = np.concatenate([np.asarray(vals[3:], np.float32).reshape(3, 3),
                          np.asarray(vals[:3], np.float32).reshape(3, 1)],
                         axis=-1)
    return base.w2c_from_c2w(w2c)  # rigid inverse works either direction


def _recenter_rescale(c2w_list, rad: float):
    """Recenter camera centers to their mean and rescale so the farthest
    sits at ``rad/1.1`` (ref `data/ETH3D.py:80-91`, `data/scannet.py:87-98`
    — required for real scenes whose GT poses aren't sphere-normalized).
    Mutates translations in place; returns (center, scale)."""
    center = np.mean([c[:3, 3] for c in c2w_list], axis=0)
    for c in c2w_list:
        c[:3, 3] -= center
    max_norm = max(float(np.linalg.norm(c[:3, 3])) for c in c2w_list)
    if max_norm < 1e-8:
        # all camera centers coincide (degenerate 1-frame / duplicated-pose
        # scene): an unguarded divide would silently poison every pose
        # with inf/NaN
        raise ValueError(
            "recenter/rescale: all camera centers coincide (max |c| = "
            f"{max_norm:.3g}); cannot rescale a zero-extent camera rig")
    scale = rad / max_norm / 1.1
    for c in c2w_list:
        c[:3, 3] *= scale
    return center, scale


def _load_txt_scene(opt, raw_hw, bg_white=False, pose_file_is_w2c=False,
                    cam_init_dir=None) -> Dict:
    """txt-layout scene family (ETH3D/BlendedMVS layout).

    ``pose_file_is_w2c``: ETH3D's ``pose/*.txt`` store w2c and the
    reference inverts them to c2w (`data/ETH3D.py:50`); BlendedMVS's
    store c2w directly (`data/BlendedMVS.py:49`).
    ``cam_init_dir``: when set, poses come from COLMAP ``.cam`` files
    instead of GT, and frames without a ``.cam`` are dropped entirely
    (ref `data/ETH3D.py:55-69`; deviation: the reference appends the
    shared intrinsics *before* skipping, leaving `intrinsics_all`
    misaligned — harmless there because K is shared, but we skip the
    whole frame cleanly).
    ``opt.data.center``: recenter + rescale camera centers to a sphere
    of radius ``opt.rad`` (ref `data/ETH3D.py:80-91`)."""
    root = opt.data.get("root")
    path = os.path.join(root, opt.data.scene)
    img_dir = os.path.join(path, "images")
    fnames = base.sorted_images(img_dir)
    H, W = opt.data.image_size
    rawH, rawW = raw_hw
    fx, fy = rawW / W, rawH / H
    K_raw = np.loadtxt(os.path.join(path, "intrinsics.txt")).astype(np.float32)[:3, :3]
    K = base.scale_intrinsics(K_raw, fx, fy)
    crop, aug, rng = _frame_preproc(opt)
    intrs, c2ws, images = [], [], []
    for f in fnames:
        stem = os.path.splitext(os.path.basename(f))[0]
        if cam_init_dir is not None:
            cam_path = os.path.join(cam_init_dir, stem + ".cam")
            if not os.path.exists(cam_path):
                continue
            c2w = _read_cam_init(cam_path)
        else:
            mat = np.loadtxt(os.path.join(path, "pose", stem + ".txt")).astype(np.float32)
            c2w = base.w2c_from_c2w(mat) if pose_file_is_w2c else mat[:3, :4].copy()
        c2ws.append(np.asarray(c2w, np.float32)[:3, :4].copy())
        if crop or aug:
            img, Ki = base.preprocess_frame(f, K_raw, (H, W),
                                            center_crop=crop, augment=aug, rng=rng)
        else:
            img, Ki = base.load_rgb(f, (H, W)), K
        if bg_white:
            dark = np.all(img <= 0.1, axis=-1)
            img[dark] = 1.0
        images.append(img)
        intrs.append(Ki)
    if opt.data.get("center", False):
        rad = float(opt.get("rad") or opt.data.get("rad") or 3.0)
        _recenter_rescale(c2ws, rad)
    poses = [base.w2c_from_c2w(c) for c in c2ws]
    return {"images": np.stack(images), "intrs": np.stack(intrs),
            "poses_gt": np.stack(poses), "factor_x": fx, "factor_y": fy}


def load_eth3d(opt) -> Dict:
    """ETH3D scene (ref `data/ETH3D.py:17-101`): w2c pose txts, optional
    COLMAP-initialized poses (``data.init``; dir overridable via
    ``data.cam_dir``, default matches ref :58 `rec_3rd/rec_model/cam`),
    optional recenter/rescale-to-sphere (``data.center``)."""
    cam_dir = None
    if opt.data.get("init", False):
        root = os.path.join(opt.data.get("root"), opt.data.scene)
        cam_dir = opt.data.get("cam_dir") or os.path.join(
            root, "rec_3rd", "rec_model", "cam")
    return _load_txt_scene(opt, _raw_size("ETH3D", opt),
                           pose_file_is_w2c=True, cam_init_dir=cam_dir)


def load_blendedmvs(opt) -> Dict:
    return _load_txt_scene(opt, _raw_size("BlendedMVS", opt), bg_white=True)


def load_scannet(opt) -> Dict:
    """ScanNet scene (ref `data/scannet.py:17-118`): c2w pose txts,
    ``freq_frame`` subsampling, GT depth from ``depth/*.png`` (uint16 mm
    -> meters, ref :76 — an eval asset, returned as ``depth_gt`` when the
    directory exists), optional ``.cam`` init poses (ref :56-68) and
    recenter/rescale-to-sphere (ref :87-98). Deviation noted: the
    reference leaves GT depth unscaled after the recenter rescale (the
    depth-scaling block is commented out, ref :110-117) — we replicate
    that, so ``depth_gt`` stays in raw meters; eval must align by sim3
    (Procrustes) rather than raw scale when ``center`` is on. The
    omnidata priors (ref :78-81) are dead in the reference release and
    not carried."""
    root = opt.data.get("root")
    path = os.path.join(root, opt.data.scene)
    img_dir = os.path.join(path, "color")
    fnames = base.sorted_images(img_dir)
    freq = int(opt.data.get("freq_frame", 1))
    fnames = fnames[::freq]
    H, W = opt.data.image_size
    rawH, rawW = _raw_size("scannet", opt)
    fx, fy = rawW / W, rawH / H
    K_raw = np.loadtxt(os.path.join(path, "intrinsic",
                                    "intrinsic_color.txt")).astype(np.float32)[:3, :3]
    K = base.scale_intrinsics(K_raw, fx, fy)
    crop, aug, rng = _frame_preproc(opt)
    cam_init_dir = (os.path.join(path, "cam")
                    if opt.data.get("init", False) else None)
    depth_dir = os.path.join(path, "depth")
    has_depth = os.path.isdir(depth_dir)
    intrs, c2ws, images, depths = [], [], [], []
    for f in fnames:
        stem = os.path.splitext(os.path.basename(f))[0]
        if cam_init_dir is not None:
            cam_path = os.path.join(cam_init_dir, stem + ".cam")
            if not os.path.exists(cam_path):
                continue
            c2w = _read_cam_init(cam_path)
        else:
            c2w = np.loadtxt(os.path.join(path, "pose",
                                          stem + ".txt")).astype(np.float32)[:3, :4]
        c2ws.append(np.asarray(c2w, np.float32).copy())
        if crop or aug:
            img, Ki = base.preprocess_frame(f, K_raw, (H, W),
                                            center_crop=crop, augment=aug, rng=rng)
        else:
            img, Ki = base.load_rgb(f, (H, W)), K
        images.append(img)
        intrs.append(Ki)
        if has_depth:
            depths.append(base.load_depth(os.path.join(depth_dir, stem + ".png")))
    if opt.data.get("center", False):
        rad = float(opt.get("rad") or opt.data.get("rad") or 3.0)
        _recenter_rescale(c2ws, rad)
    poses = [base.w2c_from_c2w(c) for c in c2ws]
    out = {"images": np.stack(images), "intrs": np.stack(intrs),
           "poses_gt": np.stack(poses), "factor_x": fx, "factor_y": fy}
    if has_depth:
        out["depth_gt"] = np.stack(depths)
    return out


LOADERS = {"DTU": load_dtu, "ETH3D": load_eth3d,
           "BlendedMVS": load_blendedmvs, "scannet": load_scannet}


def load_prepared_scene(opt) -> Dict:
    """Full pipeline `var`: images/intrinsics/GT poses + keypoints/matches/
    inlier masks/pose graph from the preparation artifacts."""
    dataset = opt.data.dataset
    if dataset not in LOADERS:
        raise ValueError(f"unknown dataset {dataset!r}; options: {list(LOADERS)}")
    if opt.data.get("center_crop", None):
        raise ValueError(
            "data.center_crop is incompatible with the SfM pipeline: the "
            "preparation keypoints were extracted on uncropped frames. "
            "Crop support exists for the render-only data surface "
            "(reference parity, data/base.py:92-117); re-run "
            "preparation/main.py on cropped images instead.")
    scene_data = LOADERS[dataset](opt)

    prep_dir = opt.data.get("prep_dir") or os.path.join(
        "data", dataset, opt.data.scene)
    n_views_path = os.path.join(prep_dir, "n_views.npy")
    if not os.path.exists(n_views_path):
        raise FileNotFoundError(
            f"{n_views_path} not found — run preparation/main.py first "
            "(COLMAP keypoints/matches + pose graph)")
    n_views_geo = np.load(n_views_path, allow_pickle=True)
    dsamp = np.asarray([scene_data["factor_x"], scene_data["factor_y"]]).reshape(1, 2)
    kypts = [np.asarray(d["kypts"]) / dsamp for d in n_views_geo]
    matches = [d["indxes"] for d in n_views_geo]
    masks = [d["mask"] for d in n_views_geo]

    pg_path = os.path.join(prep_dir, "pose_graph.npy")
    if os.path.exists(pg_path):
        pose_graph = list(np.load(pg_path, allow_pickle=True)[:])
    else:
        pose_graph = [i for i in range(len(scene_data["images"])) if i % 3 == 0]

    var = {"images": scene_data["images"], "intrs": scene_data["intrs"],
           "poses_gt": scene_data["poses_gt"], "kypts": kypts,
           "matches": matches, "masks": masks, "pose_graph": pose_graph}
    if "depth_gt" in scene_data:  # eval asset (ScanNet)
        var["depth_gt"] = scene_data["depth_gt"]
    return var
