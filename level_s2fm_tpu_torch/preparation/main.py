"""Offline preprocessing: keypoints, all-pairs matches, pose graph.

The port's own copy of ``preparation/main.py``: it imports nothing of the
JAX package nor of ``preparation/``. Produces the artifacts the pipeline
consumes (``data/loaders.load_prepared_scene`` reads them):
  * ``n_views.npy``  — per image dict {kypts [K,2], indxes (list of [M,2]
    per other image), mask (list of [M] bool inlier masks)}
  * ``pose_graph.npy`` — image registration order
  * ``two_view.npy``  — per-pair relative two-view info

Two backends:
  * ``--backend=colmap`` runs the COLMAP binary (feature_extractor /
    exhaustive_matcher / mapper) unless ``colmap_ws/database.db`` exists,
    reads keypoints+matches from the SQLite database and the registration
    order from the mapper log (or the model's image ids).
  * ``--backend=sift`` (default when no colmap binary): OpenCV SIFT +
    ratio-test BF matching + fundamental-matrix RANSAC inlier masks, an
    epipolar-guided re-match and a match-count-greedy pose graph. OpenCV
    is imported inside ``run_sift_backend`` only.

Usage: python -m level_s2fm_tpu_torch.prepare --data data/DTU --scene scan24 \
           [--backend=auto|sift|colmap] [--max_kypts=8192] [--sift_contrast=F]
           [--no_guided] [--guided_px=F] [--guided_ratio=F]
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess

import numpy as np


def find_images_dir(scene_dir: str) -> str:
    for cand in ("images", "color"):
        d = os.path.join(scene_dir, cand)
        if os.path.isdir(d):
            return d
    inner = os.path.join(scene_dir, os.path.basename(scene_dir), "images")
    if os.path.isdir(inner):
        return inner
    raise FileNotFoundError(f"no images/ under {scene_dir}")


# --------------------------------------------------------------------- SIFT
def guided_rematch(kp0, kp1, knn, F, band_px: float = 3.0,
                   g_ratio: float = 0.9):
    """Epipolar-guided second matching pass (COLMAP-style guided matching,
    the density COLMAP's ``exhaustive_matcher`` gets from its
    two-view-geometry verification). The plain ratio test starves
    repeated-texture pairs — a true match is rejected whenever a similar
    descriptor exists ANYWHERE in the other image. With a verified F, the
    ambiguity collapses to the epipolar band: accept the best candidate
    within ``band_px`` of the query's epipolar line if it beats the
    second IN-BAND candidate by ``g_ratio`` (or is the only one there).

    kp0/kp1: [K,2] keypoints; knn: cv2 knnMatch(desc0, desc1, k>=4)
    output; F: fundamental matrix (maps image-0 points to image-1 lines).
    Returns [M,2] (queryIdx, trainIdx), deduped one-to-one by trainIdx.
    """
    h0 = np.concatenate([kp0, np.ones((len(kp0), 1), np.float32)], 1)
    lines = h0 @ F.T                                   # [K0,3] lines in im1
    norm = np.sqrt(lines[:, 0] ** 2 + lines[:, 1] ** 2) + 1e-12
    best = {}
    for cands in knn:
        if not cands:
            continue
        q = cands[0].queryIdx
        l, nz = lines[q], norm[q]
        in_band = []
        for c in cands:
            p = kp1[c.trainIdx]
            d_epi = abs(l[0] * p[0] + l[1] * p[1] + l[2]) / nz
            if d_epi <= band_px:
                in_band.append(c)
        if not in_band:
            continue
        c0 = in_band[0]                       # knn output is distance-sorted
        if len(in_band) > 1 and not (c0.distance < g_ratio * in_band[1].distance):
            continue
        cur = best.get(c0.trainIdx)
        if cur is None or c0.distance < cur[1]:
            best[c0.trainIdx] = (c0.queryIdx, c0.distance)
    if not best:
        return np.zeros((0, 2), np.int64)
    return np.asarray([[q, t] for t, (q, _) in sorted(best.items())], np.int64)


def run_sift_backend(scene_dir: str, max_kypts: int = 8192, ratio: float = 0.8,
                     contrast: float = 0.04, guided: bool = True,
                     guided_px: float = 3.0, guided_ratio: float = 0.9):
    # ``contrast``: cv2 SIFT contrastThreshold (default = cv2's own 0.04).
    # High-resolution renders spread texture gradients over more pixels,
    # starving the default detector (measured: 1200 kypts/img at
    # 1200x1600 where the 400px render of the same scene gave dense
    # coverage) — lower to ~0.01 for reference-resolution synthetic scenes
    import cv2
    from ..data.base import sorted_images
    img_dir = find_images_dir(scene_dir)
    fnames = sorted_images(img_dir)
    n = len(fnames)
    sift = cv2.SIFT_create(nfeatures=max_kypts, contrastThreshold=contrast)
    kypts, descs = [], []
    for f in fnames:
        img = cv2.imread(f, cv2.IMREAD_GRAYSCALE)
        kp, de = sift.detectAndCompute(img, None)
        kypts.append(np.asarray([k.pt for k in kp], np.float32))
        descs.append(de)
        print(f"[sift] {os.path.basename(f)}: {len(kp)} keypoints")

    bf = cv2.BFMatcher(cv2.NORM_L2)
    pair_matches = {}
    match_counts = np.zeros((n, n), np.int64)
    for i in range(n):
        for j in range(i + 1, n):
            knn = bf.knnMatch(descs[i], descs[j], k=6 if guided else 2)
            good = [c[0] for c in knn
                    if len(c) >= 2 and c[0].distance < ratio * c[1].distance]
            if len(good) < 8:
                m = np.zeros((0, 2), np.int64)
                mask = np.zeros(0, bool)
            else:
                m = np.asarray([[g.queryIdx, g.trainIdx] for g in good], np.int64)
                p0 = kypts[i][m[:, 0]]
                p1 = kypts[j][m[:, 1]]
                F, fmask = cv2.findFundamentalMat(p0, p1, cv2.FM_RANSAC, 2.0, 0.999)
                mask = (fmask[:, 0].astype(bool) if fmask is not None
                        else np.ones(len(m), bool))
                n_first = int(mask.sum())
                # guided pass: re-match inside the epipolar band of the
                # verified F, union with the first pass, re-verify
                if guided and F is not None and n_first >= 8:
                    m_first, mask_first = m, mask
                    m2 = guided_rematch(kypts[i], kypts[j], knn, F,
                                        band_px=guided_px, g_ratio=guided_ratio)
                    if len(m2):
                        mu = np.unique(np.concatenate([m, m2], 0), axis=0)
                        F2, fmask = cv2.findFundamentalMat(
                            kypts[i][mu[:, 0]], kypts[j][mu[:, 1]],
                            cv2.FM_RANSAC, 2.0, 0.999)
                        if F2 is not None and fmask is not None and \
                                int(fmask.sum()) >= n_first:
                            m, mask = mu, fmask[:, 0].astype(bool)
                        else:   # degraded re-verify: keep the first pass
                            m, mask = m_first, mask_first
            pair_matches[(i, j)] = (m, mask)
            match_counts[i, j] = match_counts[j, i] = int(mask.sum())
            print(f"[match] {i}-{j}: {len(m)} matches, {int(mask.sum())} inliers")

    pose_graph = greedy_pose_graph(match_counts)
    return kypts, pair_matches, pose_graph


def greedy_pose_graph(match_counts: np.ndarray):
    """Seed with the best pair, then repeatedly add the view most
    connected to the registered set (a simple stand-in for COLMAP's
    next-best-view order)."""
    n = match_counts.shape[0]
    if n == 1:
        return [0]
    off_diag = match_counts - np.diag(np.full(n, np.iinfo(np.int64).max // 2))
    i, j = np.unravel_index(np.argmax(off_diag), off_diag.shape)
    if i == j:  # no matches anywhere: fall back to index order
        return list(range(n))
    order = [int(i), int(j)]
    while len(order) < n:
        remaining = [k for k in range(n) if k not in order]
        scores = [match_counts[k, order].sum() for k in remaining]
        order.append(int(remaining[int(np.argmax(scores))]))
    return order


# ------------------------------------------------------------------- COLMAP
def run_colmap_backend(scene_dir: str, colmap_bin: str = "colmap"):
    from ..utils.colmap_model import read_images
    from .colmap_db import ColmapDatabase
    img_dir = find_images_dir(scene_dir)
    work = os.path.join(scene_dir, "colmap_ws")
    os.makedirs(work, exist_ok=True)
    db_path = os.path.join(work, "database.db")
    sparse = os.path.join(work, "sparse")
    os.makedirs(sparse, exist_ok=True)
    if not os.path.exists(db_path):
        subprocess.run([colmap_bin, "feature_extractor", "--database_path", db_path,
                        "--image_path", img_dir,
                        "--ImageReader.single_camera", "1"], check=True)
        subprocess.run([colmap_bin, "exhaustive_matcher",
                        "--database_path", db_path], check=True)
        # capture the mapper log: it is the only record of the TRUE
        # incremental registration order.
        # Write it even on mapper failure — it is also the only record of
        # WHY mapping failed.
        mapper_log = os.path.join(scene_dir, "mapper.log")
        r = subprocess.run([colmap_bin, "mapper", "--database_path", db_path,
                            "--image_path", img_dir, "--output_path", sparse],
                           capture_output=True, text=True)
        with open(mapper_log, "w") as f:
            f.write((r.stdout or "") + "\n" + (r.stderr or ""))
        r.check_returncode()

    db = ColmapDatabase(db_path)
    names = db.image_names()
    name_order = sorted(names.items(), key=lambda kv: kv[1])
    id_to_idx = {img_id: idx for idx, (img_id, _) in enumerate(name_order)}
    kypts_by_id = db.keypoints()
    n = len(name_order)
    kypts = [kypts_by_id[img_id] for img_id, _ in name_order]
    tvg = db.two_view_geometries()
    raw = db.matches()
    pair_matches = {}
    for (id1, id2), m in raw.items():
        i, j = id_to_idx[id1], id_to_idx[id2]
        if i > j:
            i, j = j, i
            m = m[:, ::-1]
        inl = tvg.get((id1, id2))
        if inl is not None and len(inl):
            inl_set = {(a, b) for a, b in inl}
            mask = np.asarray([(a, b) in inl_set for a, b in m], bool)
        else:
            mask = np.zeros(len(m), bool)
        pair_matches[(i, j)] = (m.astype(np.int64), mask)
    db.close()

    # TRUE registration order from the mapper log ("Initializing with
    # image pair #i and #j" then "Registering image #k"); the model's
    # sorted image ids are only the fallback (they lose the order COLMAP
    # actually chose, including the init pair)
    model_dir = os.path.join(sparse, "0")
    imgs = read_images(model_dir)
    reg_ids = None
    mapper_log = os.path.join(scene_dir, "mapper.log")
    if os.path.exists(mapper_log):
        with open(mapper_log) as f:
            parsed = parse_mapper_log(f.read())
        if len(parsed) >= 2:
            # keep only ids that survived into the final model, in order
            reg_ids = [i for i in parsed if i in imgs]
    if not reg_ids:
        reg_ids = sorted(imgs.keys())
    pose_graph = [id_to_idx[i] for i in reg_ids if i in id_to_idx]
    pose_graph += [k for k in range(n) if k not in pose_graph]
    return kypts, pair_matches, pose_graph


def parse_mapper_log(text: str):
    """COLMAP image ids in true incremental registration order.

    Parses the mapper's console log: the init pair from
    ``Initializing with image pair #i and #j`` and each subsequent
    ``Registering image #k (...)`` line, de-duplicated first-wins (the
    mapper can retry registrations after bundle adjustments).
    """
    import re
    order = []
    seen = set()

    def add(i):
        if i not in seen:
            seen.add(i)
            order.append(i)

    for line in text.splitlines():
        m = re.search(r"Initializing with image pair #(\d+) and #(\d+)", line)
        if m:
            add(int(m.group(1)))
            add(int(m.group(2)))
            continue
        m = re.search(r"Registering image #(\d+)", line)
        if m:
            add(int(m.group(1)))
    return order


# ------------------------------------------------------------------- output
def write_artifacts(out_dir: str, kypts, pair_matches, pose_graph):
    n = len(kypts)
    n_views = []
    for i in range(n):
        indxes, masks = [], []
        for j in range(n):
            if j == i:
                continue
            a, b = (i, j) if i < j else (j, i)
            m, mask = pair_matches.get((a, b), (np.zeros((0, 2), np.int64),
                                                np.zeros(0, bool)))
            if i > j:
                m = m[:, ::-1]
            indxes.append(np.asarray(m))
            masks.append(np.asarray(mask))
        n_views.append({"kypts": np.asarray(kypts[i]),
                        "indxes": indxes, "mask": masks})
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "n_views.npy"),
            np.asarray(n_views, dtype=object), allow_pickle=True)
    np.save(os.path.join(out_dir, "pose_graph.npy"),
            np.asarray(pose_graph), allow_pickle=True)
    two_view = {"pairs": sorted(pair_matches.keys()),
                "counts": {k: int(v[1].sum()) for k, v in pair_matches.items()}}
    np.save(os.path.join(out_dir, "two_view.npy"),
            np.asarray([two_view], dtype=object), allow_pickle=True)
    print(f"wrote n_views.npy / pose_graph.npy / two_view.npy to {out_dir}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m level_s2fm_tpu_torch.prepare")
    ap.add_argument("--data", required=True, help="dataset root, e.g. data/DTU")
    ap.add_argument("--scene", required=True)
    ap.add_argument("--backend", default="auto", choices=["auto", "colmap", "sift"])
    ap.add_argument("--max_kypts", type=int, default=8192)
    ap.add_argument("--sift_contrast", type=float, default=0.04)
    ap.add_argument("--no_guided", action="store_true",
                    help="disable the epipolar-guided re-matching pass")
    ap.add_argument("--guided_px", type=float, default=3.0)
    ap.add_argument("--guided_ratio", type=float, default=0.9)
    args = ap.parse_args(argv)

    scene_dir = os.path.join(args.data, args.scene)
    backend = args.backend
    if backend == "auto":
        backend = "colmap" if shutil.which("colmap") else "sift"
        print(f"[prep] backend: {backend}")
    if backend == "colmap":
        kypts, pair_matches, pose_graph = run_colmap_backend(scene_dir)
    else:
        kypts, pair_matches, pose_graph = run_sift_backend(
            scene_dir, args.max_kypts, contrast=args.sift_contrast,
            guided=not args.no_guided, guided_px=args.guided_px,
            guided_ratio=args.guided_ratio)
    write_artifacts(scene_dir, kypts, pair_matches, pose_graph)
