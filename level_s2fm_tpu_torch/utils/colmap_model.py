"""COLMAP sparse-model writer (cameras/images/points3D, .bin and .txt).

The port's own copy of the writer half of ``preparation/colmap_model.py``
(the public COLMAP model format), which ``utils/export.export_colmap_model``
needs: the camera, image and point records, ``rotmat_to_qvec`` and
``write_model``.
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass
class ColmapImage:
    image_id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray = None          # [K,2] 2D observations (optional)
    point3D_ids: np.ndarray = None  # [K] int64; -1 = untracked


# COLMAP camera-model table (public format): model_id -> (name, n_params).
CAMERA_MODEL_PARAMS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}
_MODEL_ID_BY_NAME = {name: mid for mid, (name, _) in CAMERA_MODEL_PARAMS.items()}


@dataclass
class ColmapCamera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapPoint3D:
    point3D_id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


def write_cameras_txt(cams: Dict[int, ColmapCamera], path: str):
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n"
                "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for cid in sorted(cams):
            c = cams[cid]
            params = " ".join(repr(float(p)) for p in c.params)
            f.write(f"{c.camera_id} {c.model} {c.width} {c.height} {params}\n")


def write_cameras_bin(cams: Dict[int, ColmapCamera], path: str):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cid in sorted(cams):
            c = cams[cid]
            f.write(struct.pack("<IiQQ", c.camera_id,
                                _MODEL_ID_BY_NAME[c.model],
                                int(c.width), int(c.height)))
            f.write(struct.pack(f"<{len(c.params)}d", *map(float, c.params)))


def write_images_txt(images: Dict[int, ColmapImage], path: str):
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n"
                "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
                "#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for iid in sorted(images):
            im = images[iid]
            q = " ".join(repr(float(v)) for v in im.qvec)
            t = " ".join(repr(float(v)) for v in im.tvec)
            f.write(f"{im.image_id} {q} {t} {im.camera_id} {im.name}\n")
            if im.xys is not None and len(im.xys):
                p3d = (im.point3D_ids if im.point3D_ids is not None
                       else -np.ones(len(im.xys), np.int64))
                f.write(" ".join(f"{float(x)!r} {float(y)!r} {int(pid)}"
                                 for (x, y), pid in zip(im.xys, p3d)))
            f.write("\n")


def write_images_bin(images: Dict[int, ColmapImage], path: str):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for iid in sorted(images):
            im = images[iid]
            f.write(struct.pack("<I", im.image_id))
            f.write(struct.pack("<4d", *map(float, im.qvec)))
            f.write(struct.pack("<3d", *map(float, im.tvec)))
            f.write(struct.pack("<I", im.camera_id))
            f.write(im.name.encode() + b"\x00")
            xys = im.xys if im.xys is not None else np.zeros((0, 2))
            p3d = (im.point3D_ids if im.point3D_ids is not None
                   else -np.ones(len(xys), np.int64))
            f.write(struct.pack("<Q", len(xys)))
            for (x, y), pid in zip(xys, p3d):
                f.write(struct.pack("<ddq", float(x), float(y), int(pid)))


def write_points3D_txt(pts: Dict[int, ColmapPoint3D], path: str):
    with open(path, "w") as f:
        f.write("# 3D point list with one line of data per point:\n"
                "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
                "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        for pid in sorted(pts):
            p = pts[pid]
            xyz = " ".join(repr(float(v)) for v in p.xyz)
            rgb = " ".join(str(int(v)) for v in p.rgb)
            track = " ".join(f"{int(i)} {int(j)}"
                             for i, j in zip(p.image_ids, p.point2D_idxs))
            f.write(f"{p.point3D_id} {xyz} {rgb} {float(p.error)!r} {track}\n")


def write_points3D_bin(pts: Dict[int, ColmapPoint3D], path: str):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(pts)))
        for pid in sorted(pts):
            p = pts[pid]
            f.write(struct.pack("<Q", p.point3D_id))
            f.write(struct.pack("<3d", *map(float, p.xyz)))
            f.write(struct.pack("<3B", *map(int, p.rgb)))
            f.write(struct.pack("<d", float(p.error)))
            f.write(struct.pack("<Q", len(p.image_ids)))
            for i, j in zip(p.image_ids, p.point2D_idxs):
                f.write(struct.pack("<2i", int(i), int(j)))


def write_model(cams, images, pts, model_dir: str, ext: str = ".bin"):
    """Write a sparse model directory in COLMAP layout (.bin or .txt)."""
    os.makedirs(model_dir, exist_ok=True)
    if ext == ".bin":
        write_cameras_bin(cams, os.path.join(model_dir, "cameras.bin"))
        write_images_bin(images, os.path.join(model_dir, "images.bin"))
        write_points3D_bin(pts, os.path.join(model_dir, "points3D.bin"))
    else:
        write_cameras_txt(cams, os.path.join(model_dir, "cameras.txt"))
        write_images_txt(images, os.path.join(model_dir, "images.txt"))
        write_points3D_txt(pts, os.path.join(model_dir, "points3D.txt"))


def rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """Inverse of qvec_to_rotmat (w,x,y,z; w >= 0)."""
    t = np.trace(R)
    if t > 0:
        w = 0.5 * np.sqrt(1.0 + t)
        x = (R[2, 1] - R[1, 2]) / (4 * w)
        y = (R[0, 2] - R[2, 0]) / (4 * w)
        z = (R[1, 0] - R[0, 1]) / (4 * w)
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 0.0)) * 2
        q = np.zeros(3)
        q[i] = 0.25 * s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        w = (R[k, j] - R[j, k]) / s
        x, y, z = q
    q = np.asarray([w, x, y, z])
    return q if q[0] >= 0 else -q
