"""COLMAP sparse models (cameras/images/points3D, .bin and .txt).

The port's own copy of ``preparation/colmap_model.py`` (the public COLMAP
model format), both halves: the readers, which the COLMAP preparation
backend (``preparation/main.run_colmap_backend``) uses for the
registration order, and the writers, which ``utils/export.
export_colmap_model`` uses. Records: ``ColmapCamera`` (with ``K()`` for
the pinhole family), ``ColmapImage``, ``ColmapPoint3D``;
``qvec_to_rotmat`` / ``rotmat_to_qvec``; ``read_model`` / ``write_model``.
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


def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.asarray([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def read_images_txt(path: str) -> Dict[int, ColmapImage]:
    # blank observation lines are significant (an image with zero 2D
    # points still owns a second line in the COLMAP format), so keep them
    # and pair header/observation lines explicitly
    images = {}
    with open(path) as f:
        lines = [l.strip() for l in f if not l.startswith("#")]
    i = 0
    while i < len(lines):
        if not lines[i]:
            i += 1
            continue
        parts = lines[i].split()
        image_id = int(parts[0])
        qvec = np.asarray(list(map(float, parts[1:5])))
        tvec = np.asarray(list(map(float, parts[5:8])))
        obs = lines[i + 1].split() if i + 1 < len(lines) else []
        if obs:
            vals = np.asarray(list(map(float, obs))).reshape(-1, 3)
            xys, p3d = vals[:, :2], vals[:, 2].astype(np.int64)
        else:
            xys, p3d = None, None
        images[image_id] = ColmapImage(image_id, qvec, tvec,
                                       int(parts[8]), parts[9], xys, p3d)
        i += 2
    return images


def read_images_bin(path: str) -> Dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            image_id = struct.unpack("<I", f.read(4))[0]
            qvec = np.asarray(struct.unpack("<4d", f.read(32)))
            tvec = np.asarray(struct.unpack("<3d", f.read(24)))
            camera_id = struct.unpack("<I", f.read(4))[0]
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            n2d = struct.unpack("<Q", f.read(8))[0]
            xys, p3d = None, None
            if n2d:
                vals = struct.unpack("<" + "ddq" * n2d, f.read(24 * n2d))
                xys = np.asarray(vals, np.float64).reshape(-1, 3)[:, :2]
                p3d = np.asarray(vals[2::3], np.int64)
            images[image_id] = ColmapImage(image_id, qvec, tvec,
                                           camera_id, name.decode(), xys, p3d)
    return images


def read_images(model_dir: str) -> Dict[int, ColmapImage]:
    bin_path = os.path.join(model_dir, "images.bin")
    txt_path = os.path.join(model_dir, "images.txt")
    if os.path.exists(bin_path):
        return read_images_bin(bin_path)
    if os.path.exists(txt_path):
        return read_images_txt(txt_path)
    raise FileNotFoundError(f"no images.bin/txt in {model_dir}")


# ---------------------------------------------------------------- cameras
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

    def K(self) -> np.ndarray:
        """3x3 intrinsic matrix. Pinhole-family layouts:
        SIMPLE_* = (f, cx, cy[, k...]), others = (fx, fy, cx, cy[, k...])."""
        p = self.params
        if self.model.startswith("SIMPLE_") or self.model == "FOV":
            fx = fy = p[0]
            cx, cy = p[1], p[2]
        else:
            fx, fy, cx, cy = p[0], p[1], p[2], p[3]
        return np.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)


def read_cameras_txt(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cams[int(parts[0])] = ColmapCamera(
                int(parts[0]), parts[1], int(parts[2]), int(parts[3]),
                np.asarray(list(map(float, parts[4:]))))
    return cams


def read_cameras_bin(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            cid, model_id, w, h = struct.unpack("<IiQQ", f.read(24))
            name, n_params = CAMERA_MODEL_PARAMS[model_id]
            params = np.asarray(struct.unpack(f"<{n_params}d",
                                              f.read(8 * n_params)))
            cams[cid] = ColmapCamera(cid, name, w, h, params)
    return cams


def read_cameras(model_dir: str) -> Dict[int, ColmapCamera]:
    bin_path = os.path.join(model_dir, "cameras.bin")
    txt_path = os.path.join(model_dir, "cameras.txt")
    if os.path.exists(bin_path):
        return read_cameras_bin(bin_path)
    if os.path.exists(txt_path):
        return read_cameras_txt(txt_path)
    raise FileNotFoundError(f"no cameras.bin/txt in {model_dir}")


# --------------------------------------------------------------- points3D
@dataclass
class ColmapPoint3D:
    point3D_id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


def read_points3D_txt(path: str) -> Dict[int, ColmapPoint3D]:
    pts = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            track = np.asarray(list(map(int, parts[8:])))
            pts[int(parts[0])] = ColmapPoint3D(
                int(parts[0]),
                np.asarray(list(map(float, parts[1:4]))),
                np.asarray(list(map(int, parts[4:7])), np.uint8),
                float(parts[7]), track[0::2], track[1::2])
    return pts


def read_points3D_bin(path: str) -> Dict[int, ColmapPoint3D]:
    pts = {}
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            pid = struct.unpack("<Q", f.read(8))[0]
            xyz = np.asarray(struct.unpack("<3d", f.read(24)))
            rgb = np.asarray(struct.unpack("<3B", f.read(3)), np.uint8)
            error = struct.unpack("<d", f.read(8))[0]
            track_len = struct.unpack("<Q", f.read(8))[0]
            track = np.asarray(struct.unpack(f"<{2 * track_len}i",
                                             f.read(8 * track_len)))
            pts[pid] = ColmapPoint3D(pid, xyz, rgb, error,
                                     track[0::2], track[1::2])
    return pts


def read_points3D(model_dir: str) -> Dict[int, ColmapPoint3D]:
    bin_path = os.path.join(model_dir, "points3D.bin")
    txt_path = os.path.join(model_dir, "points3D.txt")
    if os.path.exists(bin_path):
        return read_points3D_bin(bin_path)
    if os.path.exists(txt_path):
        return read_points3D_txt(txt_path)
    raise FileNotFoundError(f"no points3D.bin/txt in {model_dir}")


def read_model(model_dir: str):
    """(cameras, images, points3D) — the reference's read_model surface."""
    return (read_cameras(model_dir), read_images(model_dir),
            read_points3D(model_dir))


# ---------------------------------------------------------------- writers
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
