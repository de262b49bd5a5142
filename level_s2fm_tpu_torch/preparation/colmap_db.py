"""Minimal COLMAP SQLite database access (read/write).

The port's own copy of ``preparation/colmap_db.py``: the standard,
publicly documented COLMAP database schema (cameras/images/keypoints/
descriptors/matches/two_view_geometries) through the standard library's
``sqlite3``. The COLMAP preparation backend reads keypoints, matches and
verified inliers from it.

pair_id convention: pair_id = image_id1 * 2147483647 + image_id2 with
image_id1 < image_id2 (COLMAP's public on-disk format).
"""
from __future__ import annotations

import sqlite3
from typing import Dict, Tuple

import numpy as np

MAX_IMAGE_ID = 2147483647


def pair_id_to_image_ids(pair_id: int) -> Tuple[int, int]:
    image_id2 = pair_id % MAX_IMAGE_ID
    image_id1 = (pair_id - image_id2) // MAX_IMAGE_ID
    return int(image_id1), int(image_id2)


def image_ids_to_pair_id(image_id1: int, image_id2: int) -> int:
    if image_id1 > image_id2:
        image_id1, image_id2 = image_id2, image_id1
    return image_id1 * MAX_IMAGE_ID + image_id2


def _blob_to_array(blob, dtype, shape=(-1,)):
    if blob is None:
        return np.zeros(0, dtype).reshape(shape if -1 not in shape else (0,))
    return np.frombuffer(blob, dtype=dtype).reshape(*shape)


def _array_to_blob(arr: np.ndarray) -> bytes:
    return np.ascontiguousarray(arr).tobytes()


#: The full public COLMAP database schema (camera/image/feature/match
#: tables + uniqueness indices) — write-side parity with the reference's
#: `preparation/database.py:1-356` CREATE_*_TABLE statements. The schema
#: is COLMAP's documented on-disk format, authored here from that format.
_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL,
    width INTEGER NOT NULL,
    height INTEGER NOT NULL,
    params BLOB,
    prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE,
    camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL,
    CONSTRAINT image_id_check CHECK(image_id >= 0 and image_id < 2147483647),
    FOREIGN KEY(camera_id) REFERENCES cameras(camera_id));
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    config INTEGER NOT NULL,
    F BLOB, E BLOB, H BLOB, qvec BLOB, tvec BLOB);
CREATE UNIQUE INDEX IF NOT EXISTS index_name ON images(name);
"""

#: COLMAP camera-model name -> integer id (public enum order)
CAMERA_MODELS = {"SIMPLE_PINHOLE": 0, "PINHOLE": 1, "SIMPLE_RADIAL": 2,
                 "RADIAL": 3, "OPENCV": 4, "OPENCV_FISHEYE": 5,
                 "FULL_OPENCV": 6, "FOV": 7, "SIMPLE_RADIAL_FISHEYE": 8,
                 "RADIAL_FISHEYE": 9, "THIN_PRISM_FISHEYE": 10}


class ColmapDatabase:
    def __init__(self, path: str):
        self.conn = sqlite3.connect(path)

    def close(self):
        self.conn.close()

    def commit(self):
        self.conn.commit()

    # ------------------------------------------------------------- write
    def create_tables(self):
        """Create the full COLMAP schema (idempotent)."""
        self.conn.executescript(_SCHEMA)

    def add_camera(self, model, width: int, height: int, params,
                   prior_focal_length: bool = False,
                   camera_id: int = None) -> int:
        if isinstance(model, str):
            model = CAMERA_MODELS[model]
        cur = self.conn.execute(
            "INSERT INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
            (camera_id, int(model), int(width), int(height),
             _array_to_blob(np.asarray(params, np.float64)),
             int(prior_focal_length)))
        return cur.lastrowid

    def add_image(self, name: str, camera_id: int, prior_q=(None,) * 4,
                  prior_t=(None,) * 3, image_id: int = None) -> int:
        cur = self.conn.execute(
            "INSERT INTO images VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image_id, name, int(camera_id), *prior_q, *prior_t))
        return cur.lastrowid

    def add_keypoints(self, image_id: int, keypoints: np.ndarray):
        """keypoints [N, >=2] float32 (x, y[, scale, orientation])."""
        kp = np.asarray(keypoints, np.float32)
        assert kp.ndim == 2 and kp.shape[1] in (2, 4, 6)
        self.conn.execute(
            "INSERT INTO keypoints VALUES (?, ?, ?, ?)",
            (int(image_id), kp.shape[0], kp.shape[1], _array_to_blob(kp)))

    def add_descriptors(self, image_id: int, descriptors: np.ndarray):
        d = np.asarray(descriptors, np.uint8)
        self.conn.execute(
            "INSERT INTO descriptors VALUES (?, ?, ?, ?)",
            (int(image_id), d.shape[0], d.shape[1], _array_to_blob(d)))

    def add_matches(self, image_id1: int, image_id2: int,
                    matches: np.ndarray):
        m = np.asarray(matches, np.uint32)
        assert m.ndim == 2 and m.shape[1] == 2
        if image_id1 > image_id2:  # pair_id is order-normalized
            m = m[:, ::-1]
        self.conn.execute(
            "INSERT INTO matches VALUES (?, ?, ?, ?)",
            (image_ids_to_pair_id(image_id1, image_id2),
             m.shape[0], m.shape[1], _array_to_blob(m)))

    def add_two_view_geometry(self, image_id1: int, image_id2: int,
                              matches: np.ndarray, F=None, E=None, H=None,
                              qvec=None, tvec=None, config: int = 2):
        m = np.asarray(matches, np.uint32)
        assert m.ndim == 2 and m.shape[1] == 2
        if image_id1 > image_id2:
            m = m[:, ::-1]

        def b(x, n):
            return _array_to_blob(np.asarray(
                x if x is not None else np.eye(3)[:n], np.float64))

        self.conn.execute(
            "INSERT INTO two_view_geometries VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image_ids_to_pair_id(image_id1, image_id2),
             m.shape[0], m.shape[1], _array_to_blob(m), int(config),
             b(F, 3), b(E, 3), b(H, 3),
             _array_to_blob(np.asarray(qvec if qvec is not None
                                       else [1.0, 0, 0, 0], np.float64)),
             _array_to_blob(np.asarray(tvec if tvec is not None
                                       else [0.0, 0, 0], np.float64))))

    # -------------------------------------------------------------- read

    def image_names(self) -> Dict[int, str]:
        rows = self.conn.execute("SELECT image_id, name FROM images").fetchall()
        return {int(i): n for i, n in rows}

    def cameras(self) -> Dict[int, dict]:
        out = {}
        for cid, model, w, h, params, prior in self.conn.execute(
                "SELECT camera_id, model, width, height, params, "
                "prior_focal_length FROM cameras"):
            out[int(cid)] = {"model": int(model), "width": int(w),
                             "height": int(h),
                             "params": _blob_to_array(params, np.float64),
                             "prior_focal_length": bool(prior)}
        return out

    def keypoints(self) -> Dict[int, np.ndarray]:
        out = {}
        for image_id, rows, cols, blob in self.conn.execute(
                "SELECT image_id, rows, cols, data FROM keypoints"):
            arr = _blob_to_array(blob, np.float32, (rows, cols))
            out[int(image_id)] = arr[:, :2].copy()
        return out

    def descriptors(self) -> Dict[int, np.ndarray]:
        out = {}
        for image_id, rows, cols, blob in self.conn.execute(
                "SELECT image_id, rows, cols, data FROM descriptors"):
            out[int(image_id)] = _blob_to_array(blob, np.uint8, (rows, cols)).copy()
        return out

    def matches(self, table: str = "matches") -> Dict[Tuple[int, int], np.ndarray]:
        assert table in ("matches", "two_view_geometries")
        out = {}
        for pair_id, rows, cols, blob in self.conn.execute(
                f"SELECT pair_id, rows, cols, data FROM {table}"):
            if rows == 0:
                continue
            arr = _blob_to_array(blob, np.uint32, (rows, cols))[:, :2]
            out[pair_id_to_image_ids(pair_id)] = arr.astype(np.int64).copy()
        return out

    def two_view_geometries(self) -> Dict[Tuple[int, int], np.ndarray]:
        return self.matches("two_view_geometries")
