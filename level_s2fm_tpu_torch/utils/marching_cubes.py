"""Iso-surface extraction (marching tetrahedra) + PLY export, pure numpy.

The port's own copy of ``level_s2fm_tpu/utils/marching_cubes.py``: each
cell splits into 6 tetrahedra, each with 16 sign cases (1 or 2
triangles) handled without lookup tables, vectorized over the active
tetrahedra; duplicate vertices are welded. Runs on the host.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

_CORNER_OFFSETS = np.asarray([
    (0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
    (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)], np.int32)

# 6-tet decomposition of the cube around the main diagonal 0-6
_TETS = np.asarray([
    (0, 5, 1, 6), (0, 1, 2, 6), (0, 2, 3, 6),
    (0, 3, 7, 6), (0, 7, 4, 6), (0, 4, 5, 6)], np.int32)


def _interp(p0, p1, v0, v1, level):
    denom = v1 - v0
    t = np.where(np.abs(denom) > 1e-12,
                 (level - v0) / np.where(np.abs(denom) > 1e-12, denom, 1.0), 0.5)
    return p0 + np.clip(t, 0.0, 1.0)[..., None] * (p1 - p0)


def marching_cubes(volume: np.ndarray, level: float = 0.0,
                   origin=(0.0, 0.0, 0.0), spacing=(1.0, 1.0, 1.0),
                   slab_cells: int = 32) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the iso-surface of `volume` [Nx,Ny,Nz] at `level`.

    Returns (vertices [V,3] in world units, faces [F,3] int32).
    Processes the volume in z-slabs of `slab_cells` cells so peak host
    memory scales with the active-cell count, not Nx*Ny*Nz*8 (a dense
    512^3 corner table would be ~13 GB).
    """
    vol = np.asarray(volume, np.float64)
    nx, ny, nz = vol.shape
    cx, cy, cz = nx - 1, ny - 1, nz - 1

    pos_parts, val_parts = [], []
    for z0 in range(0, cz, slab_cells):
        z1 = min(z0 + slab_cells, cz)
        cells = np.stack(np.meshgrid(np.arange(cx), np.arange(cy),
                                     np.arange(z0, z1), indexing="ij"),
                         axis=-1).reshape(-1, 3)
        corner_pos = cells[:, None, :] + _CORNER_OFFSETS[None]      # [C,8,3]
        corner_val = vol[corner_pos[..., 0], corner_pos[..., 1],
                         corner_pos[..., 2]]
        # quick reject cells fully inside/outside
        below = corner_val < level
        active = ~(np.all(below, 1) | np.all(~below, 1))
        if active.any():
            pos_parts.append(corner_pos[active])
            val_parts.append(corner_val[active])
    if not pos_parts:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    return triangulate_cells(np.concatenate(pos_parts),
                             np.concatenate(val_parts), level=level,
                             origin=origin, spacing=spacing)


def triangulate_cells(corner_pos: np.ndarray, corner_val: np.ndarray,
                      level: float = 0.0, origin=(0.0, 0.0, 0.0),
                      spacing=(1.0, 1.0, 1.0)
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Marching-tetrahedra over an explicit cell list.

    corner_pos: [C,8,3] corner coordinates in INDEX units (cell corners in
    `_CORNER_OFFSETS` order); corner_val: [C,8] scalar field at the
    corners. The sparse entry point for octree/MISE-style extraction
    (ref `utils/util_vis.py:298-600` Extractor3D): callers pass only the
    cells near the surface. Welds duplicate vertices globally, so cells
    from different slabs/blocks stitch seamlessly.
    """
    corner_pos = np.asarray(corner_pos, np.float64)
    corner_val = np.asarray(corner_val, np.float64)
    below = corner_val < level
    active = ~(np.all(below, 1) | np.all(~below, 1))
    corner_pos = corner_pos[active]
    corner_val = corner_val[active]
    if corner_pos.shape[0] == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    tet_pos = corner_pos[:, _TETS, :]    # [C,6,4,3]
    tet_val = corner_val[:, _TETS]       # [C,6,4]
    tet_pos = tet_pos.reshape(-1, 4, 3)
    tet_val = tet_val.reshape(-1, 4)

    inside = tet_val < level             # [T,4]
    n_in = inside.sum(1)
    tris = []
    for flip in (False, True):
        # one vertex on one side, three on the other -> 1 triangle
        cnt = 1 if not flip else 3
        sel = n_in == cnt
        if not sel.any():
            continue
        pv, vv, iv = tet_pos[sel], tet_val[sel], inside[sel]
        lone = np.argmax(iv if cnt == 1 else ~iv, axis=1)           # [S]
        others = np.argsort(
            (np.arange(4)[None] == lone[:, None]), axis=1)[:, :3]   # [S,3]
        p_l = np.take_along_axis(pv, lone[:, None, None].repeat(3, 2), 1)[:, 0]
        v_l = np.take_along_axis(vv, lone[:, None], 1)[:, 0]
        tri = np.stack([
            _interp(p_l, np.take_along_axis(pv, others[:, k][:, None, None]
                                            .repeat(3, 2), 1)[:, 0],
                    v_l, np.take_along_axis(vv, others[:, k][:, None], 1)[:, 0],
                    level)
            for k in range(3)], axis=1)                              # [S,3,3]
        tris.append(tri)

    # two-and-two case -> quad -> 2 triangles
    sel = n_in == 2
    if sel.any():
        pv, vv, iv = tet_pos[sel], tet_val[sel], inside[sel]
        ia = np.argmax(iv, axis=1)
        ib = 3 - np.argmax(iv[:, ::-1], axis=1)
        oa = np.argmax(~iv, axis=1)
        ob = 3 - np.argmax((~iv)[:, ::-1], axis=1)

        def take_p(idx):
            return np.take_along_axis(pv, idx[:, None, None].repeat(3, 2), 1)[:, 0]

        def take_v(idx):
            return np.take_along_axis(vv, idx[:, None], 1)[:, 0]

        # quad corners: (a-oa), (a-ob), (b-ob), (b-oa)
        q0 = _interp(take_p(ia), take_p(oa), take_v(ia), take_v(oa), level)
        q1 = _interp(take_p(ia), take_p(ob), take_v(ia), take_v(ob), level)
        q2 = _interp(take_p(ib), take_p(ob), take_v(ib), take_v(ob), level)
        q3 = _interp(take_p(ib), take_p(oa), take_v(ib), take_v(oa), level)
        tris.append(np.stack([q0, q1, q2], axis=1))
        tris.append(np.stack([q0, q2, q3], axis=1))

    if not tris:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    tri_all = np.concatenate(tris, 0)                                # [F,3,3]
    verts = tri_all.reshape(-1, 3)
    faces = np.arange(verts.shape[0]).reshape(-1, 3)

    # weld duplicate vertices
    keys = np.round(verts * 1e6).astype(np.int64)
    _, uniq_idx, inv = np.unique(keys, axis=0, return_index=True,
                                 return_inverse=True)
    verts_u = verts[uniq_idx]
    faces_u = inv[faces]
    # drop degenerate faces
    ok = ((faces_u[:, 0] != faces_u[:, 1]) & (faces_u[:, 1] != faces_u[:, 2])
          & (faces_u[:, 0] != faces_u[:, 2]))
    faces_u = faces_u[ok]

    origin = np.asarray(origin, np.float64)
    spacing = np.asarray(spacing, np.float64)
    verts_w = verts_u * spacing[None] + origin[None]
    return verts_w.astype(np.float32), faces_u.astype(np.int64)


def write_ply(path: str, verts: np.ndarray, faces: np.ndarray = None,
              colors: np.ndarray = None):
    """Minimal ASCII PLY writer (mesh or point cloud)."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        if faces is not None:
            f.write(f"element face {len(faces)}\n")
            f.write("property list uchar int vertex_indices\n")
        f.write("end_header\n")
        if colors is not None:
            c8 = np.clip(colors * 255, 0, 255).astype(np.uint8)
            for v, c in zip(verts, c8):
                f.write(f"{v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n")
        else:
            for v in verts:
                f.write(f"{v[0]} {v[1]} {v[2]}\n")
        if faces is not None:
            for face in faces:
                f.write(f"3 {face[0]} {face[1]} {face[2]}\n")


def read_ply(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal ASCII PLY reader (for round-trip tests / the viewer)."""
    with open(path) as f:
        n_v = n_f = 0
        line = f.readline()
        while not line.startswith("end_header"):
            if line.startswith("element vertex"):
                n_v = int(line.split()[-1])
            elif line.startswith("element face"):
                n_f = int(line.split()[-1])
            line = f.readline()
        verts = np.asarray([list(map(float, f.readline().split()[:3]))
                            for _ in range(n_v)], np.float32)
        faces = np.asarray([list(map(int, f.readline().split()[1:4]))
                            for _ in range(n_f)], np.int64)
    return verts, faces
