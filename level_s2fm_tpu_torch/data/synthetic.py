"""Synthetic scenes: self-contained stand-ins for prepared datasets.

Copy of ``level_s2fm_tpu/data/synthetic.py`` (the port imports nothing
of the JAX package), all numpy and seeded, so every array is bitwise
equal to the JAX package's:

* the sphere scene (``make_scene``): textured sphere of radius
  ``sphere_rad`` at the origin, cameras on a ring looking inward,
  keypoints = projections of shared surface points, all-pairs match
  matrix with inlier masks, pose graph and ray-cast images;
* the hard scene (``make_hard_scene_images``): four textured SDF objects
  that occlude each other, sphere-traced from a full orbit
  (``data/synthhard``, ``configs/synthhard*.yaml``);
* the multiroom scene (``make_multiroom_scene``): two rooms joined by a
  doorway with furniture, traced from inside, with z-depth
  (``data/scannet/multiroom0``, ``configs/scannet_multiroom*.yaml``).

``python -m level_s2fm_tpu_torch.make_synthetic_dataset`` writes them to
disk in the layouts the loaders read.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


def _look_at_w2c(cam_pos: np.ndarray, target: np.ndarray, up=(0, 1, 0)) -> np.ndarray:
    """Build a w2c [3,4] pose for a camera at cam_pos looking at target."""
    z = target - cam_pos
    z = z / np.linalg.norm(z)
    x = np.cross(np.asarray(up, np.float64), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    R_c2w = np.stack([x, y, z], axis=1)  # columns are camera axes in world
    R = R_c2w.T
    t = -R @ cam_pos
    return np.concatenate([R, t[:, None]], axis=1).astype(np.float32)


def _sphere_color(p: np.ndarray, detail: float = 0.0) -> np.ndarray:
    """Position-dependent albedo in (0.1, 0.9). ``detail`` adds
    high-frequency bands so SIFT finds corners on rendered images (needed
    when a scene goes through the real preparation pipeline)."""
    s = np.stack([np.sin(3.1 * p[..., 0]) * np.cos(2.3 * p[..., 1]),
                  np.sin(2.7 * p[..., 1]) * np.cos(3.7 * p[..., 2]),
                  np.sin(1.9 * p[..., 2]) * np.cos(2.9 * p[..., 0])], axis=-1)
    c = 0.5 + 0.4 * s
    if detail > 0:
        c = np.clip(c + detail * (_random_texture(p) - 0.5), 0.05, 0.95)
    return c


_TEX_CACHE = {}


def _random_texture(p: np.ndarray, res: int = 256, seed: int = 1234):
    """Non-repeating random texture sampled by spherical coordinates.

    A periodic analytic texture self-matches under SIFT's ratio test;
    a seeded random map gives every surface patch a unique fingerprint,
    which is what the real preparation pipeline needs."""
    key = (res, seed)
    if key not in _TEX_CACHE:
        rng = np.random.default_rng(seed)
        # LUMINANCE-correlated noise: SIFT detects on the grayscale image,
        # so per-channel-independent noise cancels ~1/sqrt(3) in gray and
        # the detector starves (measured: 13 vs ~400 keypoints at 320px).
        # One shared luminance field plus a small chroma tint keeps the
        # gray-plane contrast while still exercising the RGB loss.
        lum = rng.uniform(size=(res, res, 1)).astype(np.float32)
        tint = rng.uniform(size=(res, res, 3)).astype(np.float32)
        tex = lum + 0.15 * (tint - 0.5)
        # smooth to a feature scale of a few texels: sub-texel detail
        # aliases view-dependently and breaks descriptor matching
        for _ in range(5):
            tex = 0.5 * tex + 0.125 * (np.roll(tex, 1, 0) + np.roll(tex, -1, 0)
                                       + np.roll(tex, 1, 1) + np.roll(tex, -1, 1))
        t = tex - tex.mean()
        tex = 0.5 + 0.5 * t / (np.abs(t).max() + 1e-9)   # re-stretch contrast
        _TEX_CACHE[key] = tex.astype(np.float32)
    tex = _TEX_CACHE[key]
    r = np.linalg.norm(p, axis=-1) + 1e-12
    theta = np.arccos(np.clip(p[..., 2] / r, -1, 1)) / np.pi          # [0,1]
    phi = (np.arctan2(p[..., 1], p[..., 0]) + np.pi) / (2 * np.pi)    # [0,1]
    # bilinear sample
    uf = theta * (res - 1)
    vf = phi * (res - 1)
    u0 = np.clip(np.floor(uf).astype(np.int64), 0, res - 2)
    v0 = np.clip(np.floor(vf).astype(np.int64), 0, res - 2)
    du = (uf - u0)[..., None]
    dv = (vf - v0)[..., None]
    return (tex[u0, v0] * (1 - du) * (1 - dv) + tex[u0 + 1, v0] * du * (1 - dv)
            + tex[u0, v0 + 1] * (1 - du) * dv + tex[u0 + 1, v0 + 1] * du * dv)


def _raycast_sphere(pose_w2c, K, H, W, rad, detail: float = 0.0):
    """Analytic render of the textured sphere; returns [H,W,3] float32."""
    R, t = pose_w2c[:, :3], pose_w2c[:, 3]
    cam_pos = -R.T @ t
    ys, xs = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5, indexing="ij")
    pix = np.stack([xs, ys, np.ones_like(xs)], axis=-1).reshape(-1, 3)
    dirs_cam = pix @ np.linalg.inv(K).T
    dirs = dirs_cam @ R  # R.T @ d, batched
    oc = cam_pos
    a = np.sum(dirs * dirs, axis=-1)
    b = 2 * dirs @ oc
    c = oc @ oc - rad ** 2
    disc = b * b - 4 * a * c
    hit = disc > 0
    tdep = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a), 0.0)
    pts = cam_pos[None] + tdep[:, None] * dirs
    img = np.zeros((H * W, 3), np.float32)
    img[hit] = _sphere_color(pts[hit], detail=detail)
    return img.reshape(H, W, 3)


# ---------------------------------------------------------------------------
# Multi-object SDF scene — the round-3 "hard" benchmark geometry
# (VERDICT r2 item 1: multi-object / non-sphere with occlusions, realistic
# non-repeating texture, rendered for the REAL SIFT preparation path).
# ---------------------------------------------------------------------------

def _rot_y(deg):
    a = np.deg2rad(deg)
    return np.asarray([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                       [-np.sin(a), 0, np.cos(a)]], np.float64)


def _rot_x(deg):
    a = np.deg2rad(deg)
    return np.asarray([[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                       [0, np.sin(a), np.cos(a)]], np.float64)


def _sdf_sphere(p, c, r):
    return np.linalg.norm(p - c, axis=-1) - r


def _sdf_box(p, c, half, R=None):
    q = p - c
    if R is not None:
        q = q @ R  # world->object (R columns = object axes)
    q = np.abs(q) - half
    outside = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
    inside = np.minimum(np.max(q, axis=-1), 0.0)
    return outside + inside


def _sdf_torus(p, c, R_maj, r_min, R=None):
    q = p - c
    if R is not None:
        q = q @ R
    ring = np.sqrt(q[..., 0] ** 2 + q[..., 2] ** 2) - R_maj
    return np.sqrt(ring ** 2 + q[..., 1] ** 2) - r_min


# (kind, params, texture seed, texture res) — all inside |x|<0.72 so the
# scene fits the [-1,1] field bounds with cameras on the ring_rad=2 orbit.
# Texture res is matched to each object's PROJECTED size (~60-150 px at
# 320px frames from the ring): sub-pixel texels alias view-dependently and
# starve SIFT (see `_random_texture`), so small objects get coarse maps.
_HARD_OBJECTS = (
    ("box",    dict(c=np.asarray([-0.27, -0.04, 0.02]),
                    half=np.asarray([0.24, 0.31, 0.20]),
                    R=_rot_y(28.0)),                         211, 320),
    ("sphere", dict(c=np.asarray([0.36, -0.15, 0.18]), r=0.25), 223, 96),
    ("torus",  dict(c=np.asarray([0.07, 0.30, -0.13]), R_maj=0.26,
                    r_min=0.10, R=_rot_x(55.0) @ _rot_y(20.0)), 229, 224),
    ("sphere", dict(c=np.asarray([0.30, 0.20, -0.38]), r=0.17), 239, 64),
)


def hard_scene_sdf(p: np.ndarray):
    """(sdf [.,], nearest object id [.,]) of the union scene."""
    ds = []
    for kind, kw, _seed, _res in _HARD_OBJECTS:
        if kind == "sphere":
            ds.append(_sdf_sphere(p, **kw))
        elif kind == "box":
            ds.append(_sdf_box(p, **kw))
        else:
            ds.append(_sdf_torus(p, **kw))
    ds = np.stack(ds, axis=-1)
    return ds.min(axis=-1), ds.argmin(axis=-1)


def _hard_albedo(p: np.ndarray, obj_id: np.ndarray) -> np.ndarray:
    """Per-object non-repeating texture (luminance-correlated — see
    `_random_texture`) sampled by spherical coords about each object's
    center, so every surface patch has a unique SIFT fingerprint."""
    out = np.zeros(p.shape, np.float32)
    for i, (_kind, kw, seed, res) in enumerate(_HARD_OBJECTS):
        m = obj_id == i
        if not m.any():
            continue
        q = p[m] - kw["c"]
        # fine grain at FULL contrast (SIFT's detector lives off the fine
        # gradients — averaging in a coarse octave starves it, measured
        # 209 -> 95 kypts/img), multiplicatively modulated by a coarse
        # octave for large-scale structure
        fine = _random_texture(q, res=res, seed=seed)
        coarse = _random_texture(q, res=max(res // 3, 16), seed=seed + 1)
        tex = fine * (0.75 + 0.5 * (coarse - 0.5))
        out[m] = 0.08 + 0.9 * np.clip(tex, 0.0, 1.0)
    return out


def render_hard_view(pose_w2c: np.ndarray, K: np.ndarray, H: int, W: int,
                     max_steps: int = 96, eps: float = 2e-4,
                     t_max: float = 4.5) -> np.ndarray:
    """Sphere-trace the union SDF and shade lambertian (one directional
    light + ambient) with per-object texture. Background stays black (the
    synthprep convention, bgcolor [0,0,0])."""
    R, t = pose_w2c[:, :3], pose_w2c[:, 3]
    cam_pos = -R.T @ t
    ys, xs = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5, indexing="ij")
    pix = np.stack([xs, ys, np.ones_like(xs)], axis=-1).reshape(-1, 3)
    dirs = (pix @ np.linalg.inv(K).T) @ R
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)

    n = dirs.shape[0]
    tcur = np.full(n, 0.5, np.float64)       # objects are >1.3 from cameras
    alive = np.ones(n, bool)
    for _ in range(max_steps):
        idx = np.where(alive)[0]
        if idx.size == 0:
            break
        p = cam_pos[None] + tcur[idx, None] * dirs[idx]
        d, _ = hard_scene_sdf(p)
        tcur[idx] += d
        hit_now = d < eps
        dead = hit_now | (tcur[idx] > t_max)
        alive[idx[dead]] = False
    p = cam_pos[None] + tcur[:, None] * dirs
    d, obj_id = hard_scene_sdf(p)
    hit = (d < 10 * eps) & (tcur < t_max)

    img = np.zeros((n, 3), np.float32)
    if hit.any():
        ph = p[hit]
        # central-difference normals of the union SDF
        h = 1e-3
        grads = []
        for ax in range(3):
            e = np.zeros(3)
            e[ax] = h
            grads.append(hard_scene_sdf(ph + e)[0] - hard_scene_sdf(ph - e)[0])
        nrm = np.stack(grads, axis=-1)
        nrm = nrm / (np.linalg.norm(nrm, axis=-1, keepdims=True) + 1e-12)
        light = np.asarray([0.45, 0.8, -0.4])
        light = light / np.linalg.norm(light)
        lam = np.clip(nrm @ light, 0.0, 1.0)
        shade = (0.62 + 0.38 * lam)[:, None]
        img[hit] = np.clip(_hard_albedo(ph, obj_id[hit]) * shade, 0.0, 1.0)
    return img.reshape(H, W, 3)


def hard_scene_cameras(n_views=32, H=400, W=400, ring_rad=1.6,
                       look_at=(0.0, 0.05, 0.0), full_orbit=True):
    """(K [3,3], poses w2c [N,3,4]) of ``make_hard_scene_images``, without
    rendering: any view of a scene on disk can be rendered alone."""
    f = 0.9 * W
    K = np.asarray([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    span = 2 * np.pi if full_orbit else 0.2356 * n_views
    poses = []
    for i in range(n_views):
        ang = span * i / n_views
        cam_pos = np.asarray([ring_rad * np.sin(ang),
                              0.38 + 0.22 * np.sin(2.2 * ang + 0.7),
                              -ring_rad * np.cos(ang)])
        poses.append(_look_at_w2c(cam_pos, np.asarray(look_at, np.float64)))
    return K, np.stack(poses)


def make_hard_scene_images(n_views=32, H=400, W=400, ring_rad=1.6,
                           look_at=(0.0, 0.05, 0.0), full_orbit=True):
    """Images + GT cameras for the hard benchmark: a full 360-degree orbit
    with vertical wobble over the 4-object scene (objects occlude each
    other as the camera passes). Returns (images [N,H,W,3], intrs, poses
    w2c [N,3,4])."""
    K, poses = hard_scene_cameras(n_views, H, W, ring_rad, look_at, full_orbit)
    images = [render_hard_view(pose, K, H, W) for pose in poses]
    return (np.stack(images), np.broadcast_to(K, (n_views, 3, 3)).copy(),
            poses)


# ---------------------------------------------------------------------------
# Multi-room indoor scene (ScanNet-layout; configs/scannet_multiroom.yaml)
# — two rooms joined by a doorway, furniture, inside-out trajectory.
# ---------------------------------------------------------------------------

_MR_ROOM_A = dict(c=np.asarray([-1.75, 0.0, 0.0]),
                  half=np.asarray([1.65, 1.5, 2.2]))
_MR_ROOM_B = dict(c=np.asarray([1.75, 0.0, 0.0]),
                  half=np.asarray([1.65, 1.5, 2.2]))
_MR_DOOR = dict(c=np.asarray([0.0, -0.35, 0.0]),
                half=np.asarray([0.45, 1.15, 0.7]))
_MR_FURNITURE = (
    ("box",    dict(c=np.asarray([-2.55, -1.05, -1.35]),
                    half=np.asarray([0.45, 0.45, 0.5]), R=_rot_y(15.0)), 311),
    ("sphere", dict(c=np.asarray([-1.15, -0.95, 1.45]), r=0.5),          313),
    ("box",    dict(c=np.asarray([2.45, -0.85, 1.25]),
                    half=np.asarray([0.5, 0.65, 0.45]), R=_rot_y(-25.0)), 317),
    ("torus",  dict(c=np.asarray([1.55, -1.15, -1.45]), R_maj=0.45,
                    r_min=0.18, R=_rot_x(90.0)),                          331),
)


def multiroom_sdf(p: np.ndarray):
    """Solid-space SDF of the two-room scene: free space is the union of
    both room interiors and the doorway; walls = its complement; plus
    solid furniture. Returns (sdf, surface id) — ids 0..2 are roomA/roomB/
    door shells, 3+ the furniture."""
    free = np.stack([_sdf_box(p, **_MR_ROOM_A), _sdf_box(p, **_MR_ROOM_B),
                     _sdf_box(p, **_MR_DOOR)], axis=-1)
    solid_walls = -free.min(axis=-1)
    wall_id = free.argmin(axis=-1)
    ds = [solid_walls]
    for kind, kw, _seed in _MR_FURNITURE:
        if kind == "sphere":
            ds.append(_sdf_sphere(p, **kw))
        elif kind == "box":
            ds.append(_sdf_box(p, **kw))
        else:
            ds.append(_sdf_torus(p, **kw))
    ds = np.stack(ds, axis=-1)
    which = ds.argmin(axis=-1)
    sid = np.where(which == 0, wall_id, which + 2)
    return ds.min(axis=-1), sid


def _planar_texture(u: np.ndarray, v: np.ndarray, res: int, seed: int,
                    scale: float = 24.0):
    # scale=24 with res=512 => ~21 texels/unit => feature scale ~4-10 px
    # at 1.5-3 unit indoor viewing distances (f=0.75*384); finer maps
    # alias sub-pixel and starve SIFT (same failure as _HARD_OBJECTS)
    """Sample the cached random map planarly (walls are too large for the
    spherical mapping `_random_texture` uses)."""
    key = (res, seed)
    if key not in _TEX_CACHE:
        _random_texture(np.zeros((1, 3)), res=res, seed=seed)  # warm cache
    tex = _TEX_CACHE[key]
    uf = np.mod(u / scale, 1.0) * (res - 2)
    vf = np.mod(v / scale, 1.0) * (res - 2)
    u0 = np.floor(uf).astype(np.int64)
    v0 = np.floor(vf).astype(np.int64)
    du = (uf - u0)[..., None]
    dv = (vf - v0)[..., None]
    return (tex[u0, v0] * (1 - du) * (1 - dv) + tex[u0 + 1, v0] * du * (1 - dv)
            + tex[u0, v0 + 1] * (1 - du) * dv
            + tex[u0 + 1, v0 + 1] * du * dv)


def _multiroom_albedo(p: np.ndarray, sid: np.ndarray,
                      nrm: np.ndarray) -> np.ndarray:
    out = np.zeros(p.shape, np.float32)
    walls = sid <= 2
    if walls.any():
        # triplanar by dominant normal axis; (surface id, axis) seeds a
        # distinct non-repeating map per wall family
        ax = np.argmax(np.abs(nrm[walls]), axis=-1)
        pw = p[walls]
        sw = sid[walls]
        tex = np.zeros((pw.shape[0], 3), np.float32)
        for a in range(3):
            m = ax == a
            if not m.any():
                continue
            u_ax, v_ax = [i for i in range(3) if i != a]
            for room in range(3):
                mm = m & (sw == room)
                if not mm.any():
                    continue
                tex[mm] = _planar_texture(pw[mm][:, u_ax], pw[mm][:, v_ax],
                                          res=512, seed=401 + 7 * room + a)
        out[walls] = 0.25 + 0.7 * tex
    for i, (_kind, kw, seed) in enumerate(_MR_FURNITURE):
        m = sid == i + 3
        if not m.any():
            continue
        fine = _random_texture(p[m] - kw["c"], res=160, seed=seed)
        out[m] = 0.1 + 0.85 * fine
    return out


def render_multiroom_view(pose_w2c: np.ndarray, K: np.ndarray, H: int,
                          W: int, max_steps: int = 128, eps: float = 4e-4,
                          t_max: float = 12.0):
    """Sphere-trace the indoor scene from inside; returns (rgb [H,W,3],
    z-depth [H,W] — 0 where unconverged, the ScanNet missing-value
    convention)."""
    R, t = pose_w2c[:, :3], pose_w2c[:, 3]
    cam_pos = -R.T @ t
    ys, xs = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5, indexing="ij")
    pix = np.stack([xs, ys, np.ones_like(xs)], axis=-1).reshape(-1, 3)
    dirs_cam = pix @ np.linalg.inv(K).T
    dirs = dirs_cam @ R
    nlen = np.linalg.norm(dirs, axis=-1, keepdims=True)
    dunit = dirs / nlen

    n = dunit.shape[0]
    tcur = np.full(n, 0.05, np.float64)
    alive = np.ones(n, bool)
    for _ in range(max_steps):
        idx = np.where(alive)[0]
        if idx.size == 0:
            break
        p = cam_pos[None] + tcur[idx, None] * dunit[idx]
        d, _ = multiroom_sdf(p)
        tcur[idx] += np.maximum(d, 1e-5)
        alive[idx[(d < eps) | (tcur[idx] > t_max)]] = False
    p = cam_pos[None] + tcur[:, None] * dunit
    d, sid = multiroom_sdf(p)
    hit = (d < 20 * eps) & (tcur < t_max)

    img = np.zeros((n, 3), np.float32)
    zdepth = np.zeros(n, np.float32)
    if hit.any():
        ph = p[hit]
        h = 2e-3
        grads = []
        for axi in range(3):
            e = np.zeros(3)
            e[axi] = h
            grads.append(multiroom_sdf(ph + e)[0] - multiroom_sdf(ph - e)[0])
        nrm = np.stack(grads, axis=-1)
        nrm = nrm / (np.linalg.norm(nrm, axis=-1, keepdims=True) + 1e-12)
        light = np.asarray([0.3, 0.9, 0.3])
        light = light / np.linalg.norm(light)
        lam = np.abs(nrm @ light)           # interior: unsigned lambertian
        shade = (0.55 + 0.45 * lam)[:, None]
        img[hit] = np.clip(
            _multiroom_albedo(ph, sid[hit], nrm) * shade, 0.0, 1.0)
        zdepth[hit] = ((ph - cam_pos) @ R.T[:, 2]).astype(np.float32)
    return img.reshape(H, W, 3), zdepth.reshape(H, W)


def multiroom_cameras(n_views=24, H=384, W=384):
    """(K [3,3], poses w2c [N,3,4]) of ``make_multiroom_scene``, without
    rendering."""
    f = 0.75 * W                             # wide-ish indoor FOV
    K = np.asarray([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    # piecewise path: positions and look-targets per keyframe
    s = np.linspace(0.0, 1.0, n_views)
    px = np.interp(s, [0, 0.28, 0.5, 0.72, 1.0],
                   [-2.6, -1.3, 0.0, 1.2, 2.2])
    pz = 0.85 * np.sin(s * np.pi * 2.1)
    py = 0.25 + 0.08 * np.sin(s * 13.0)
    # look mostly forward along +x while in room A / the door, then pan
    # back into room B's interior at the end (staring into the east wall
    # from <1 unit starves SIFT — measured 0 inliers on the final pair)
    lx = np.interp(s, [0, 0.3, 0.55, 0.8, 1.0],
                   [-0.7, 0.6, 2.0, 2.9, 1.2])
    lz = 1.1 * np.cos(s * np.pi * 1.7)
    ly = 0.0 * s
    poses = [_look_at_w2c(np.asarray([px[i], py[i], pz[i]]),
                          np.asarray([lx[i], ly[i], lz[i]]))
             for i in range(n_views)]
    return K, np.stack(poses)


def make_multiroom_scene(n_views=24, H=384, W=384):
    """Inside-out trajectory: sweep room A, pass through the doorway,
    sweep room B. Returns (images, depths [z, meters], intrs, poses w2c)."""
    K, poses = multiroom_cameras(n_views, H, W)
    images, depths = zip(*[render_multiroom_view(pose, K, H, W) for pose in poses])
    return (np.stack(images), np.stack(depths),
            np.broadcast_to(K, (n_views, 3, 3)).copy(), poses)


@dataclasses.dataclass
class SyntheticScene:
    images: np.ndarray          # [N,H,W,3]
    intrs: np.ndarray           # [N,3,3]
    poses_gt: np.ndarray        # [N,3,4] w2c
    kypts: List[np.ndarray]     # per image [K,2]
    matches: List[List[np.ndarray]]      # [N][N-1] match index pairs
    masks: List[List[np.ndarray]]        # [N][N-1] inlier masks
    pose_graph: List[int]
    surface_pts: np.ndarray     # [M,3] GT surface points behind the keypoints


def make_scene(n_views=4, H=64, W=64, n_points=256, sphere_rad=0.5,
               ring_rad=2.0, seed=0, noise_px=0.0,
               detail: float = 0.0) -> SyntheticScene:
    rng = np.random.default_rng(seed)
    f = 0.9 * W
    K = np.asarray([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)

    # shared 3D surface points (front hemisphere-ish band so most are visible)
    pts = rng.normal(size=(n_points * 4, 3))
    pts = pts / np.linalg.norm(pts, axis=-1, keepdims=True) * sphere_rad
    pts = pts[: n_points]

    poses, images = [], []
    for i in range(n_views):
        # fixed arc step so the two-view baseline (~0.47 for ring_rad=2) is
        # independent of n_views — configs/synthetic.yaml's scale_init
        # assumes it
        ang = 0.2356 * i
        cam_pos = np.asarray([ring_rad * np.sin(ang), 0.35,
                              -ring_rad * np.cos(ang)])
        pose = _look_at_w2c(cam_pos, np.zeros(3))
        poses.append(pose)
        images.append(_raycast_sphere(pose, K, H, W, sphere_rad,
                                      detail=detail))
    poses = np.stack(poses)
    images = np.stack(images)

    # visibility: point visible if its normal faces the camera and projects in-frame
    kypts, vis_ids = [], []
    for i in range(n_views):
        R, t = poses[i][:, :3], poses[i][:, 3]
        cam_pos = -R.T @ t
        Xc = pts @ R.T + t
        uv = Xc @ K.T
        uv = uv[:, :2] / uv[:, 2:]
        facing = np.sum(pts / sphere_rad * (cam_pos[None] - pts), axis=-1) > 0
        inframe = (uv[:, 0] > 2) & (uv[:, 0] < W - 2) & (uv[:, 1] > 2) & (uv[:, 1] < H - 2)
        v = facing & inframe & (Xc[:, 2] > 0)
        ids = np.where(v)[0]
        uv_v = uv[ids].astype(np.float32)
        if noise_px > 0:
            uv_v = uv_v + rng.normal(scale=noise_px, size=uv_v.shape).astype(np.float32)
        kypts.append(uv_v)
        vis_ids.append(ids)

    # all-pairs symmetric matches through shared point ids
    matches = [[None] * (n_views - 1) for _ in range(n_views)]
    masks = [[None] * (n_views - 1) for _ in range(n_views)]
    for i in range(n_views):
        for j in range(n_views):
            if i == j:
                continue
            rel = j if j < i else j - 1
            common, ii, jj = np.intersect1d(vis_ids[i], vis_ids[j],
                                            return_indices=True)
            m = np.stack([ii, jj], axis=1).astype(np.int64)
            matches[i][rel] = m
            masks[i][rel] = np.ones(m.shape[0], bool)

    return SyntheticScene(images=images, intrs=np.broadcast_to(K, (n_views, 3, 3)).copy(),
                          poses_gt=poses, kypts=kypts, matches=matches, masks=masks,
                          pose_graph=list(range(n_views)), surface_pts=pts)


def scene_to_var(scene: SyntheticScene) -> Dict:
    """Package a scene the way the pipeline's `load_matches` does
    (ref `LevelS2fM.py:76-90`)."""
    return {
        "kypts": scene.kypts,
        "matches": scene.matches,
        "masks": scene.masks,
        "poses_gt": scene.poses_gt,
        "images": scene.images,
        "intrs": scene.intrs,
        "pose_graph": scene.pose_graph,
    }
