"""Result export: meshes, point clouds, cameras, COLMAP model, renders.

Counterpart of ``level_s2fm_tpu/utils/export.py``: SDF zero-set meshes
(marching tetrahedra on the host; the SDF grid is evaluated on the
field's device in chunks of ``chunk`` points), the single-pass, PCA-box
and sparse-octree extractions, PLY point clouds, viewer camera JSON, a
COLMAP sparse model, sliced full-image renders (the uniform, uncompacted
composite: no occupancy grid, so no composite kernel), sphere-traced
depth and normals, the GT-depth evaluation, novel-view videos and the
``--get_result`` bundle ``export_results``. Images are written with the
port's PNG writer; JPEG and video need Pillow / imageio / OpenCV, each
imported only where it is used.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from ..fields import sdf as sdf_mod
from ..geometry import transforms as T
from ..rendering import renderer as ren_mod
from . import marching_cubes as mc
from . import png


def _device(params):
    return params["sdf"]["table"].device


@torch.no_grad()
def _eval_sdf_chunked(params, sdf_cfg, pts, chunk):
    """SDF at host points [N,3] -> numpy float32 [N], evaluated on the
    field's device ``chunk`` points at a time."""
    dev = _device(params)
    pts = np.asarray(pts, np.float32)
    vals = []
    for i in range(0, pts.shape[0], chunk):
        x = torch.as_tensor(pts[i:i + chunk]).to(dev)
        vals.append(sdf_mod.infer_sdf(params["sdf"], sdf_cfg, x)[..., 0]
                    .float().cpu().numpy())
    if not vals:
        return np.zeros((0,), np.float32)
    return np.concatenate(vals)


def extract_mesh(params, sdf_cfg, path: str, resolution: int = 256,
                 grid_boundary=(-1.0, 1.0), level: float = 0.0,
                 chunk: int = 65536):
    """Marching-tetrahedra mesh of the SDF zero set over a cube."""
    lo, hi = grid_boundary
    xs = np.linspace(lo, hi, resolution, dtype=np.float32)
    grid = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), axis=-1).reshape(-1, 3)
    vol = _eval_sdf_chunked(params, sdf_cfg, grid, chunk)
    vol = vol.reshape(resolution, resolution, resolution)
    spacing = (hi - lo) / (resolution - 1)
    verts, faces = mc.marching_cubes(vol, level=level, origin=(lo, lo, lo),
                                     spacing=(spacing,) * 3)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    mc.write_ply(path, verts, faces)
    return verts, faces


def extract_mesh_high_res(params, sdf_cfg, path: str, resolution: int = 512,
                          low_resolution: int = 100,
                          grid_boundary=(-1.0, 1.0), level: float = 0.0,
                          chunk: int = 65536):
    """Two-pass mesh: a low-resolution pass finds the surface, PCA of its
    vertices fits a tight principal-axis box, and the high-resolution pass
    grids that box. Falls back to the single-pass mesh when a pass finds
    no surface."""
    lo, hi = grid_boundary

    def eval_grid(pts):
        return _eval_sdf_chunked(params, sdf_cfg, pts, chunk)

    xs = np.linspace(lo, hi, low_resolution, dtype=np.float32)
    grid = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1).reshape(-1, 3)
    vol = eval_grid(grid).reshape(low_resolution, low_resolution, low_resolution)
    sp = (hi - lo) / (low_resolution - 1)
    verts, faces = mc.marching_cubes(vol, level=level, origin=(lo, lo, lo),
                                     spacing=(sp,) * 3)
    if len(verts) == 0:
        return extract_mesh(params, sdf_cfg, path, resolution=resolution,
                            grid_boundary=grid_boundary, level=level,
                            chunk=chunk)

    mean = verts.mean(axis=0)
    cov = np.cov((verts - mean).T)
    _, Rpca = np.linalg.eigh(cov)          # columns = principal axes
    if np.linalg.det(Rpca) < 0:            # right-handed: keeps the winding
        Rpca = Rpca.copy()
        Rpca[:, 0] = -Rpca[:, 0]
    v_pca = (verts - mean) @ Rpca
    vmin = v_pca.min(axis=0) - 0.05
    vmax = v_pca.max(axis=0) + 0.05

    axes = [np.linspace(vmin[d], vmax[d], resolution, dtype=np.float32)
            for d in range(3)]
    gg = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    pts_world = gg @ Rpca.T + mean
    vol2 = eval_grid(pts_world.astype(np.float32)).reshape(
        resolution, resolution, resolution)
    spacing2 = [(vmax[d] - vmin[d]) / (resolution - 1) for d in range(3)]
    v2, f2 = mc.marching_cubes(vol2, level=level,
                               origin=tuple(vmin), spacing=tuple(spacing2))
    if len(v2) == 0:
        return extract_mesh(params, sdf_cfg, path, resolution=resolution,
                            grid_boundary=grid_boundary, level=level,
                            chunk=chunk)
    v2_world = v2 @ Rpca.T + mean
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    mc.write_ply(path, v2_world.astype(np.float32), f2)
    return v2_world, f2


def _upsample2(V: np.ndarray) -> np.ndarray:
    """Trilinear 2x corner-grid upsample: [n+1]^3 -> [2n+1]^3."""
    n = V.shape[0] - 1
    A = np.empty((2 * n + 1, V.shape[1], V.shape[2]), V.dtype)
    A[::2] = V
    A[1::2] = 0.5 * (V[:-1] + V[1:])
    B = np.empty((A.shape[0], 2 * n + 1, A.shape[2]), V.dtype)
    B[:, ::2] = A
    B[:, 1::2] = 0.5 * (A[:, :-1] + A[:, 1:])
    C = np.empty((B.shape[0], B.shape[1], 2 * n + 1), V.dtype)
    C[:, :, ::2] = B
    C[:, :, 1::2] = 0.5 * (B[:, :, :-1] + B[:, :, 1:])
    return C


def _cell_minmax(V: np.ndarray):
    """Per-cell (min, max) over the 8 corners of every cell -> two [n]^3."""
    cmin = V[:-1, :-1, :-1]
    cmax = V[:-1, :-1, :-1]
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                if dx == dy == dz == 0:
                    continue
                s = V[dx:dx + V.shape[0] - 1, dy:dy + V.shape[1] - 1,
                      dz:dz + V.shape[2] - 1]
                cmin = np.minimum(cmin, s)
                cmax = np.maximum(cmax, s)
    return cmin, cmax


def _corner_mask_of_cells(act: np.ndarray) -> np.ndarray:
    """Corner mask [(n+1)^3] of all corners touching an active cell [n]^3."""
    n = act.shape[0]
    m = np.zeros((n + 1,) * 3, bool)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                m[dx:dx + n, dy:dy + n, dz:dz + n] |= act
    return m


def extract_mesh_octree(params, sdf_cfg, path: Optional[str] = None,
                        resolution: int = 257, steps: int = 2,
                        grid_boundary=(-1.0, 1.0), level: float = 0.0,
                        chunk: int = 65536, band: float = 2.0):
    """Sparse octree (MISE-style) extraction: the SDF is evaluated densely
    on a coarse grid, then ``steps`` times the resolution doubles and only
    the corners of cells within ``band`` cell diagonals of the zero set
    are evaluated; the rest take trilinear-upsampled values. Returns
    (verts, faces, n_evals); writes a PLY when ``path`` is given."""
    lo, hi = grid_boundary
    n_cells = resolution - 1
    if n_cells % (1 << steps):
        raise ValueError(f"resolution-1 ({n_cells}) must be divisible by "
                         f"2^steps ({1 << steps})")
    n = n_cells >> steps

    def world(idx, n_now):
        return (lo + (hi - lo) * idx.astype(np.float32) / n_now)

    xs = np.linspace(lo, hi, n + 1, dtype=np.float32)
    grid = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1).reshape(-1, 3)
    V = _eval_sdf_chunked(params, sdf_cfg, grid, chunk).astype(
        np.float32).reshape(n + 1, n + 1, n + 1)
    known = np.ones_like(V, bool)
    n_evals = grid.shape[0]

    for _ in range(steps):
        V = _upsample2(V)
        known2 = np.zeros_like(V, bool)
        known2[::2, ::2, ::2] = known
        known = known2
        n *= 2
        cell_diag = (hi - lo) / n * np.sqrt(3.0)
        # fixpoint: newly evaluated corners can activate neighbor cells
        for _fix in range(3):
            cmin, cmax = _cell_minmax(V)
            act = (cmin <= level + band * cell_diag) & \
                  (cmax >= level - band * cell_diag)
            need = _corner_mask_of_cells(act) & ~known
            if not need.any():
                break
            idx = np.argwhere(need)
            pts = world(idx, n)
            V[need] = _eval_sdf_chunked(params, sdf_cfg, pts, chunk)
            known[need] = True
            n_evals += idx.shape[0]

    cmin, cmax = _cell_minmax(V)
    act = (cmin < level) & (cmax >= level)
    cells = np.argwhere(act)
    if cells.shape[0] == 0:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64),
                n_evals)
    corner_pos = cells[:, None, :] + mc._CORNER_OFFSETS[None].astype(np.int64)
    corner_val = V[corner_pos[..., 0], corner_pos[..., 1], corner_pos[..., 2]]
    sp = (hi - lo) / n
    verts, faces = mc.triangulate_cells(corner_pos, corner_val, level=level,
                                        origin=(lo, lo, lo),
                                        spacing=(sp, sp, sp))
    if path is not None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        mc.write_ply(path, verts, faces)
    return verts, faces, n_evals


def export_pointcloud(pointset, path: str):
    """The live points (those still on a track) as a PLY point cloud."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    xyz = pointset.all_xyzs()
    alive = getattr(pointset, "alive_mask", None)
    if alive is not None:
        xyz = xyz[alive()]
    mc.write_ply(path, xyz)


def export_cameras_json(cameraset, path: str, img_hw=None):
    """Viewer camera dump: id, K, W2C and image size per camera."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cams = []
    for cam in cameraset.cameras:
        pose = cam.pose()
        cams.append({
            "id": int(cam.id),
            "K": cam.intr.tolist(),
            "W2C": pose.tolist(),
            "img_size": list(img_hw or cam.img.shape[:2]),
        })
    with open(path, "w") as f:
        json.dump(cams, f)


def export_colmap_model(cameraset, pointset, model_dir: str, ext: str = ".bin"):
    """The reconstruction as a COLMAP sparse model (cameras, images with
    their 2D observations and 3D links, points3D with tracks; ids
    1-based)."""
    from . import colmap_model as cm
    cams, images = {}, {}
    for cam in cameraset.cameras:
        cid = int(cam.id) + 1
        K = np.asarray(cam.intr, np.float64)
        H, W = cam.img.shape[:2]
        cams[cid] = cm.ColmapCamera(cid, "PINHOLE", W, H,
                                    np.asarray([K[0, 0], K[1, 1],
                                                K[0, 2], K[1, 2]]))
        pose = np.asarray(cam.pose(), np.float64)  # w2c, COLMAP convention
        idx3d = np.asarray(cam.idx2d_to_3d, np.int64)
        p3d_ids = np.where(idx3d >= 0, idx3d + 1, -1)
        images[cid] = cm.ColmapImage(cid, cm.rotmat_to_qvec(pose[:3, :3]),
                                     pose[:3, 3], cid,
                                     f"{int(cam.id):06d}.png",
                                     np.asarray(cam.kypts, np.float64),
                                     p3d_ids)
    pts = {}
    for i in range(len(pointset)):
        track = pointset.tracks[i]
        pts[i + 1] = cm.ColmapPoint3D(
            i + 1, np.asarray(pointset.xyz[i], np.float64),
            np.asarray([128, 128, 128], np.uint8), 0.0,
            np.asarray([int(c) + 1 for c, _ in track]),
            np.asarray([int(k) for _, k in track]))
    cm.write_model(cams, images, pts, model_dir, ext=ext)


def _rays(pose, intr, H, W, device):
    grid = T.mesh_grid(H, W, device=device)
    pose_t = torch.as_tensor(np.asarray(pose, np.float32)).to(device)
    intr_t = torch.as_tensor(np.asarray(intr, np.float32)).to(device)
    return T.get_center_and_ray(pose_t[None], intr_t, grid)


@torch.no_grad()
def render_full_image(params, cfgs, pose, intr, H: int, W: int,
                      ray_batch: int = 8192):
    """Full-image render in slices of ``ray_batch`` rays (uniform
    sampling, plain composite). Returns numpy rgb [H,W,3], depth [H,W],
    normal [H,W,3]."""
    center, ray = _rays(pose, intr, H, W, _device(params))
    rgbs, deps, nrms = [], [], []
    for i in range(0, center.shape[1], ray_batch):
        out = ren_mod.render(params["sdf"], cfgs.sdf, params["rad"], cfgs.rad,
                             cfgs.ren, center[:, i:i + ray_batch],
                             ray[:, i:i + ray_batch])
        rgbs.append(out["rgb"][0].cpu().numpy())
        deps.append(out["depth_mlp"][0, :, 0].cpu().numpy())
        nrms.append(out["normal_mlp"][0].cpu().numpy())
    return {"rgb": np.concatenate(rgbs).reshape(H, W, 3),
            "depth": np.concatenate(deps).reshape(H, W),
            "normal": np.concatenate(nrms).reshape(H, W, 3)}


def render_traced_depth(params, sdf_cfg, pose, intr, H: int, W: int,
                        factor: int = 1, gen: Optional[torch.Generator] = None,
                        draws: Optional[dict] = None):
    """Full-image sphere-traced depth + unit normals + finish mask (the
    evaluation downscales by ``factor``). ``gen`` / ``draws`` feed the
    trace's eikonal sample draws, which the outputs do not use."""
    if factor > 1:
        H, W = H // factor, W // factor
        intr = np.asarray(intr).copy()
        intr[:2] /= factor
    center, ray = _rays(pose, intr, H, W, _device(params))
    with torch.no_grad():
        res = sdf_mod.sphere_tracing(
            params["sdf"], sdf_cfg, center, ray,
            gen=gen if gen is not None else torch.Generator().manual_seed(0),
            draws=draws)
        normals = sdf_mod.gradient(params["sdf"], sdf_cfg, res.pts_surface)
    n = normals[0].cpu().numpy()
    n_unit = n / (np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12)
    return {"depth": res.d_pred[0].cpu().numpy().reshape(H, W),
            "normal": n_unit.reshape(H, W, 3),
            "finish": res.finish_mask[:, 0].cpu().numpy().reshape(H, W)}


def eval_depth_vs_gt(params, sdf_cfg, cameraset, depth_gt, factor: int = 4,
                     verbose: bool = True):
    """GT-depth evaluation (ScanNet): sphere-traced depth per registered
    camera (downscaled by ``factor``), brought to GT units by the
    Procrustes sim(3) scale between estimated and GT camera centres, then
    abs-rel and RMSE over pixels with a GT measurement (> 0) and a
    converged trace. ``depth_gt``: [N_images, Hd, Wd] by dataset image id
    (nearest-resampled to the eval grid). Returns {"abs_rel", "rmse",
    "n_px", "per_view"}."""
    poses, poses_gt = cameraset.all_poses()
    scale = 1.0
    if poses.shape[0] > 2:
        try:
            _, sim3 = T.prealign_cameras(torch.as_tensor(poses),
                                         torch.as_tensor(poses_gt))
            scale = float(sim3.s0) / float(sim3.s1)
        except Exception:
            pass  # unaligned scale = 1 (init-only scenes)
    per_view = {}
    errs, sqs, n_tot = [], [], 0
    for cam in cameraset.cameras:
        if cam.id >= len(depth_gt) or depth_gt[cam.id] is None:
            continue
        H = cam.img.shape[0]
        W = cam.img.shape[1]
        out = render_traced_depth(params, sdf_cfg, cam.pose(), cam.intr,
                                  H, W, factor=factor)
        est = out["depth"] * scale
        h, w = est.shape
        gt_full = np.asarray(depth_gt[cam.id], np.float32)
        ys = (np.arange(h) * gt_full.shape[0] / h).astype(int)
        xs = (np.arange(w) * gt_full.shape[1] / w).astype(int)
        gt = gt_full[ys][:, xs]
        valid = (gt > 0) & out["finish"] & np.isfinite(est)
        n = int(valid.sum())
        if n == 0:
            per_view[cam.id] = {"abs_rel": float("nan"),
                                "rmse": float("nan"), "n_px": 0}
            continue
        diff = est[valid] - gt[valid]
        abs_rel = float(np.mean(np.abs(diff) / gt[valid]))
        rmse = float(np.sqrt(np.mean(diff ** 2)))
        per_view[cam.id] = {"abs_rel": abs_rel, "rmse": rmse, "n_px": n}
        errs.append(np.abs(diff) / gt[valid])
        sqs.append(diff ** 2)
        n_tot += n
    if n_tot == 0:
        return {"abs_rel": float("nan"), "rmse": float("nan"), "n_px": 0,
                "per_view": per_view}
    res = {"abs_rel": float(np.mean(np.concatenate(errs))),
           "rmse": float(np.sqrt(np.mean(np.concatenate(sqs)))),
           "n_px": n_tot, "per_view": per_view}
    if verbose:
        print(f"depth eval vs GT: abs_rel={res['abs_rel']:.4f} "
              f"rmse={res['rmse']:.4f} over {n_tot} px "
              f"({len(per_view)} views, sim3 scale {scale:.4f})")
    return res


def write_video(path: str, frames, fps: int = 30):
    """mp4 through OpenCV; a GIF through imageio when OpenCV is missing."""
    frames = [np.asarray(f) for f in frames]
    try:
        import cv2
        h, w = frames[0].shape[:2]
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        for f in frames:
            vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        vw.release()
    except ImportError:
        import imageio.v2 as imageio
        imageio.mimsave(os.path.splitext(path)[0] + ".gif", frames, fps=fps,
                        loop=0)


def _u8(img01):
    return (np.clip(np.asarray(img01), 0, 1) * 255).astype(np.uint8)


def render_novel_views(params, cfgs, anchor_pose, intr, H, W, n_views=60,
                       scale=0.1, out_dir: Optional[str] = None,
                       video: bool = False):
    """Renders along the novel-view trajectory around ``anchor_pose``."""
    poses = T.get_novel_view_poses(anchor_pose, N=n_views, scale=scale).numpy()
    frames = []
    for i in range(n_views):
        out = render_full_image(params, cfgs, poses[i], intr, H, W)
        frames.append(_u8(out["rgb"]))
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            png.write_png(os.path.join(out_dir, f"{i}.png"), frames[-1])
    if video and out_dir:
        write_video(os.path.join(out_dir, "novel_view_rgb.mp4"), frames)
    return np.stack(frames)


def export_all_rgb(opt, model, n_video_views: int = 30):
    """Per registered camera: traced depth and normals, the full render
    (rgb / depth / normals), the input image, and a novel-view video. The
    images are PNG (the JAX package writes the same names as JPEG)."""
    from . import vis as vis_mod

    out = os.path.join(opt.output_path, "image_all")
    os.makedirs(out, exist_ok=True)
    H, W = model.cfgs.H, model.cfgs.W

    def save_img(name, arr01):
        png.write_png(os.path.join(out, name), _u8(arr01))

    for cam in model.camera_set.cameras:
        pose, intr = cam.pose(), cam.intr
        traced = render_traced_depth(model.params, model.sdf_cfg, pose, intr, H, W)
        save_img(f"dp_{cam.id}.png", vis_mod.colorize(traced["depth"]))
        save_img(f"norm_{cam.id}.png", (traced["normal"] + 1) / 2)
        ren = render_full_image(model.params, model.cfgs, pose, intr, H, W)
        save_img(f"rgb_render_{cam.id}.png", ren["rgb"])
        save_img(f"dp_render_{cam.id}.png", vis_mod.colorize(ren["depth"]))
        save_img(f"norm_render_{cam.id}.png", (ren["normal"] + 1) / 2)
        save_img(f"rgb_gt_{cam.id}.png", cam.img)
        if n_video_views:
            frames = render_novel_views(model.params, model.cfgs, pose, intr,
                                        H, W, n_views=n_video_views, scale=0.1)
            write_video(os.path.join(out, f"novel_view_{cam.id}.mp4"),
                        list(frames))


def export_results(opt, model, resolution: int = 256):
    """The ``--get_result`` bundle: mesh, point cloud, cameras, COLMAP
    model, viewer page and a render of the first camera. The mesh's
    coarse pass runs at min(100, ``resolution``). Wall times go to
    ``HOST_TIMERS`` (export_mesh, export_render, export_results)."""
    from .obs import HOST_TIMERS
    with HOST_TIMERS.track("export_results"):
        _export_results(opt, model, resolution)


def _export_results(opt, model, resolution):
    from .obs import HOST_TIMERS
    out = opt.output_path
    if opt.get("vis_all_rgb", False):
        export_all_rgb(opt, model,
                       n_video_views=int(opt.get("vis_all_rgb_video_views", 30)))
    mesh_dir = os.path.join(out, "mesh")
    os.makedirs(mesh_dir, exist_ok=True)
    with HOST_TIMERS.track("export_mesh"):
        _export_mesh(opt, model, mesh_dir, resolution)
    export_pointcloud(model.point_set, os.path.join(out, "pointcloud.ply"))
    export_cameras_json(model.camera_set, os.path.join(out, "cameras.json"))
    export_colmap_model(model.camera_set, model.point_set,
                        os.path.join(out, "sparse", "0"))
    from ..viz.html_viewer import export_html
    export_html(out)
    if len(model.camera_set):
        cam0 = model.camera_set.cameras[0]
        with HOST_TIMERS.track("export_render"):
            img = render_full_image(model.params, model.cfgs, cam0.pose(),
                                    cam0.intr, model.cfgs.H, model.cfgs.W)
        png.write_png(os.path.join(out, "render_cam0.png"), _u8(img["rgb"]))
    print(f"results exported to {out}")


def _export_mesh(opt, model, mesh_dir, resolution):
    if str(opt.get("mesh_mode", "highres")) == "octree":
        steps = 2
        nc = resolution - 1
        nc += (-nc) % (1 << steps)  # round cells up to a 2^steps multiple
        extract_mesh_octree(model.params, model.sdf_cfg,
                            os.path.join(mesh_dir, "high_res.ply"),
                            resolution=nc + 1, steps=steps,
                            grid_boundary=(-0.6, 0.6))
    else:
        extract_mesh_high_res(model.params, model.sdf_cfg,
                              os.path.join(mesh_dir, "high_res.ply"),
                              resolution=resolution,
                              low_resolution=min(100, resolution),
                              grid_boundary=(-0.6, 0.6))
