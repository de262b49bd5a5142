"""Render a synthetic scene to disk in a layout the port's loaders read.

    python -m level_s2fm_tpu_torch.make_synthetic_dataset --out data/synthprep \
        --scene scan1 [--views 9] [--size 320] [--width W] [--detail 0.35] \
        [--seed 3] [--ring_rad 1.6] [--preset sphere|multi|multiroom]

The port's counterpart of ``scripts/make_synthetic_dataset.py``: the same
flags, presets and files, from the port's own generators
(``data/synthetic.py``), with no JAX installed.

* ``sphere`` (default) and ``multi`` write the DTU layout:
  ``<out>/<scene>/images/*.png`` + ``cameras.npz`` (world_mat = K @ w2c,
  identity scale_mat). ``multi`` is the four-object hard scene on a full
  orbit (``data/synthhard``).
* ``multiroom`` writes the ScanNet layout: ``color/*.jpg``,
  ``depth/*.png`` (uint16 millimetres), ``pose/*.txt`` (c2w) and
  ``intrinsic/intrinsic_color.txt`` (``data/scannet/multiroom0``).

PNGs go through the port's own writer (``utils/png.py``); the color JPGs
of ``multiroom`` need imageio, imported only there. Host only: it touches
no device. Then prepare and train:

    python -m level_s2fm_tpu_torch.prepare --data data/synthprep --scene scan1
    python -m level_s2fm_tpu_torch.train --yaml=configs/synthprep.yaml
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from .data import synthetic
from .utils import png


def _write_jpg(path: str, img: np.ndarray, quality: int = 95) -> None:
    try:
        import imageio.v2 as imageio
    except ImportError:
        raise ImportError("writing .jpg images needs imageio, which is not "
                          "installed (PNG needs nothing)") from None
    imageio.imwrite(path, img, quality=quality)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m level_s2fm_tpu_torch.make_synthetic_dataset")
    ap.add_argument("--out", default="data/synthprep")
    ap.add_argument("--scene", default="scan1")
    ap.add_argument("--views", type=int, default=9)
    # default must match configs/synthprep.yaml data.raw_size
    ap.add_argument("--size", type=int, default=320)
    ap.add_argument("--width", type=int, default=None,
                    help="image width (default: --size, i.e. square); "
                         "e.g. --size 1200 --width 1600 renders the "
                         "reference DTU working resolution")
    ap.add_argument("--detail", type=float, default=0.35)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--ring_rad", type=float, default=1.6)
    ap.add_argument("--preset", choices=["sphere", "multi", "multiroom"],
                    default="sphere",
                    help="'multi' = the hard benchmark: 4-object SDF scene "
                         "(box/spheres/torus with occlusions), full "
                         "360-degree orbit with vertical wobble; "
                         "'multiroom' = ScanNet-layout indoor scene (two "
                         "rooms + doorway, inside-out trajectory, GT depth "
                         "maps) for configs/scannet_multiroom.yaml")
    args = ap.parse_args(argv)
    W_img = args.width or args.size
    scene_dir = os.path.join(args.out, args.scene)

    if args.preset == "multiroom":
        t0 = time.time()
        images, depths, intrs, poses = synthetic.make_multiroom_scene(
            n_views=args.views, H=args.size, W=W_img)
        print(f"rendered {args.views} views in {time.time()-t0:.1f}s")
        for sub in ("color", "pose", "depth", "intrinsic"):
            os.makedirs(os.path.join(scene_dir, sub), exist_ok=True)
        K4 = np.eye(4, dtype=np.float32)
        K4[:3, :3] = intrs[0]
        np.savetxt(os.path.join(scene_dir, "intrinsic",
                                "intrinsic_color.txt"), K4)
        for i in range(args.views):
            stem = f"{i:06d}"
            _write_jpg(os.path.join(scene_dir, "color", stem + ".jpg"),
                       (np.clip(images[i], 0, 1) * 255).astype(np.uint8))
            c2w = np.eye(4, dtype=np.float32)
            R, t = poses[i][:, :3], poses[i][:, 3]
            c2w[:3, :3] = R.T
            c2w[:3, 3] = -R.T @ t
            np.savetxt(os.path.join(scene_dir, "pose", stem + ".txt"), c2w)
            png.write_png(
                os.path.join(scene_dir, "depth", stem + ".png"),
                np.clip(depths[i] * 1000.0, 0, 65535).astype(np.uint16))
        print(f"wrote ScanNet-layout scene to {scene_dir}")
        return

    img_dir = os.path.join(scene_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    if args.preset == "multi":
        t0 = time.time()
        images, intrs, poses = synthetic.make_hard_scene_images(
            n_views=args.views, H=args.size, W=W_img,
            ring_rad=args.ring_rad)
        print(f"rendered {args.views} views in {time.time()-t0:.1f}s")
    else:
        scene = synthetic.make_scene(n_views=args.views, H=args.size,
                                     W=W_img, n_points=1024,
                                     seed=args.seed, detail=args.detail)
        images, intrs, poses = scene.images, scene.intrs, scene.poses_gt
    cams = {}
    for i in range(args.views):
        png.write_png(os.path.join(img_dir, f"{i:06d}.png"),
                      (np.clip(images[i], 0, 1) * 255).astype(np.uint8))
        K4 = np.eye(4, dtype=np.float32)
        K4[:3, :3] = intrs[i]
        W4 = np.eye(4, dtype=np.float32)
        W4[:3, :4] = poses[i]
        cams[f"world_mat_{i}"] = K4 @ W4
        cams[f"scale_mat_{i}"] = np.eye(4, dtype=np.float32)
    np.savez(os.path.join(scene_dir, "cameras.npz"), **cams)
    # init bootstrap constants for the scene config (supp eq 16 surface):
    # rad_init = |cam0 center|, scale_init = |baseline(cam0, cam1)|
    c = [-p[:, :3].T @ p[:, 3] for p in poses[:2]]
    print(f"wrote {args.views} views at {args.size}x{W_img} to {scene_dir}")
    print(f"rad_init (|c0|) = {np.linalg.norm(c[0]):.4f}   "
          f"scale_init (|c1-c0|) = {np.linalg.norm(c[1] - c[0]):.4f}")


if __name__ == "__main__":
    main()
