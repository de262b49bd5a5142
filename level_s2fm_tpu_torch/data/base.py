"""Dataset base utilities: image IO, resizing, K/Rt decomposition.

Counterpart of ``level_s2fm_tpu/data/base.py`` without an image library
on the path of the prepared scenes: PNGs are read by the port's own
``utils/png.py``; other formats (JPEG, ...) go through Pillow or imageio
when one of them imports, and otherwise raise an ``ImportError`` that
names the format. The resize reproduces OpenCV's ``INTER_AREA`` (which
the JAX package calls): the area-weighted mean of the source pixels
under each target pixel, a box mean for integer factors. The projection
matrix is decomposed as ``cv2.decomposeProjectionMatrix`` does (K with a
positive focal length on both axes, R a proper rotation).
"""
from __future__ import annotations

import functools
import os
from typing import List, Optional, Tuple

import numpy as np

from ..utils import png


def imread(path: str) -> np.ndarray:
    """An image file as imageio returns it (uint8 / uint16; [H,W] for
    gray, [H,W,C] otherwise)."""
    if path.lower().endswith(".png"):
        return png.read_png(path)
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is not None:
        with Image.open(path) as im:
            return np.asarray(im)
    try:
        import imageio.v2 as imageio
    except ImportError:
        fmt = os.path.splitext(path)[1] or path
        raise ImportError(f"reading {fmt} images needs Pillow or imageio; "
                          "neither is installed (PNG needs neither)") from None
    return imageio.imread(path)


@functools.lru_cache(maxsize=32)
def _area_weights(src: int, dst: int) -> np.ndarray:
    """[dst, src] weights of OpenCV's INTER_AREA along one axis: each
    target cell averages the source cells it covers, partial cells by
    their covered fraction (``computeResizeAreaTab``)."""
    scale = 1.0 / (dst / src)
    w = np.zeros((dst, src), np.float64)
    for dx in range(dst):
        f1 = dx * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s1, s2 = int(np.ceil(f1)), int(np.floor(f2))
        s2 = min(s2, src - 1)
        s1 = min(s1, s2)
        if s1 - f1 > 1e-3:
            w[dx, s1 - 1] += np.float32((s1 - f1) / cell)
        w[dx, s1:s2] += np.float32(1.0 / cell)
        if f2 - s2 > 1e-3:
            w[dx, s2] += np.float32(min(min(f2 - s2, 1.0), cell) / cell)
    return w


def resize_area(img: np.ndarray, target_hw: Tuple[int, int]) -> np.ndarray:
    """Area resize of [H,W] or [H,W,C] to ``target_hw`` (downscaling, as
    every loader does), float32 out."""
    H, W = target_hw
    src = np.asarray(img, np.float64)
    wy = _area_weights(src.shape[0], H)
    wx = _area_weights(src.shape[1], W)
    out = np.tensordot(wy, src, axes=(1, 0))                  # [H, w, ...]
    out = np.moveaxis(np.tensordot(wx, out, axes=(1, 1)), 0, 1)
    return out.astype(np.float32)


def load_rgb(path: str, target_hw: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Load an image as float32 [H,W,3] in [0,1], optionally resized."""
    img = imread(path)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    img = img[..., :3].astype(np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    if target_hw is not None and img.shape[:2] != tuple(target_hw):
        img = resize_area(img, target_hw)
    return np.clip(img, 0.0, 1.0)


def load_depth(path: str) -> np.ndarray:
    """A ScanNet-style uint16 depth PNG as float32 meters (mm / 1000);
    0 means no measurement and stays 0."""
    return np.asarray(imread(path), np.float32) / 1000.0


def _rq3(M: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """M = K @ R with K upper triangular, K[0,0] > 0, K[1,1] > 0 and
    det(R) = +1 (the sign convention of OpenCV's RQDecomp3x3)."""
    P = np.eye(3)[::-1]
    Q, U = np.linalg.qr((P @ M).T)
    K = P @ U.T @ P
    R = P @ Q.T
    s = np.sign(np.diag(K))
    s[s == 0] = 1.0
    s[2] = s[0] * s[1] * np.sign(np.linalg.det(R))
    return K * s[None, :], s[:, None] * R


def decompose_projection(P: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """P [3,4] -> (K [4,4] with the normalized 3x3 upper left, c2w pose
    [4,4]), in float64 arithmetic."""
    P = np.asarray(P, np.float64)
    K, R = _rq3(P[:, :3])
    K = K / K[2, 2]
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.T
    pose[:3, 3] = -np.linalg.solve(P[:, :3], P[:, 3])    # camera center
    intr = np.eye(4)
    intr[:3, :3] = K
    return intr.astype(np.float32), pose


def scale_intrinsics(K: np.ndarray, factor_x: float, factor_y: float) -> np.ndarray:
    K = K.copy()
    K[0, 0] /= factor_x
    K[0, 2] /= factor_x
    K[1, 1] /= factor_y
    K[1, 2] /= factor_y
    return K


def w2c_from_c2w(c2w: np.ndarray) -> np.ndarray:
    R = c2w[:3, :3]
    t = c2w[:3, 3]
    w2c = np.zeros((3, 4), np.float32)
    w2c[:3, :3] = R.T
    w2c[:3, 3] = -R.T @ t
    return w2c


def center_crop_with_K(img: np.ndarray, K: np.ndarray,
                       frac: float) -> Tuple[np.ndarray, np.ndarray]:
    """Center-crop to ``frac`` of each raw dimension and shift the
    principal point by ``(raw - crop) / 2`` on each axis."""
    rawH, rawW = img.shape[:2]
    cH, cW = int(rawH * frac), int(rawW * frac)
    y0, x0 = (rawH - cH) // 2, (rawW - cW) // 2
    out = img[y0:y0 + cH, x0:x0 + cW]
    K = K.copy()
    K[0, 2] -= (rawW - cW) / 2
    K[1, 2] -= (rawH - cH) / 2
    return out, K


def _rgb_to_hsv(rgb):
    """OpenCV's float RGB2HSV: H in [0,360), S and V in [0,1]."""
    eps = np.float32(np.finfo(np.float32).eps)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = rgb.max(-1)
    diff = v - rgb.min(-1)
    s = diff / (np.abs(v) + eps)
    k = np.float32(60.0) / (diff + eps)
    h = np.where(v == r, (g - b) * k,
                 np.where(v == g, (b - r) * k + 120.0, (r - g) * k + 240.0))
    h = np.where(h < 0, h + 360.0, h)
    return np.stack([h, s, v], -1).astype(np.float32)


def _hsv_to_rgb(hsv):
    """OpenCV's float HSV2RGB."""
    h, s, v = hsv[..., 0] / 60.0, hsv[..., 1], hsv[..., 2]
    h = np.mod(h, 6.0)
    sector = np.floor(h).astype(np.int64)
    f = h - sector
    tab = np.stack([v, v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))], -1)
    order = np.asarray([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1],
                        [0, 1, 3], [2, 1, 0]])[np.clip(sector, 0, 5)]  # (b, g, r)
    bgr = np.take_along_axis(tab, order, -1)
    rgb = bgr[..., ::-1]
    rgb = np.where((s == 0)[..., None], v[..., None], rgb)
    return rgb.astype(np.float32)


def color_jitter(img: np.ndarray, rng: np.random.Generator,
                 brightness: float = 0.0, contrast: float = 0.0,
                 saturation: float = 0.0, hue: float = 0.0) -> np.ndarray:
    """Photometric augmentation (torchvision ColorJitter semantics: each
    factor drawn uniformly from ``(1-x, 1+x)``, hue from ``(-h, h)``).
    Geometric augmentations are not offered: the prepared keypoints would
    no longer match the pixels."""
    out = img.astype(np.float32)
    if brightness:
        out = out * rng.uniform(1 - brightness, 1 + brightness)
    if contrast:
        mean = out.mean(axis=(0, 1), keepdims=True)
        out = (out - mean) * rng.uniform(1 - contrast, 1 + contrast) + mean
    if saturation:
        gray = (out * np.array([0.299, 0.587, 0.114], np.float32)).sum(-1, keepdims=True)
        out = gray + (out - gray) * rng.uniform(1 - saturation, 1 + saturation)
    if hue:
        hsv = _rgb_to_hsv(np.clip(out, 0, 1).astype(np.float32))
        hsv[..., 0] = (hsv[..., 0] + rng.uniform(-hue, hue) * 360.0) % 360.0
        out = _hsv_to_rgb(hsv)
    return np.clip(out, 0.0, 1.0)


def preprocess_frame(path: str, K_raw: np.ndarray, target_hw: Tuple[int, int],
                     center_crop: Optional[float] = None,
                     augment: Optional[dict] = None,
                     rng: Optional[np.random.Generator] = None,
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """One frame through the preprocessing chain: [color jitter] ->
    [center crop] -> resize, with the intrinsics scaled from the
    (cropped) raw frame to ``target_hw``. Returns (image [H,W,3] in
    [0,1], K [3,3])."""
    img = load_rgb(path)
    K = K_raw.copy().astype(np.float32)
    if augment:
        img = color_jitter(img, rng or np.random.default_rng(),
                           brightness=float(augment.get("brightness") or 0.0),
                           contrast=float(augment.get("contrast") or 0.0),
                           saturation=float(augment.get("saturation") or 0.0),
                           hue=float(augment.get("hue") or 0.0))
    if center_crop:
        img, K = center_crop_with_K(img, K, float(center_crop))
    cH, cW = img.shape[:2]
    H, W = target_hw
    img = load_resize(img, (H, W))
    K = scale_intrinsics(K, cW / W, cH / H)
    return img, K


def load_resize(img: np.ndarray, target_hw: Tuple[int, int]) -> np.ndarray:
    """Resize an already-loaded [H,W,3] float image."""
    if img.shape[:2] == tuple(target_hw):
        return img
    return np.clip(resize_area(img, target_hw), 0.0, 1.0)


def sorted_images(path: str) -> List[str]:
    exts = (".png", ".jpg", ".jpeg", ".JPG", ".PNG")
    return sorted(os.path.join(path, f) for f in os.listdir(path)
                  if f.endswith(exts))
