"""Plain PyTorch optimisation steps of the two-view init, the
``sfm_refine`` bundle adjustment of one new view and the refine, with
the phases' Adam and its guard, built from the benchmark's scene alone.

``run`` follows the program through its first steps from the same
initial parameters and the same draws (the program's CPU generator state
before each step): it returns each step's total loss and the gradient of every leaf as the
optimizer took it, every leaf's largest gradient over the steps and every
leaf's change after the last step.
``precision="tf32"`` runs the same steps with TF32 matrix products, the
control that the comparison has to fail.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import field
from . import render as R

BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536, 131072)
CAM_BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128)


def pad_to(n, buckets=BUCKETS):
    for b in buckets:
        if n <= b:
            return b
    return int(2 ** np.ceil(np.log2(max(n, 1))))


# --------------------------------------------------------------------------- poses

def _skew(w):
    o = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([o, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], o, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], o], -1)], -2)


def _series(x, small, big):
    tiny = torch.abs(x) < 1e-4
    safe = torch.where(tiny, torch.ones_like(x), x)
    return torch.where(tiny, small(x), big(safe))


def _sinc(x):
    return _series(x, lambda x: 1.0 - x * x / 6.0, lambda s: torch.sin(s) / s)


def _cosc(x):
    return _series(x, lambda x: 0.5 - x * x / 24.0, lambda s: (1.0 - torch.cos(s)) / (s * s))


def _sinc3(x):
    return _series(x, lambda x: 1.0 / 6.0 - x * x / 120.0,
                   lambda s: (s - torch.sin(s)) / (s * s * s))


def se3_to_pose(wu):
    """se(3) [...,6] (rotation | translation part) -> [...,3,4]."""
    w, u = wu[..., :3], wu[..., 3:]
    wx = _skew(w)
    th = torch.linalg.norm(w, dim=-1)[..., None, None]
    eye = torch.eye(3, dtype=wu.dtype, device=wu.device)
    Rm = eye + _sinc(th) * wx + _cosc(th) * (wx @ wx)
    V = eye + _cosc(th) * wx + _sinc3(th) * (wx @ wx)
    return torch.cat([Rm, V @ u[..., None]], -1)


def pose_to_se3(P, eps=1e-8):
    """[...,3,4] -> se(3) [...,6], the inverse of ``se3_to_pose``."""
    Rm, t = P[..., :3], P[..., 3:]
    tr = Rm[..., 0, 0] + Rm[..., 1, 1] + Rm[..., 2, 2]
    th = torch.arccos(torch.clamp((tr - 1) / 2, -1 + 1e-7, 1 - 1e-7))
    v = torch.stack([Rm[..., 2, 1] - Rm[..., 1, 2], Rm[..., 0, 2] - Rm[..., 2, 0],
                     Rm[..., 1, 0] - Rm[..., 0, 1]], -1)
    w = (0.5 / torch.clamp(_sinc(th), min=1e-8))[..., None] * v
    wx = _skew(w)
    th = torch.linalg.norm(w, dim=-1)[..., None, None]
    coef = (1 - _sinc(th) / (2 * _cosc(th))) / (th ** 2 + eps)
    inv_v = torch.eye(3, dtype=P.dtype, device=P.device) - 0.5 * wx + coef * (wx @ wx)
    return torch.cat([w, (inv_v @ t)[..., 0]], -1)


# --------------------------------------------------------------------------- batches

def _tracing(scene, cam_ids, n_real, poses, K, dev):
    """Per camera: rays through its tracked keypoints and their points,
    padded to a bucket; cameras past ``n_real`` are masked out. Worked out
    on the CPU, camera by camera, as the program works them out, then
    moved to ``dev``."""
    out = _tracing_cpu(scene, cam_ids, n_real, poses.cpu(), K.cpu())
    return {k: v.to(dev) for k, v in out.items()}


def _tracing_cpu(scene, cam_ids, n_real, poses, K, dev="cpu"):
    rows = [np.where(scene["idx2d"][c] != -1)[0] for c in cam_ids]
    Nt = pad_to(max([len(r) for r in rows] + [1]))
    C = len(cam_ids)
    center = torch.zeros((C, Nt, 3), device=dev)
    ray = torch.zeros((C, Nt, 3), device=dev)
    ray[..., 2] = 1.0
    xyz = torch.zeros((C, Nt, 3), device=dev)
    mask = torch.zeros((C, Nt), dtype=torch.bool, device=dev)
    for i, (c, k) in enumerate(zip(cam_ids, rows)):
        if not len(k):
            continue
        kp = torch.as_tensor(scene["kypts"][c][k], dtype=torch.float32, device=dev)
        cc, rr = R.center_and_ray(poses[i:i + 1], K, kp)
        center[i, :len(k)], ray[i, :len(k)] = cc[0], rr[0]
        xyz[i, :len(k)] = torch.as_tensor(scene["xyz"][scene["idx2d"][c][k]],
                                          dtype=torch.float32, device=dev)
        mask[i, :len(k)] = i < n_real
    return {"center": center, "ray": ray, "xyz": xyz, "mask": mask}


def _images(scene, cam_ids, dev):
    return torch.as_tensor(np.stack([scene["images"][c].reshape(-1, 3) for c in cam_ids]),
                           dtype=torch.float32, device=dev)


def batch(kind, scene, cam_ids, dev):
    """The step's inputs, worked out from the scene: images, rays
    through the keypoints, tracks and poses. ``kind``: ``init`` (cameras
    at ``scene["w2c"]``, the pair's matched keypoints ``scene["kp_pair"]``),
    ``refine`` (cameras at ``scene["se3"]``) or ``sfm_refine`` (the one
    camera ``cam_ids[0]`` at ``scene["se3"]``)."""
    K = torch.as_tensor(scene["K"], dtype=torch.float32, device=dev)
    H, W = scene["images"][cam_ids[0]].shape[:2]
    b = {"K": K, "grid": R.mesh_grid(H, W, dev)}
    if kind == "init":
        # the keypoints' rays on the CPU, as the program works them out
        poses = torch.as_tensor(np.stack([scene["w2c"][c] for c in cam_ids]),
                                dtype=torch.float32)
        kp0, kp1 = (torch.as_tensor(k, dtype=torch.float32) for k in scene["kp_pair"])
        n = kp0.shape[0]
        P = pad_to(n)
        center = torch.zeros((2, P, 3))
        ray = torch.zeros((2, P, 3))
        ray[..., 2] = 1.0
        for i, kp in enumerate((kp0, kp1)):
            c, r = R.center_and_ray(poses[i:i + 1], K.cpu(), kp)
            center[i, :n], ray[i, :n] = c[0], r[0]
        kp_src = torch.zeros((2, P, 2))
        kp_src[0, :n], kp_src[1, :n] = kp1, kp0
        mask = torch.zeros((2, P), dtype=torch.bool)
        mask[:, :n] = True
        on = lambda x: x.to(dev)  # noqa: E731
        b.update(center_k=on(center), ray_k=on(ray), kp_src=on(kp_src), kp_mask=on(mask),
                 poses=on(poses), proj_pose=on(poses.flip(0)),
                 images=_images(scene, cam_ids, dev))
        return b
    n_real = len(cam_ids)
    padded = list(cam_ids) + [cam_ids[0]] * (pad_to(n_real, CAM_BUCKETS) - n_real)
    se3 = torch.as_tensor(np.stack([scene["se3"][c] for c in padded]), dtype=torch.float32)
    # each camera's pose on the CPU, one at a time, as the program's cameras give it
    poses = torch.cat([se3_to_pose(se3[i:i + 1]) for i in range(len(padded))]).to(dev)
    se3 = se3.to(dev)
    b.update(images=_images(scene, padded, dev), n_real=n_real, se3=se3,
             cam_mask=torch.arange(len(padded), device=dev) < n_real,
             tracing=_tracing(scene, padded, n_real, poses, K, dev), poses=poses)
    if kind == "sfm_refine":
        ids, pidx, kps = [], [], []
        for j, c in enumerate(cam_ids):
            m = scene["idx2d"][c] != -1
            ids.append(scene["idx2d"][c][m])
            pidx.append(np.full(int(m.sum()), j, np.int64))
            kps.append(scene["kypts"][c][m])
        ids, pidx, kps = np.concatenate(ids), np.concatenate(pidx), np.concatenate(kps)
        P = pad_to(max(len(ids), 1))
        pad = lambda x, dt: torch.as_tensor(  # noqa: E731
            np.concatenate([x, np.zeros((P - len(x),) + x.shape[1:], x.dtype)]),
            dtype=dt, device=dev)
        b.update(xyzs=pad(scene["xyz"][ids].astype(np.float32), torch.float32),
                 kp=pad(kps.astype(np.float32), torch.float32),
                 pose_idx=pad(pidx, torch.int64),
                 valid=torch.arange(P, device=dev) < len(ids))
    return b


# --------------------------------------------------------------------------- losses

def init_losses(params, cfg, b, gen, occ):
    n = b["center_k"].shape[0] * b["center_k"].shape[1]
    o, d = b["center_k"].reshape(-1, 3), b["ray_k"].reshape(-1, 3)
    m = field.march(params["sdf"], cfg, o, d)
    _, last, _, surf = field.reeval(params["sdf"], cfg, m, o, d)
    field.eikonal_draws(cfg, n, gen)
    surf = surf.reshape(2, -1, 3)
    uv = torch.stack([R.project(surf[i][None], b["proj_pose"][i][None], b["K"][None])[0]
                      for i in range(2)])
    loss = {"reproj_error": R.masked_mean(R.safe_norm(uv - b["kp_src"]), b["kp_mask"]),
            "sdf_surf": R.masked_mean(torch.abs(last.reshape(2, -1)), b["kp_mask"])}
    rc = R.render_core(params, cfg, gen, b["poses"], b["K"], b["images"], b["grid"], occ)
    loss["eikonal_loss"] = R.eikonal(rc["normals"])
    loss["rgb"] = rc["rgb_loss"]
    loss["DC_Loss"] = rc["DC_loss"]
    return loss


def refine_losses(params, cfg, b, gen, occ):
    rc = R.render_core(params, cfg, gen, b["poses"], b["K"], b["images"], b["grid"], occ,
                       tracing=b["tracing"], cam_mask=b["cam_mask"], n_real=b["n_real"])
    return {"eikonal_loss": R.eikonal(rc["normals"], rc["ray_real"]),
            "rgb": rc["rgb_loss"], "DC_Loss": rc["DC_loss"],
            "tracing_loss": rc["tracing_loss"],
            "sdf_surf": R.masked_mean(torch.abs(rc["sdfs_traced"]), rc["tmask"])}


def sfm_refine_losses(params, cfg, b, gen, occ, xyzs):
    """The losses and the tracks' points projected onto the surface."""
    se3 = torch.cat([params["se3_r"], params["se3_t"]], 1)
    s, _, nrm = field.sdf_feat_normal(params["sdf"], cfg, xyzs.detach())
    nval = torch.linalg.norm(nrm, dim=-1, keepdim=True)
    new = xyzs - nrm / torch.clamp(nval, min=1e-8).detach() * s[..., None]
    sdfs = field.sdf(params["sdf"], cfg, new)
    uv = R.project_each(new, se3_to_pose(se3[b["pose_idx"]]), b["K"])
    r = R.safe_norm(uv - b["kp"])
    surf = (torch.abs(sdfs) < 2 * cfg["finish_threshold"]) & b["valid"]
    ok = surf & torch.isfinite(r)
    robust = 0.5 * (2 * torch.log(1 + r ** 2 / 4)) + 0.5 * r
    reproj = torch.where(surf.to(torch.float32).sum() > 0, R.masked_mean(robust, ok), 0.0)
    loss = {"reproj_error": reproj,
            "sdf_surf": R.masked_mean(torch.abs(sdfs), b["valid"])}
    rc = R.render_core(params, cfg, gen, se3_to_pose(se3), b["K"], b["images"], b["grid"],
                       occ, tracing=b["tracing"], cam_mask=b["cam_mask"],
                       n_real=b["n_real"], dc_frozen=True)
    loss.update(eikonal_loss=R.eikonal(rc["normals"], rc["mask_bg"]),
                rgb=rc["rgb_loss"], DC_Loss=rc["DC_loss"],
                tracing_loss=rc["tracing_loss"])
    return loss, R.masked_mean(r, ok).detach(), new


# --------------------------------------------------------------------------- Adam

def leaves(tree, prefix=""):
    """{dotted path: tensor} of a nested dict / list of tensors."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(leaves(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


class Adam:
    """Adam per leaf, lr_t = base lr * gamma^t; a step with a non-finite
    gradient or update changes no parameter (its moments still advance
    with zero gradients), and non-finite moments are reset to 0."""

    def __init__(self, named, lrs, gamma, b1=0.9, b2=0.999, eps=1e-8):
        self.p, self.lr, self.gamma = named, lrs, gamma
        self.b1, self.b2, self.eps, self.t = b1, b2, eps, 0
        self.mu = {k: torch.zeros_like(v) for k, v in named.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in named.items()}

    @torch.no_grad()
    def step(self, grads):
        ok = all(bool(torch.isfinite(g).all()) for g in grads.values())
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        decay = self.gamma ** (self.t - 1)
        ups = {}
        for k, g in grads.items():
            g = g if ok else torch.zeros_like(g)
            self.mu[k].mul_(self.b1).add_((1 - self.b1) * g)
            self.nu[k].mul_(self.b2).add_((1 - self.b2) * g * g)
            ups[k] = -self.lr[k] * decay * (self.mu[k] / bc1) / (
                torch.sqrt(self.nu[k] / bc2) + self.eps)
        ok = ok and all(bool(torch.isfinite(u).all()) for u in ups.values())
        if ok:
            for k, u in ups.items():
                self.p[k].add_(u)
        for m in list(self.mu.values()) + list(self.nu.values()):
            torch.nan_to_num_(m, nan=0.0, posinf=0.0, neginf=0.0)


# --------------------------------------------------------------------------- run

#: per kind: {parameter group: learning-rate key of the phase's options}
GROUPS = {"init": {"sdf": "lr_sdf", "rad": "lr_color"},
          "refine": {"sdf": "lr_sdf", "rad": "lr_color"},
          "sfm_refine": {"sdf": "lr_sdf", "rad": "lr_color", "se3_r": "lr_pose_r",
                         "se3_t": "lr_pose_t"}}
#: per kind: the options' optimiser and loss-weight sections
SECTION = {"init": ("init", "init"), "refine": ("refine", "refine"),
           "sfm_refine": ("ba", "ba")}


def _clone(tree, device=None):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device, copy=True)
    if isinstance(tree, dict):
        return {k: _clone(v, device) for k, v in tree.items()}
    return [_clone(v, device) for v in tree]


class Phase:
    """One phase's inputs worked out from the scene, its loss weights,
    learning rates and occupancy grid (built from the parameters it is
    started from, as the program builds it before its first step)."""

    def __init__(self, kind, opt, scene, cam_ids, params0, max_iter):
        self.kind, self.cfg = kind, field.config(opt)
        self.dev = params0["sdf"]["table"].device
        self.b = batch(kind, scene, cam_ids, self.dev)
        sec_o, sec_w = SECTION[kind]
        self.oo, self.weights = opt["optim"][sec_o], dict(opt["loss_weight"][sec_w])
        self.gamma = (float(self.oo["lr_sdf_end"]) / float(self.oo["lr_sdf"])) ** (1.0 / max_iter)
        self.occ = R.occupancy(params0["sdf"], self.cfg, self.dev)

    def params(self, tree):
        """A trainable copy of ``tree`` (with the poses of the batch where
        the phase optimises them and ``tree`` has none), and its leaves."""
        params = _clone(tree, self.dev)
        if self.kind == "sfm_refine" and "se3_r" not in params:
            params["se3_r"] = self.b["se3"][:, :3].clone()
            params["se3_t"] = self.b["se3"][:, 3:].clone()
        named = {}
        for group in GROUPS[self.kind]:
            for k, v in leaves(params[group], group).items():
                named[k] = v.requires_grad_(True)
        return params, named

    def loss(self, params, gen_state, xyzs):
        """(total, the track points projected onto the surface or None)."""
        gen = torch.Generator()
        gen.set_state(gen_state)
        cfg, b, occ = self.cfg, self.b, self.occ
        if self.kind == "init":
            return R.weighted_total(init_losses(params, cfg, b, gen, occ), self.weights), None
        if self.kind == "refine":
            return R.weighted_total(refine_losses(params, cfg, b, gen, occ), self.weights), None
        loss, px, new = sfm_refine_losses(params, cfg, b, gen, occ, xyzs)
        rest = {k: v for k, v in loss.items() if k != "reproj_error"}
        return (R.weighted_total(rest, self.weights) + torch.pow(
            10.0, torch.where(px > 10.0, 1.0, 0.0)) * loss["reproj_error"]), new.detach()

    def grads(self, total, named):
        g = torch.autograd.grad(total, list(named.values()), allow_unused=True)
        return {k: torch.zeros_like(v) if x is None else x for (k, v), x in zip(named.items(), g)}


def run(kind, opt, scene, cam_ids, params0, gen_states, max_iter,
        precision="float32"):
    """The first ``len(gen_states)`` steps of phase ``kind`` from
    ``params0`` (left untouched). Returns {"loss": [per step], "grads":
    [per step: {leaf: gradient norm as the optimizer took it}], "grad_max":
    {leaf: the largest gradient norm of the steps}, "change": [per step:
    {leaf: norm of the change since the start}], "after1": the parameters
    and carried track points after the first step}."""
    with _tf32() if precision == "tf32" else contextlib.nullcontext():
        ph = Phase(kind, opt, scene, cam_ids, params0, max_iter)
        params, named = ph.params(params0)
        start = {k: v.detach().clone() for k, v in named.items()}
        lrs = {k: float(ph.oo[GROUPS[kind][k.split(".")[0]]]) for k in named}
        adam = Adam(named, lrs, ph.gamma)
        xyzs = ph.b.get("xyzs")
        out = {"loss": [], "grads": [], "grad_max": {}, "change": []}
        for i, state in enumerate(gen_states):
            total, new = ph.loss(params, state, xyzs)
            grads = ph.grads(total, named)
            out["loss"].append(float(total.detach()))
            for k, g in grads.items():
                out["grad_max"][k] = max(out["grad_max"].get(k, 0.0), float(torch.linalg.norm(g)))
            prev = {k: m.clone() for k, m in adam.mu.items()}
            adam.step(grads)
            out["grads"].append(step_grads(adam.mu, prev, adam.b1))
            out["change"].append({k: float(torch.linalg.norm(v.detach() - start[k]))
                                  for k, v in named.items()})
            if new is not None:
                xyzs = torch.where(torch.isfinite(new).all(-1, keepdim=True), new, xyzs)
            if i == 0:
                out["after1"] = {"params": _clone(params),
                                 "xyzs": None if xyzs is None else xyzs.clone()}
    return out


def grads_at(kind, opt, scene, cam_ids, params0, at, gen_state, max_iter, xyzs=None,
             precision="float32"):
    """{leaf: gradient norm} of one step's loss of phase ``kind`` at the
    parameters ``at`` (and, for BA, the carried track points ``xyzs``),
    with the draws of ``gen_state``; the occupancy grid is built from
    ``params0``, where the phase started. A non-finite gradient reads as
    the optimizer takes it: all zeros."""
    with _tf32() if precision == "tf32" else contextlib.nullcontext():
        ph = Phase(kind, opt, scene, cam_ids, params0, max_iter)
        params, named = ph.params(at)
        total, _ = ph.loss(params, gen_state,
                           ph.b.get("xyzs") if xyzs is None else xyzs.to(ph.dev))
        grads = ph.grads(total, named)
        ok = all(bool(torch.isfinite(g).all()) for g in grads.values())
        return {k: float(torch.linalg.norm(g)) if ok else 0.0 for k, g in grads.items()}


def step_grads(mu, prev, b1):
    """{leaf: norm of the gradient the optimizer took in its last step},
    from its first moment after and before it: g = (mu - b1 prev) / (1 - b1)."""
    return {k: float(torch.linalg.norm((m - b1 * prev[k]) / (1 - b1))) for k, m in mu.items()}


@contextlib.contextmanager
def _tf32():
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c
