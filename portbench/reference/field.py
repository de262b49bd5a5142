"""Plain PyTorch SDF and radiance fields, and the sphere trace.

The benchmark's own statement of the math that the port's timed step
runs (``level_s2fm_tpu_torch/fields``): the multiresolution hash
encoding with bf16 table reads, its analytic spatial Jacobian, the
weight-normalised geometry MLP (softplus(beta=100)) with its input
gradient, the radiance MLP (no hidden activation), the Fourier view
embedding, and the bidirectional fixed-trip sphere march with its
differentiable re-evaluation. Only plain tensor operations: no kernel,
no custom autograd function, no import of the port. Gradients come from
autograd, so the table's cotangent is summed by ``index_put``'s
accumulation.

Parameters use the port's layout: ``{"sdf": {"table" [L,T,F], "mlp":
{"layers": [{"V","g","b"}, ...]}, "beta" [1]}, "rad": {"rad_mlp":
{"layers": [...]}}}``. ``cfg`` is the dict that ``config`` builds from a
configuration file's options.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF
_OFFSETS8 = tuple((i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1))


def config(opt) -> dict:
    """The sizes the reference needs, read from the option tree of a
    configuration file (plain dicts)."""
    sdf, hc, vs = opt["SDF"], opt["SDF"]["Hash_config"], opt["SDF"]["VolSDF"]
    L, log2_T, n_min = hc["n_levels"], hc["log2_hashmap_size"], hc["base_resolution"]
    bmin, bmax = opt["data"]["bound_min"], opt["data"]["bound_max"]
    scale = float(bmax[0] - bmin[0]) / 2
    b = float(np.exp(np.log(2048 * scale / n_min) / (L - 1)))
    ren = opt["Renderer"]
    return {
        "L": L, "T": 1 << log2_T,
        "res": np.floor(n_min * b ** np.arange(L)).astype(np.int64),
        "bf16": hc["compute_dtype"] == "bfloat16",
        "bmin": tuple(float(x) for x in bmin), "bmax": tuple(float(x) for x in bmax),
        "scale_mlp": float(sdf["NN_Init"]["scale_mlp"]),
        "beta_speed": float(vs["beta_speed"]),
        "sdf_threshold": float(vs["sdf_threshold"]),
        "iters_max": int(vs["iters_max_st"]),
        "finish_threshold": float(bmax[0] - bmin[0]) / 10.0 / int(opt.get("Res", 100)),
        "sample_intvs": int(vs["sample_intvs"]),
        "compact": int(ren["compact_samples"]),
        "occ_res": int(ren.get("occ_res", 64)),
        "occ_threshold": float(ren.get("occ_threshold", 0.25)),
        "ray_chunk": int(ren.get("ray_chunk", 2048)),
        "rand_rays": int(ren["rand_rays"]),
        "bgcolor": [float(c) for c in (opt["data"].get("bgcolor") or (0.0, 0.0, 0.0))],
    }


# --------------------------------------------------------------------------- hash encoding

def _corners(x, cfg):
    """Table rows [L,N,8] of the 8 trilinear corners of every level, and
    the fractional positions [L,N,3]; x [N,3] in [0,1]^3."""
    dev = x.device
    res = torch.as_tensor(cfg["res"], device=dev)
    pos = x[None] * res[:, None, None].to(x.dtype)
    base = torch.floor(pos)
    frac = pos - base
    off = torch.as_tensor(_OFFSETS8, dtype=torch.int64, device=dev)
    c = base.to(torch.int64)[:, :, None, :] + off[None, None]
    c = torch.minimum(torch.clamp(c, min=0), res[:, None, None, None])
    T = cfg["T"]
    r1 = (res + 1)[:, None, None]
    cx, cy, cz = c[..., 0], c[..., 1], c[..., 2]
    dense = ((cx + r1 * (cy + r1 * cz)) & _U32) % T
    hashed = (((cx * _PRIMES[0]) & _U32) ^ ((cy * _PRIMES[1]) & _U32)
              ^ ((cz * _PRIMES[2]) & _U32)) % T
    fits = torch.as_tensor((cfg["res"] + 1) ** 3 <= T, device=dev)[:, None, None]
    idx = torch.where(fits, dense, hashed)
    rows = idx + (torch.arange(cfg["L"], device=dev) * T)[:, None, None]
    return rows, frac


def _gather(table, rows, cfg):
    """Corner features [L,N,8,F]; with bf16 reads the values are rounded
    to bf16 and the cotangent reaches the table unrounded."""
    flat = table.reshape(-1, table.shape[-1])
    v = flat[rows.reshape(-1)]
    if cfg["bf16"]:
        v = v + (v.to(torch.bfloat16).to(v.dtype) - v).detach()
    return v.reshape(*rows.shape, table.shape[-1])


def _weights(frac):
    off = torch.as_tensor(_OFFSETS8, dtype=torch.int64, device=frac.device)
    hi = off[None, None] == 1
    wd = torch.where(hi, frac[:, :, None, :], 1.0 - frac[:, :, None, :])
    sgn = torch.where(off == 1, 1.0, -1.0).to(frac.dtype)
    return wd, sgn


def _bounds(like, cfg):
    return (torch.as_tensor(cfg["bmin"], dtype=like.dtype, device=like.device),
            torch.as_tensor(cfg["bmax"], dtype=like.dtype, device=like.device))


def embed(table, xyz, cfg):
    """[...,3] -> [..., 3 + L*F]: the raw point, then the levels."""
    lead = xyz.shape[:-1]
    bmin, bmax = _bounds(xyz, cfg)
    x = (xyz.reshape(-1, 3) - bmin) / (bmax - bmin)
    rows, frac = _corners(x, cfg)
    feats = _gather(table, rows, cfg)
    wd, _ = _weights(frac)
    w = wd[..., 0] * wd[..., 1] * wd[..., 2]
    enc = torch.sum(feats * w[..., None], dim=2).transpose(0, 1).reshape(x.shape[0], -1)
    return torch.cat([xyz.reshape(-1, 3), enc], -1).reshape(*lead, -1)


def embed_with_grad(table, xyz, cfg):
    """(embedding [...,D], d embedding / d xyz [...,D,3])."""
    lead = xyz.shape[:-1]
    bmin, bmax = _bounds(xyz, cfg)
    scale = 1.0 / (bmax - bmin)
    x = (xyz.reshape(-1, 3) - bmin) * scale
    N = x.shape[0]
    rows, frac = _corners(x, cfg)
    feats = _gather(table, rows, cfg)
    wd, sgn = _weights(frac)
    w = wd[..., 0] * wd[..., 1] * wd[..., 2]
    enc = torch.sum(feats * w[..., None], dim=2)
    others = torch.stack([wd[..., 1] * wd[..., 2], wd[..., 0] * wd[..., 2],
                          wd[..., 0] * wd[..., 1]], dim=-1)
    res = torch.as_tensor(cfg["res"], device=x.device).to(x.dtype)
    dw = sgn * others * res[:, None, None, None]
    denc = torch.einsum("lncf,lncj->lnfj", feats, dw)
    enc = enc.transpose(0, 1).reshape(N, -1)
    denc = denc.transpose(0, 1).reshape(N, -1, 3) * scale
    eye = torch.eye(3, dtype=x.dtype, device=x.device).expand(N, 3, 3)
    enc = torch.cat([xyz.reshape(-1, 3), enc], -1)
    denc = torch.cat([eye, denc], -2)
    return enc.reshape(*lead, -1), denc.reshape(*lead, -1, 3)


# --------------------------------------------------------------------------- MLPs

def _w(p):
    return p["g"] * p["V"] / torch.linalg.norm(p["V"], dim=1, keepdim=True)


def geometry_mlp(params, x):
    n = len(params["layers"])
    for i, p in enumerate(params["layers"]):
        x = x @ _w(p).T + p["b"]
        if i < n - 1:
            x = F.softplus(x, beta=100.0)
    return x


def geometry_mlp_with_input_grad(params, x):
    """(output, d output[...,0] / d input)."""
    n = len(params["layers"])
    Ws, zs = [], []
    for i, p in enumerate(params["layers"]):
        W = _w(p)
        z = x @ W.T + p["b"]
        Ws.append(W)
        zs.append(z)
        x = F.softplus(z, beta=100.0) if i < n - 1 else z
    g = Ws[-1][0].expand(*zs[-1].shape[:-1], Ws[-1].shape[1])
    for i in range(n - 2, -1, -1):
        g = (g * torch.sigmoid(100.0 * zs[i])) @ Ws[i]
    return x, g


def radiance_mlp(params, x):
    for p in params["layers"]:
        x = x @ _w(p).T + p["b"]
    return torch.sigmoid(x)


def fourier(d, n_freqs=4, max_log2=3.0):
    out = [d]
    for f in 2.0 ** np.linspace(0.0, max_log2, n_freqs):
        out += [torch.sin(d * float(f)), torch.cos(d * float(f))]
    return torch.cat(out, -1)


# --------------------------------------------------------------------------- SDF

def sdf(params, cfg, xyz):
    """[...,3] -> [...] signed distance (the object is inside)."""
    return geometry_mlp(params["mlp"], embed(params["table"], xyz, cfg))[..., 0] / cfg["scale_mlp"]


def sdf_feat_normal(params, cfg, xyz):
    """(sdf [...], feature [...,D], normal [...,3]) from one encode."""
    enc, denc = embed_with_grad(params["table"], xyz, cfg)
    feat, dfeat = geometry_mlp_with_input_grad(params["mlp"], enc)
    normal = torch.einsum("...d,...dj->...j", dfeat * (1.0 / cfg["scale_mlp"]), denc)
    return feat[..., 0] / cfg["scale_mlp"], feat, normal


def alpha_beta(params, cfg):
    beta = torch.exp(params["beta"] * cfg["beta_speed"])
    return 1.0 / beta, beta


def ray_box(o, d, cfg, eps=1e-10):
    """Slab intersection with the bounds: (t_near >= 0, t_far, hit); a
    miss gives -1 for both."""
    bmin = torch.as_tensor(cfg["bmin"], dtype=o.dtype, device=o.device)
    bmax = torch.as_tensor(cfg["bmax"], dtype=o.dtype, device=o.device)
    c, h = (bmax + bmin) / 2, (bmax - bmin) / 2
    inv = 1.0 / torch.where(torch.abs(d) < eps, torch.where(d >= 0, eps, -eps), d)
    lo, hi = (c - h - o) * inv, (c + h - o) * inv
    t1 = torch.clamp(torch.minimum(lo, hi).amax(-1), min=0.0)
    t2 = torch.maximum(lo, hi).amin(-1)
    hit = t2 > t1
    return torch.where(hit, t1, -1.0), torch.where(hit, t2, -1.0), hit


@torch.no_grad()
def march(params, cfg, o, d):
    """The detached bidirectional march of rays o, d [BN,3]: each trip
    steps the entry side forward and the exit side backward by the SDF,
    a side stops once |sdf| is within the threshold, and the loop ends
    when no entry side is unfinished. Returns the entry-side positions of
    every executed trip [n,BN,3] and the ray-box hits."""
    BN = o.shape[0]
    t0, t1, hit = ray_box(o, d, cfg)
    thr = cfg["sdf_threshold"]
    ns = sdf(params, cfg, o + t0[:, None] * d)
    ne = sdf(params, cfg, o + t1[:, None] * d)
    acc_s, acc_e = t0, t1
    unf_s = torch.ones(BN, dtype=torch.bool, device=o.device)
    unf_e = unf_s.clone()
    track = []
    for i in range(cfg["iters_max"]):
        cs = torch.where(torch.abs(ns) <= thr, 0.0, ns)
        ce = torch.where(torch.abs(ne) <= thr, 0.0, ne)
        nus = torch.abs(cs) > thr if i == 0 else unf_s & (torch.abs(cs) > thr)
        nue = torch.abs(ce) > thr if i == 0 else unf_e & (torch.abs(ce) > thr)
        if not bool(nus.any()):
            break
        track.append(o + acc_s[:, None] * d)
        acc_s = torch.minimum(acc_s + cs, t1)
        acc_e2 = torch.minimum(acc_e + ce, t1)
        ns = torch.where(nus, sdf(params, cfg, o + acc_s[:, None] * d), ns)
        if bool(nue.any()):
            ne = torch.where(nue, sdf(params, cfg, o + acc_e2[:, None] * d), ne)
        acc_e = acc_e2
        ok = acc_s < acc_e
        unf_s, unf_e = nus & ok, nue & ok
    if not track:
        track = [o + t0[:, None] * d]
    return {"track": torch.stack(track), "t0": t0, "t1": t1, "hit": hit}


def reeval(params, cfg, m, o, d):
    """Differentiable depth along a march: t_near + the sum of the SDF
    over the executed trips, capped at t_far. Returns (depth [BN],
    sdf at the last trip [BN], finished [BN], surface point [BN,3])."""
    s = sdf(params, cfg, m["track"])
    depth = torch.minimum(s.sum(0) + m["t0"], m["t1"])
    last = s[-1]
    fin = (torch.abs(last.detach()) < cfg["finish_threshold"]) & m["hit"]
    return depth, last, fin, o + d * depth[:, None]


def eikonal_draws(cfg, BN, gen, n_track=4096, n_max=4096):
    """The draws of a sphere trace's eikonal samples over BN rays, made
    from ``gen`` as the port makes them (no loss of these phases reads the
    samples, but the generator has to advance alike)."""
    torch.rand(BN, generator=gen)
    n_pick = min(n_track, BN)
    torch.randperm(BN, generator=gen)
    total = n_pick * cfg["iters_max"] + BN
    if total > n_max:
        torch.randperm(total, generator=gen)
