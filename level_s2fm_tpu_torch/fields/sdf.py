"""Hash-encoded SDF field + sphere tracing in PyTorch.

Counterpart of ``level_s2fm_tpu/fields/sdf.py`` (default paths):

* ``infer_sdf`` / ``infer_all`` — hash-encode -> geometry MLP -> signed
  distance with the inside/outside sign convention and the optional
  background-sphere min.
* ``infer_all_with_normal`` — sdf, feature and the analytic normal from
  one gather pass (the encode's spatial Jacobian chained through the
  MLP's input gradient, all tensor ops, so an eikonal loss can
  differentiate the normal w.r.t. the table and w.r.t. x).
* ``gradient`` — the normal alone. The JAX package's
  ``gradient_chunked`` / ``infer_with_normal_chunked`` split their
  points only to stay under a TPU compiler limit; here every point goes
  through ``gradient`` / ``infer_all_with_normal`` in one pass.
* ``infer_sdf_host`` — a no-grad eval returning numpy for host callers
  (PnP gating, NBV scoring), at the exact N.
* ``get_surface_pts`` — BA's projection of points onto the zero level
  set along the analytic normal (differentiable w.r.t. the field).
* ``sphere_march`` / ``sphere_reeval`` / ``sphere_tracing`` — the
  bidirectional fixed-trip march under ``no_grad``, then the
  differentiable re-evaluation along the stored track: depth = t_min +
  sum(sdf(track)).

The march follows the JAX ``fori_loop`` step for step. Where the JAX code
skips work with ``lax.cond`` on "any ray still unfinished", this code
reads that flag on the host (one sync per step) and skips the eval; once
no ray is unfinished every later JAX step is a no-op, so the loop stops
there and the unexecuted rows stay zero as in JAX.

Two exact compactions (default off) skip hash-grid evaluations without
changing any value: ``march_compact`` evaluates a march step only at
its unfinished rays once at most ``march_compact * BN`` are left, and
``reeval_compact`` evaluates each distinct track point once (a
converged ray repeats its last point) and fills the repeats from it.
Both take their "at most K" decision from the count the march already
reads each step, so they add no host sync.

Field parameters: {"table": [L,T,F], "mlp": {"layers": [...]}, "beta": [1]}.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import hashgrid, mlp
from ..rendering import aabb as aabb_mod
from ..utils import obs


def _safe_r(xyz):
    """|xyz| with a finite gradient at the origin."""
    return torch.sqrt(torch.sum(xyz * xyz, dim=-1, keepdim=True) + 1e-12)


@dataclasses.dataclass(frozen=True)
class SDFConfig:
    grid: hashgrid.HashGridConfig
    layers: Tuple[Optional[int], ...] = (None, 64, 16)
    skip: Tuple[int, ...] = ()
    bound_min: Tuple[float, float, float] = (-1.0, -1.0, -1.0)
    bound_max: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    inside: bool = True
    bg_sdf: bool = False
    bg_rad: float = 2.0
    scale_mlp: float = 1.0
    sphere_bias: float = 1.0
    tf_init: bool = True
    rescale: float = 1.0
    beta_init: float = 0.05
    beta_speed: float = 1.0
    sdf_threshold: float = 1e-3
    iters_max: int = 20
    res: int = 100  # `opt.Res` — sphere-trace convergence resolution
    # >0: evaluate each distinct track point once in the re-eval, when
    # the march's distinct points fit a budget of this fraction of
    # iters_max * BN (else the full eval); see sphere_reeval
    reeval_compact: float = 0.0
    # >0: evaluate a march step only at its unfinished rays once at most
    # this fraction of BN is unfinished (else the full eval)
    march_compact: float = 0.0

    @property
    def feat_dim(self) -> int:
        return self.layers[-1] + 1

    @property
    def center(self):
        return (np.asarray(self.bound_max) + np.asarray(self.bound_min)) / 2

    @property
    def half_size(self):
        return (np.asarray(self.bound_max) - np.asarray(self.bound_min)) / 2

    @property
    def finish_threshold(self) -> float:
        return (self.bound_max[0] - self.bound_min[0]) / 10.0 / self.res


def config_from_opt(opt) -> SDFConfig:
    vs = opt.SDF.VolSDF
    return SDFConfig(
        grid=hashgrid.config_from_opt(opt),
        layers=tuple(opt.SDF.arch.layers),
        skip=tuple(opt.SDF.arch.get("skip", ())),
        bound_min=tuple(opt.data.bound_min),
        bound_max=tuple(opt.data.bound_max),
        inside=bool(opt.data.get("inside", True)),
        bg_sdf=bool(opt.data.get("bg_sdf") or False),
        bg_rad=float(opt.data.get("bg_rad", 2.0)),
        scale_mlp=float(opt.SDF.NN_Init.scale_mlp),
        sphere_bias=float(opt.SDF.NN_Init.bias),
        tf_init=bool(opt.SDF.NN_Init.get("tf_init", True)),
        rescale=float(vs.rescale),
        beta_init=float(vs.beta_init),
        beta_speed=float(vs.beta_speed),
        sdf_threshold=float(vs.sdf_threshold),
        iters_max=int(vs.iters_max_st),
        res=int(opt.get("Res", 100)),
        reeval_compact=float(vs.get("reeval_compact", 0.0) or 0.0),
        march_compact=float(vs.get("march_compact", 0.0) or 0.0),
    )


def init_params(cfg: SDFConfig, gen: torch.Generator, device=None):
    table = hashgrid.init_table(cfg.grid, gen, device=device)
    mlp_params = mlp.init_geometry_mlp(gen, cfg.grid.out_dim, cfg.layers,
                                       cfg.skip, sphere_bias=cfg.sphere_bias,
                                       tf_init=cfg.tf_init, device=device)
    beta = torch.tensor([math.log(cfg.beta_init) / cfg.beta_speed],
                        dtype=torch.float32, device=device)
    return {"table": table, "mlp": mlp_params, "beta": beta}


# ----------------------------------------------------------------------------- core eval

def infer_feat(params, cfg: SDFConfig, xyz: torch.Tensor) -> torch.Tensor:
    enc = hashgrid.embed(params["table"], xyz, cfg.grid,
                         cfg.bound_min, cfg.bound_max, rescale=cfg.rescale)
    return mlp.apply_geometry_mlp(params["mlp"], enc, skip=cfg.skip)


def _sdf_from_feat(cfg: SDFConfig, feat, xyz):
    if cfg.inside:
        sdf = feat[..., :1] / cfg.scale_mlp
        if cfg.bg_sdf:
            sdf = torch.minimum(sdf, cfg.bg_rad - _safe_r(xyz))
    else:
        sdf = -feat[..., :1] / cfg.scale_mlp
    return sdf


def infer_sdf(params, cfg: SDFConfig, xyz: torch.Tensor) -> torch.Tensor:
    """[...,3] -> [...,1] signed distance."""
    return _sdf_from_feat(cfg, infer_feat(params, cfg, xyz), xyz)


def infer_all(params, cfg: SDFConfig, xyz: torch.Tensor):
    """(sdf [...,1], feat [...,feat_dim]) in one eval."""
    feat = infer_feat(params, cfg, xyz)
    return _sdf_from_feat(cfg, feat, xyz), feat


def infer_all_with_normal(params, cfg: SDFConfig, xyz: torch.Tensor):
    """(sdf [...,1], feat [...,D], normal [...,3]) in ONE hash-gather pass."""
    enc, denc = hashgrid.embed_with_grad(params["table"], xyz, cfg.grid,
                                         cfg.bound_min, cfg.bound_max,
                                         rescale=cfg.rescale)
    sign = 1.0 if cfg.inside else -1.0
    feat, dfeat0_denc = mlp.geometry_mlp_with_input_grad(
        params["mlp"], enc, skip=cfg.skip)
    sdf_raw = sign * feat[..., :1] / cfg.scale_mlp
    dsdf_denc = dfeat0_denc * (sign / cfg.scale_mlp)
    normal = torch.einsum("...d,...dj->...j", dsdf_denc, denc)
    sdf = sdf_raw
    if cfg.inside and cfg.bg_sdf:
        r = _safe_r(xyz)
        bg = cfg.bg_rad - r
        take_bg = bg < sdf_raw
        sdf = torch.where(take_bg, bg, sdf_raw)
        bg_normal = -xyz / torch.clamp(r, min=1e-12)
        normal = torch.where(take_bg, bg_normal, normal)
    return sdf, feat, normal


def gradient(params, cfg: SDFConfig, xyz: torch.Tensor) -> torch.Tensor:
    """Spatial SDF gradient (normals) from the fused analytic path;
    differentiable again w.r.t. the field parameters."""
    return infer_all_with_normal(params, cfg, xyz)[2]


@torch.no_grad()
def infer_sdf_host(params, cfg: SDFConfig, pts: np.ndarray) -> np.ndarray:
    """SDF at host points [N,3] -> numpy [N], evaluated on the field's
    device at the exact N."""
    pts = np.asarray(pts, np.float32).reshape(-1, 3)
    if pts.shape[0] == 0:
        return np.zeros((0,), np.float32)
    x = torch.as_tensor(pts).to(params["table"].device)
    return infer_sdf(params, cfg, x)[:, 0].cpu().numpy()


def get_surface_pts(params, cfg: SDFConfig, pts: torch.Tensor):
    """Project points to the zero level set along the (unnormalized)
    normal: surf = pts - n * sdf / detach(max(|n|, 1e-8)). Returns
    (surf_pts, |n|). sdf and normal come from one fused eval at the
    detached points; the clamp keeps a flat region's step finite."""
    sdf, _, normals = infer_all_with_normal(params, cfg, pts.detach())
    nval = torch.linalg.norm(normals, dim=-1, keepdim=True)
    denom = torch.clamp(nval, min=1e-8).detach()
    return pts - normals / denom * sdf, nval


def forward_ab(params, cfg: SDFConfig):
    beta = torch.exp(params["beta"] * cfg.beta_speed)
    return 1.0 / beta, beta


def sdf_to_sigma(sdf, alpha, beta):
    """Laplace-CDF density (VolSDF)."""
    e = 0.5 * torch.exp(-torch.abs(sdf) / beta)
    return alpha * torch.where(sdf >= 0, e, 1 - e)


# ----------------------------------------------------------------------------- sphere tracing

class SphereTraceResult(NamedTuple):
    d_pred: torch.Tensor        # [B,N] predicted depth (differentiable)
    sdf_surf: torch.Tensor      # [B*N] sdf at the last traced point (differentiable)
    sample_pts: torch.Tensor    # [1,K,3] track subsample + free-space samples (detached)
    finish_mask: torch.Tensor   # [B*N,1] bool convergence mask
    pts_surface: torch.Tensor   # [B,N,3] surface points center + d*ray (differentiable)


class SphereMarch(NamedTuple):
    """Detached march state; feed to ``sphere_reeval``."""
    track: torch.Tensor         # [iters, BN, 3] positions appended per step
    contrib: torch.Tensor       # [iters] bool — steps that executed
    last_idx: int               # index of the last contributing step
    min_dis: torch.Tensor       # [BN]
    max_dis: torch.Tensor       # [BN]
    acc_e: torch.Tensor         # [BN] backward-march accumulated depth
    valid: torch.Tensor         # [BN] ray-AABB hit mask
    # distinct track rows of the whole march (a bound for any slice of
    # it); counted only with reeval_compact, else -1
    n_uniq: int = -1


def _active_budget(frac: float, n: int) -> int:
    """The compaction budget K of a fraction ``frac`` of ``n`` slots (0:
    off), as the JAX package sizes it."""
    return max(int(frac * n), 1) if 0.0 < frac < 1.0 else 0


@obs.traced("sdf.march")
@torch.no_grad()
def sphere_march(params, cfg: SDFConfig, ray0: torch.Tensor,
                 ray_dir: torch.Tensor, stop_count=None) -> SphereMarch:
    """Bidirectional fixed-trip sphere-trace march (detached).

    ray0/ray_dir: [B,N,3] (ray_dir need not be unit). ``stop_count``,
    if given, maps a step's unfinished start-side rays [B*N] (bool) to
    the 0-d count that decides whether the loop goes on (the caller of a
    sharded batch counts every rank's valid rows, so that the march runs
    as long as one over the global batch: its length sets how many steps
    every ray's depth sums); else the local count decides. The other
    counts only size exact compactions.
    """
    BN = ray0.shape[0] * ray0.shape[1]
    o = ray0.reshape(BN, 3).detach()
    d = ray_dir.reshape(BN, 3).detach()
    dev, dt = o.device, o.dtype
    min_dis, max_dis, valid = aabb_mod.ray_aabb_intersect(
        o, d, torch.as_tensor(cfg.center, dtype=dt, device=dev),
        torch.as_tensor(cfg.half_size, dtype=dt, device=dev))
    thr = cfg.sdf_threshold

    def sdf_at(pts):
        return infer_sdf(params, cfg, pts)[..., 0]

    K_m = _active_budget(cfg.march_compact, BN)

    def sdf_at_active(pts, active, n_active):
        """sdf at the active rays (0 elsewhere, which the caller masks):
        only those are evaluated when they fit the budget K_m."""
        if K_m == 0 or K_m >= BN or n_active > K_m:
            return sdf_at(pts)
        score = active.to(pts.dtype)
        sel = torch.topk(score, K_m).indices          # the active rays first
        v = sdf_at(pts[sel]) * score[sel]             # zero the fillers
        return torch.zeros(BN, dtype=pts.dtype, device=dev).index_copy_(0, sel, v)

    count_uniq = 0.0 < cfg.reeval_compact < 1.0
    start0 = o + min_dis[:, None] * d
    nsdf_s = sdf_at(start0)
    nsdf_e = sdf_at(o + max_dis[:, None] * d)
    acc_s, acc_e = min_dis, max_dis
    unf_s = torch.ones(BN, dtype=torch.bool, device=dev)
    unf_e = torch.ones(BN, dtype=torch.bool, device=dev)
    track = torch.zeros((cfg.iters_max, BN, 3), dtype=dt, device=dev)
    n_exec, n_uniq = 0, BN
    for i in range(cfg.iters_max):
        curr_s = torch.where(torch.abs(nsdf_s) <= thr, 0.0, nsdf_s)
        curr_e = torch.where(torch.abs(nsdf_e) <= thr, 0.0, nsdf_e)
        if i == 0:
            new_unf_s = torch.abs(curr_s) > thr
            new_unf_e = torch.abs(curr_e) > thr
        else:
            new_unf_s = unf_s & (torch.abs(curr_s) > thr)
            new_unf_e = unf_e & (torch.abs(curr_e) > thr)
        pts_before = o + acc_s[:, None] * d    # what the track appends
        counts = [new_unf_s.sum(), new_unf_e.sum()]
        if count_uniq and i > 0:
            counts.append((pts_before != track[i - 1]).any(dim=-1).sum())
        if stop_count is not None:
            counts.append(stop_count(new_unf_s))
        # the step's one host read: unfinished rays of each side, and the
        # row's distinct points
        n_s, n_e, *moved = torch.stack(counts).tolist()
        n_go = moved.pop() if stop_count is not None else n_s
        if not n_go:
            # no step runs from here on: every later JAX step is a no-op
            break
        track[i] = pts_before
        n_exec = i + 1
        n_uniq += sum(moved)
        acc_s = torch.minimum(acc_s + curr_s, max_dis)
        acc_e2 = torch.minimum(acc_e + curr_e, max_dis)
        nsdf_s = torch.where(new_unf_s, sdf_at_active(
            o + acc_s[:, None] * d, new_unf_s, n_s), nsdf_s)
        if n_e:
            nsdf_e = torch.where(new_unf_e, sdf_at_active(
                o + acc_e2[:, None] * d, new_unf_e, n_e), nsdf_e)
        acc_e = acc_e2
        order_ok = acc_s < acc_e
        unf_s = new_unf_s & order_ok
        unf_e = new_unf_e & order_ok

    obs.count("march.calls")
    obs.count("march.rays", BN)
    obs.count("march.trips", n_exec)
    if n_exec == 0:
        track[0] = start0          # no step executed: the entry points
    contrib = torch.zeros(cfg.iters_max, dtype=torch.bool, device=dev)
    contrib[:max(n_exec, 1)] = True
    return SphereMarch(track=track, contrib=contrib,
                       last_idx=max(n_exec, 1) - 1, min_dis=min_dis,
                       max_dis=max_dis, acc_e=acc_e, valid=valid,
                       n_uniq=n_uniq if count_uniq else -1)


def march_slice(m: SphereMarch, lo: int, hi) -> SphereMarch:
    """Slice a march over its ray axis. ``contrib``/``last_idx`` stay
    global, as one bigger batch's loop would run."""
    return SphereMarch(track=m.track[:, lo:hi], contrib=m.contrib,
                       last_idx=m.last_idx, min_dis=m.min_dis[lo:hi],
                       max_dis=m.max_dis[lo:hi], acc_e=m.acc_e[lo:hi],
                       valid=m.valid[lo:hi], n_uniq=m.n_uniq)


def _reeval_track_compact(params, cfg: SDFConfig, track, K: int):
    """sdf along ``track`` [n,BN,3] with each ray's distinct points
    evaluated once (at most K of them, selected by topk and scattered
    back) and the repeats of a converged ray's last point filled from
    it, so the sum and the gradient (each repeat routes its cotangent to
    the one evaluated point) are those of the full eval. Repeats occur
    only as a ray's frozen tail."""
    n, BN = track.shape[0], track.shape[1]
    same = (track[1:] == track[:-1]).all(dim=-1)                 # [n-1,BN]
    uniq = torch.cat([torch.ones_like(same[:1]), ~same], dim=0)
    idxs = torch.arange(n, device=track.device)[:, None]
    k_last = torch.where(uniq, idxs, -1).amax(dim=0)              # [BN]
    score = uniq.reshape(-1).to(track.dtype)
    sel = torch.topk(score, K).indices                            # distinct first
    v = infer_sdf(params, cfg, track.reshape(-1, 3)[sel])[..., 0] * score[sel]
    vals = torch.zeros(n * BN, dtype=v.dtype, device=v.device).index_put(
        (sel,), v).reshape(n, BN)
    last_vals = vals.gather(0, k_last[None])
    return torch.where(idxs <= k_last[None], vals, last_vals)


@obs.traced("sdf.reeval")
def sphere_reeval(params, cfg: SDFConfig, m: SphereMarch,
                  ray0: torch.Tensor, ray_dir: torch.Tensor):
    """Differentiable re-evaluation of the SDF along a stored march track:
    depth = t_min + sum(sdf(track)).

    Returns (d_pred [B,N], sdf_surf [BN], finish_mask [BN,1],
    pts_surface [B,N,3]). Only the contributing steps (a prefix of the
    track) are evaluated: the others are masked out of every output.
    """
    B, N = ray0.shape[0], ray0.shape[1]
    n, BN = m.last_idx + 1, m.track.shape[1]
    K = min(_active_budget(cfg.reeval_compact, cfg.iters_max * BN), n * BN)
    if 0 <= m.n_uniq <= K < n * BN:
        sdf_tracks = _reeval_track_compact(params, cfg, m.track[:n], K)
    else:
        sdf_tracks = infer_sdf(params, cfg, m.track[:n])[..., 0]  # [n, BN]
    d_pred = torch.sum(sdf_tracks, dim=0) + m.min_dis
    d_pred = torch.minimum(d_pred, m.max_dis)
    sdf_last = sdf_tracks[m.last_idx]
    finish_mask = (torch.abs(sdf_last.detach()) < cfg.finish_threshold)[:, None]
    finish_mask = finish_mask & m.valid[:, None]
    pts_surface = ray0 + ray_dir * d_pred.reshape(B, N)[..., None]
    return d_pred.reshape(B, N), sdf_last, finish_mask, pts_surface


@torch.no_grad()
def march_samples(m: SphereMarch, ray0, ray_dir,
                  gen: Optional[torch.Generator] = None,
                  track_subsample: int = 4096,
                  max_sample_pts: Optional[int] = 4096,
                  factor_rand=None, pick=None, pick2=None) -> torch.Tensor:
    """Free-space + track sample points for eikonal regularization
    (detached). Returns [1,K,3]. The random draws (``factor_rand`` [BN],
    ``pick``, ``pick2``) may be given; otherwise they come from ``gen``
    (a CPU generator)."""
    BN = m.min_dis.shape[0]
    dev = m.min_dis.device
    o_d = ray0.reshape(BN, 3).detach()
    d_d = ray_dir.reshape(BN, 3).detach()
    if factor_rand is None:
        factor_rand = torch.rand(BN, generator=gen)
    factor_rand = torch.as_tensor(factor_rand, device=dev, dtype=o_d.dtype)
    d_up = torch.minimum(1.5 * m.acc_e, m.max_dis)
    d_sample = (1 - factor_rand) * d_up + factor_rand * m.min_dis
    free_pts = o_d + d_sample[:, None] * d_d
    n_pick = min(track_subsample, BN)
    if pick is None:
        pick = torch.randperm(BN, generator=gen)[:n_pick]
    pick = torch.as_tensor(pick, device=dev)
    track_pick = m.track.transpose(0, 1)[pick].reshape(-1, 3)
    sample_pts = torch.cat([track_pick, free_pts], dim=0)
    if max_sample_pts is not None and sample_pts.shape[0] > max_sample_pts:
        if pick2 is None:
            pick2 = torch.randperm(sample_pts.shape[0], generator=gen)[:max_sample_pts]
        sample_pts = sample_pts[torch.as_tensor(pick2, device=dev)]
    return sample_pts[None]


@obs.traced("sdf.tracing")
def sphere_tracing(params, cfg: SDFConfig, ray0: torch.Tensor,
                   ray_dir: torch.Tensor, gen: Optional[torch.Generator] = None,
                   track_subsample: int = 4096,
                   max_sample_pts: Optional[int] = 4096,
                   draws: Optional[dict] = None) -> SphereTraceResult:
    """Bidirectional sphere tracing: march + differentiable re-eval.
    ``draws`` (keys ``factor_rand``, ``pick``, ``pick2``) replaces the
    random draws of ``march_samples``."""
    m = sphere_march(params, cfg, ray0, ray_dir)
    d_pred, sdf_last, finish_mask, pts_surface = sphere_reeval(
        params, cfg, m, ray0, ray_dir)
    sample_pts = march_samples(m, ray0, ray_dir, gen, track_subsample,
                               max_sample_pts, **(draws or {}))
    return SphereTraceResult(d_pred=d_pred, sdf_surf=sdf_last,
                             sample_pts=sample_pts,
                             finish_mask=finish_mask, pts_surface=pts_surface)
