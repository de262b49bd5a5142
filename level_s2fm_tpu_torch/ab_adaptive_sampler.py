"""A/B: adaptive VolSDF error-bound sampling against the default paths.

    python -m level_s2fm_tpu_torch.ab_adaptive_sampler [--cpu] [--steps 300]
        [--rays 2048] [--hw 128] [--out output/ab_adaptive_sampler.json]

The port's counterpart of ``scripts/ab_adaptive_sampler.py``, on the card
unless ``--cpu`` is given. It fits the SDF and radiance fields from
scratch to the synthetic textured-sphere scene (views 0-2 to train, view
3 held out) for ``--steps`` Adam steps (lr 1e-3) at the same rays per
step under three sampling arms:

  uniform128+occ32  the production default: 128 uniform samples,
                    compacted to the 32 in the occupancy band, composited
                    by the fused kernels (K1/K2)
  uniform128        the reference-equivalent full evaluation
  adaptive          the error-bound up-sampling
                    (``SDF.VolSDF.volsdf_sampling``)

Per arm it reports the train rays/s (forward + backward), the held-out
PSNR over the view's foreground pixels, rendered by one common protocol
(uniform 128, no compaction), and the train seconds: quality per ray
and per second. The arms draw their batches in turn from one
``np.random.default_rng(0)``, as the JAX script does, so both draw the
same pixels. Writes the JSON (with the device's name and power limit)
to ``--out``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ARMS = ("uniform128+occ32", "uniform128", "adaptive")


def ab_opt(mode: str, H: int, W: int, rays: int):
    """The JAX script's options for an arm."""
    from .config import Opt
    return Opt({
        "Res": 100,
        "Ablate_config": {"dual_field": False},
        "SDF": {"arch": {"layers": [None, 64, 16], "skip": []},
                "NN_Init": {"scale_mlp": 1, "bias": 0.5, "tf_init": True},
                "VolSDF": {"sample_intvs": 128, "final_sample_intvs": 32,
                           "volsdf_sampling": mode == "adaptive",
                           "max_upsample_iter": 2, "iters_max_st": 10,
                           "eps": 0.1, "beta_init": 0.05, "rescale": 1.0,
                           "beta_speed": 1.0, "sdf_threshold": 1e-3},
                "Hash_config": {"compute_dtype": "bfloat16"}},
        "RadF": {"arch": {"layers": [None, 64, 64, 3], "skip": []}},
        "data": {"bound_min": [-1, -1, -1], "bound_max": [1, 1, 1],
                 "inside": True, "bg_sdf": None, "bg_rad": 2.0,
                 "scene": "ab", "bgcolor": [0, 0, 0], "image_size": [H, W]},
        "Renderer": {"rand_rays": rays},
    })


def configs(mode: str, H: int, W: int, rays: int):
    """(sdf_cfg, rad_cfg, ren_cfg) of an arm."""
    from .fields import radiance as radf, sdf as sdf_mod
    from .rendering import renderer as ren_mod
    opt = ab_opt(mode, H, W, rays)
    ren_cfg = ren_mod.config_from_opt(opt)
    if mode == "uniform128+occ32":
        ren_cfg = dataclasses.replace(ren_cfg, compact_samples=32)
    return sdf_mod.config_from_opt(opt), radf.config_from_opt(opt), ren_cfg


def initial_params(H: int, W: int, rays: int, device, seed: int = 0):
    """The arms' common initial parameters, from a torch generator."""
    import torch
    from .fields import radiance as radf, sdf as sdf_mod
    sdf_cfg, rad_cfg, _ = configs("uniform128", H, W, rays)
    gen = torch.Generator().manual_seed(seed)
    return {"sdf": sdf_mod.init_params(sdf_cfg, gen, device=device),
            "rad": radf.init_params(rad_cfg, gen, device=device)}


def _trainable(tree):
    """A copy of a parameter tree whose leaves require grad."""
    from .convert import _map
    return _map(tree, lambda t: t.detach().clone().requires_grad_(True))


def _loss(out, rgb_gt):
    import torch
    n = torch.linalg.norm(out["normals"], dim=-1)
    return (torch.mean(torch.abs(out["rgb"] - rgb_gt))
            + 0.01 * torch.mean(torch.abs(n - 1.0)))


def card_info():
    """(platform, device name, power limit) of the run's device."""
    import torch
    if not torch.cuda.is_available():
        return "cpu", "cpu", None
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip().splitlines()[0]
        limit = smi.split(",")[-1].strip()
    except (OSError, IndexError, subprocess.SubprocessError):
        limit = None
    return "gpu", torch.cuda.get_device_name(0), limit


def run(steps=300, rays=2048, hw=128, device="cuda", params0=None):
    """The three arms. ``params0`` (optional): the common initial
    parameters as a tree of numpy arrays in the JAX package's layout
    (``convert.params_from_jax``); else ``initial_params``. Returns
    {mode: {rays_per_s, psnr_heldout_fg, train_s, losses (one a step)}}."""
    import torch
    from .data import synthetic
    from .fields import sdf as sdf_mod
    from .geometry import transforms as T
    from .rendering import raymarch as rm, renderer as ren_mod
    from .sfm.optim import PhaseAdam

    dev = torch.device(device)
    H = W = hw
    scene = synthetic.make_scene(n_views=4, H=H, W=W, n_points=64, seed=0,
                                 detail=0.35)
    grid = T.mesh_grid(H, W, device=dev)
    poses = torch.as_tensor(np.asarray(scene.poses_gt), dtype=torch.float32, device=dev)
    intrs = torch.as_tensor(np.asarray(scene.intrs), dtype=torch.float32, device=dev)
    images = [torch.as_tensor(np.asarray(im, np.float32), device=dev) for im in scene.images]
    if params0 is None:
        params0 = initial_params(H, W, rays, dev)
    else:
        from .convert import params_from_jax
        params0 = params_from_jax(params0, device=dev)

    def rays_for(view, pix):
        c, r = T.get_center_and_ray(poses[view][None], intrs[view], grid[pix])
        return c, r

    def make_step(sdf_cfg, rad_cfg, ren_cfg, occ):
        def step(p, opt, c, r, gt):
            out = ren_mod.render(p["sdf"], sdf_cfg, p["rad"], rad_cfg, ren_cfg,
                                 c, r, occ_grid=occ)
            loss = _loss(out, gt)
            grads = torch.autograd.grad(loss, opt.leaves)
            with torch.no_grad():
                for leaf, u in zip(opt.leaves, opt.updates(list(grads))):
                    leaf.add_(u)
            return loss.detach()
        return step

    def adam(p):
        return PhaseAdam(p, {"sdf": "all", "rad": "all"}, {"all": 1e-3}, 1.0)

    rng = np.random.default_rng(0)
    results = {}
    for mode in ARMS:
        sdf_cfg, rad_cfg, ren_cfg = configs(mode, H, W, rays)
        occ = None
        if ren_cfg.compact_samples is not None:
            with torch.no_grad():
                occ = rm.build_occupancy_grid(
                    lambda x: sdf_mod.infer_sdf(params0["sdf"], sdf_cfg, x),
                    torch.zeros(3), torch.ones(3), resolution=64, threshold=0.25,
                    one_sided=True, device=dev)
        step = make_step(sdf_cfg, rad_cfg, ren_cfg, occ)
        batches = []
        for _ in range(steps):
            view = int(rng.integers(0, 3))
            pix = rng.integers(0, H * W, size=rays)
            pix_t = torch.as_tensor(pix, device=dev)
            c, r = rays_for(view, pix_t)
            batches.append((c, r, images[view].reshape(-1, 3)[pix_t][None]))
        # warm-up on a copy: the timed run starts from params0
        warm = _trainable(params0)
        step(warm, adam(warm), *batches[0])
        del warm
        p = _trainable(params0)
        opt = adam(p)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [step(p, opt, *b) for b in batches]
        losses = [float(x) for x in losses]
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0

        # the common eval protocol: uniform 128 over held-out view 3
        _, _, eval_cfg = configs("uniform128", H, W, rays)
        with torch.no_grad():
            c, r = rays_for(3, torch.arange(H * W, device=dev))
            out = ren_mod.render(p["sdf"], sdf_cfg, p["rad"], rad_cfg, eval_cfg, c, r)
        est = out["rgb"][0].reshape(H, W, 3).cpu().numpy()
        gt_img = np.asarray(scene.images[3])
        fg = np.any(gt_img > 0.02, axis=-1)
        mse = float(np.mean((est[fg] - gt_img[fg]) ** 2))
        results[mode] = {"rays_per_s": rays * steps / dt,
                         "psnr_heldout_fg": float(-10 * np.log10(mse)),
                         "train_s": dt, "losses": losses}
        del p, opt, batches, out
        print(mode, {k: v for k, v in results[mode].items() if k != "losses"},
              flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--rays", type=int, default=2048)
    ap.add_argument("--hw", type=int, default=128)
    ap.add_argument("--out", default="output/ab_adaptive_sampler.json")
    args = ap.parse_args(argv)
    import torch
    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run on the GPU, or pass --cpu")
    results = run(args.steps, args.rays, args.hw, "cpu" if args.cpu else "cuda")
    platform, name, limit = ("cpu", "cpu", None) if args.cpu else card_info()
    summary = {mode: {"rays_per_s": round(r["rays_per_s"], 1),
                      "psnr_heldout_fg": round(r["psnr_heldout_fg"], 3),
                      "train_s": round(r["train_s"], 2)}
               for mode, r in results.items()}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"steps": args.steps, "rays": args.rays, "hw": args.hw,
                   "backend": platform, "device": name, "power_limit": limit,
                   "results": summary}, f, indent=1)
    print(json.dumps(summary))
    return results


if __name__ == "__main__":
    main()
    sys.exit(0)
