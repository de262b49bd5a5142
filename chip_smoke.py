#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port on one NVIDIA GPU.

    python3 chip_smoke.py

Imports nothing of JAX and nothing of the JAX package. Phases (any
failure raises and exits non-zero):

1. build — the CUDA kernels (``level_s2fm_tpu_torch/csrc/*.cu``, one nvcc
   per source, started together) and the minigeom host library (g++),
   from the sources in this checkout.
2. kernels — every kernel of the main path against its plain PyTorch
   version on the card, at the main path's shape and at ragged / chunked
   shapes, with the tolerance stated; then timed (CUDA events) beside
   its plain version and its bound (bytes over 3.35 TB/s or operations
   over 67 TFLOP/s f32, whichever is larger; ``devtime.bound_ms``).
   The backward is run twice at each shape and must repeat bit for bit;
   an empty kernel launched the same way gives the launch floor.
3. adapter — ``composite_fused`` forward + backward from the renderer's
   tensors at the main shape: host ms per call and device launches per
   call from a torch.profiler trace (at most 4: K1, K2 and two ops on
   [R] for the per-ray delta).
4. reference — one InitPhase step of a tiny configuration on the CPU
   (plain versions) and on the GPU (kernels) from the same weights and
   rays: every loss term must agree.
5. init — the main path: ``LevelSfM.train`` two-view initialization of
   the synthetic scene at the full width of ``configs/levels2fm.yaml``
   (hash 16 levels x 2 features x 2^19 with bf16 reads, SDF MLP
   [.,64,16], radiance MLP [.,64,64,3], 8192 rays, 128 samples
   compacted to 32, occupancy 64^3, 20 march steps) on 128x128 images,
   with the step count cut to ``INIT_STEPS``. Launch counts are zeroed
   just before and read just after; losses must be finite and the rgb
   loss must fall.

The last lines of stdout are the card's name and power limit, the
kernels' JSON line and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import concurrent.futures
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

FULL_WIDTH_ARGS = [
    "--yaml=" + os.path.join(REPO, "configs", "synthetic.yaml"),
    # configs/levels2fm.yaml widths, which configs/synthetic.yaml cuts down
    "--SDF.VolSDF.iters_max_st=20",
    "--SDF.VolSDF.sample_intvs=128",
    "--SDF.Hash_config.compute_dtype=bfloat16",
    "--Renderer.rand_rays=8192",
    "--data.image_size=[128,128]",
]
# the config's optim.init.max_iter of 500, cut so the run fits the time limit
INIT_STEPS = 100

TINY_ARGS = [
    "--yaml=" + os.path.join(REPO, "configs", "synthetic.yaml"),
    "--data.image_size=[16,16]", "--data.n_views=2", "--data.n_points=64",
    "--SDF.Hash_config.n_levels=4", "--SDF.Hash_config.log2_hashmap_size=13",
    "--SDF.arch.layers=[null,16,8]", "--RadF.arch.layers=[null,16,16,3]",
    "--SDF.VolSDF.sample_intvs=16", "--SDF.VolSDF.iters_max_st=10",
    "--Renderer.rand_rays=512", "--Renderer.compact_samples=8",
    "--Renderer.occ_res=16", "--optim.init.max_iter=1",
]


def log(*a):
    print(*a, flush=True)


# --------------------------------------------------------------------------- build

def phase_build():
    from level_s2fm_tpu_torch import kernels
    from level_s2fm_tpu_torch.cpp import minigeom
    sources = sorted(f[:-3] for f in os.listdir(kernels.CSRC) if f.endswith(".cu"))
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(len(sources) + 1) as ex:
        futs = {name: ex.submit(kernels.build, name) for name in sources}
        futs["minigeom"] = ex.submit(minigeom.build)
        built = {name: f.result() for name, f in futs.items()}
    for name in sources:
        kernels.load(name)
        log(f"[build] {name}: {built[name]}")
        for line in kernels.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    minigeom.load()
    log(f"[build] minigeom: {built['minigeom']}")
    log(f"[build] {time.time() - t0:.1f} s")


# --------------------------------------------------------------------------- kernels

#: composite shapes held against the plain versions: the main path's
#: (R = 2 x 2048 rays per call, K = 32), two cameras' worth, a ragged
#: tile, the full K = 128, the chunked instance (K > 128) and a size
#: (~70 MB of inputs) beyond the 50 MB L2
COMPOSITE_SHAPES = [(4096, 32), (8192, 32), (1000, 32), (257, 128), (300, 257),
                    (65536, 32)]


def phase_kernels(main_shape):
    """K1/K2 against their plain versions, timed; returns per-kernel records."""
    import torch
    from level_s2fm_tpu_torch import devtime
    from level_s2fm_tpu_torch.rendering import composite_bench
    from level_s2fm_tpu_torch.rendering import fused_composite as fc
    dev = torch.device("cuda")
    atol, rtol_ab = 2e-4, 1e-4
    err = {"fwd": 0.0, "bwd": 0.0}
    for R, K in COMPOSITE_SHAPES:
        args, grads = composite_bench.composite_inputs(R, K, R + K, dev)
        out_r = fc._forward_ref(*args)
        bwd_r = fc._backward_ref(tuple(args), tuple(grads))
        out_k = fc.forward_cuda(*args)
        bwd_k = fc.backward_cuda(*args, *grads)
        again = fc.backward_cuda(*args, *grads)
        torch.cuda.synchronize()
        e_f = max(float((x - y).abs().max()) for x, y in zip(out_k, out_r))
        e_b = max(float((x - y).abs().max()) for x, y in zip(bwd_k[:5], bwd_r[:5]))
        e_ab = max(float((x - y).abs() / y.abs().clamp_min(1e-30))
                   for x, y in zip(bwd_k[5:], bwd_r[5:]))
        same = all(torch.equal(x, y) for x, y in zip(bwd_k, again))
        log(f"[kernels] R={R} K={K}: fwd max_abs_err={e_f:.3e} "
            f"bwd max_abs_err={e_b:.3e} d_alpha/d_beta rel_err={e_ab:.3e} "
            f"bwd bitwise repeatable={same}")
        assert e_f <= atol and e_b <= atol, (R, K, e_f, e_b)
        assert e_ab <= rtol_ab, (R, K, e_ab)
        assert same, (R, K)
        err["fwd"] = max(err["fwd"], e_f)
        err["bwd"] = max(err["bwd"], e_b)
        del out_r, bwd_r, out_k, bwd_k, again

    floor_ms, floor_host = devtime.time_ms(fc.empty_cuda)
    log(f"[kernels] empty kernel through the same ctypes path: device "
        f"{floor_ms * 1e3:.3f} us per launch back to back, host "
        f"{floor_host * 1e3:.1f} us per call")
    timing = {}
    for R, K in (main_shape, (65536, 32)):
        args, grads = composite_bench.composite_inputs(R, K, 7, dev)
        fb, bb = composite_bench.composite_bytes(R, K)
        fwd_b, bwd_b = devtime.bound_ms(fb, 30 * R * K), devtime.bound_ms(bb, 75 * R * K)
        tf, hf = devtime.time_ms(lambda: fc.forward_cuda(*args))
        tb, hb = devtime.time_ms(lambda: fc.backward_cuda(*args, *grads))
        timing[(R, K)] = (tf, hf, tb, hb)
        log(f"[kernels] R={R} K={K}: fwd {tf * 1e3:.3f} us "
            f"(bound {fwd_b[0] * 1e3:.3f} us {fwd_b[1]}, "
            f"{fwd_b[0] / tf:.1%} of bound; host {hf * 1e3:.1f} us/call), "
            f"bwd {tb * 1e3:.3f} us (bound {bwd_b[0] * 1e3:.3f} us {bwd_b[1]}, "
            f"{bwd_b[0] / tb:.1%} of bound; host {hb * 1e3:.1f} us/call)")
        if (R, K) == tuple(main_shape):
            t_plain = {
                "fwd": devtime.time_ms(lambda: fc._forward_ref(*args))[0],
                "bwd": devtime.time_ms(lambda: fc._backward_ref(tuple(args), tuple(grads)))[0]}
            main_bounds = (fwd_b, bwd_b)
        del args, grads
        torch.cuda.empty_cache()

    R, K = main_shape
    kept = timing[(R, K)]
    (fwd_b, fwd_by), (bwd_b, bwd_by) = main_bounds
    src = "level_s2fm_tpu_torch/csrc/composite.cu"
    ref = "level_s2fm_tpu/rendering/pallas_composite.py"
    recs = [
        {"name": "laplace_composite_fwd", "route": "cuda", "source": src,
         "replaces": f"{ref}:118 (_fwd_kernel, launched at :209)",
         "max_abs_err": err["fwd"], "ms": kept[0], "plain_ms": t_plain["fwd"],
         "bound_ms": fwd_b, "bound_by": fwd_by, "library_ms": None},
        {"name": "laplace_composite_bwd", "route": "cuda", "source": src,
         "replaces": f"{ref}:135 (_bwd_kernel, launched at :267)",
         "max_abs_err": err["bwd"], "ms": kept[2], "plain_ms": t_plain["bwd"],
         "bound_ms": bwd_b, "bound_by": bwd_by, "library_ms": None},
    ]
    log(f"[kernels] main path R={R} K={K} (no single PyTorch call computes "
        f"this function: library_ms is null): device ms fwd {kept[0]:.6f} "
        f"bwd {kept[2]:.6f}, "
        f"plain ms " + json.dumps(t_plain)
        + f", empty-kernel floor {floor_ms:.6f} ms")
    return recs


def phase_adapter(B=2, HW=2048, K=32):
    """``composite_fused`` forward + autograd backward from the renderer's
    tensors at the main path's shape (one ``ray_chunk`` call: two cameras
    x 2048 rays, K = 32): host ms per call, and the device launches per
    call from a torch.profiler trace. The ray and the cotangents are
    slices of twice-wider tensors, as the renderer's chunking hands them;
    normal_mlp gets no cotangent, as in the init step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from level_s2fm_tpu_torch import devtime
    from level_s2fm_tpu_torch.rendering import composite_bench
    from level_s2fm_tpu_torch.rendering import fused_composite as fc
    dev = torch.device("cuda")
    args, _ = composite_bench.composite_inputs(B * HW, K, 11, dev)
    sdf, valid, _, rgb, depth, normal = (
        x.reshape(B, HW, *x.shape[1:]).detach() for x in args[:6])
    g = torch.Generator(device="cpu").manual_seed(12)
    ray = torch.randn(B, 2 * HW, 3, generator=g).to(dev)[:, :HW]
    bin_w = (0.01 + 0.02 * torch.rand(B, HW, generator=g)).to(dev)
    alpha = torch.tensor(20.0, device=dev, requires_grad=True)
    beta = torch.tensor(0.05, device=dev, requires_grad=True)
    for t in (sdf, rgb, normal):
        t.requires_grad_(True)
    cot_rgb = torch.randn(B, 2 * HW, 3, generator=g).to(dev)[:, :HW]
    cot_dep = torch.randn(B, 2 * HW, 1, generator=g).to(dev)[:, :HW]
    cot_op = torch.randn(B, 2 * HW, 1, generator=g).to(dev)[:, :HW]

    def step():
        o = fc.composite_fused(ray, rgb, sdf, valid, bin_w, depth, normal,
                               alpha, beta)
        return torch.autograd.grad((o[0], o[1], o[3]), (sdf, rgb, normal, alpha, beta),
                                   (cot_rgb, cot_dep, cot_op))

    got = step()
    res = (sdf, valid, torch.linalg.norm(ray, dim=-1) * bin_w, rgb, depth,
           normal, alpha, beta)
    want = fc._backward_ref(tuple(x.detach() for x in res),
                            (cot_rgb, cot_dep[..., 0], None, cot_op[..., 0]))
    want = (want[0], want[2], want[4], want[5], want[6])
    err = max(float((a - b).abs().max()) for a, b in zip(got[:3], want[:3]))
    err_ab = max(float((a - b).abs() / b.abs()) for a, b in zip(got[3:], want[3:]))
    assert err <= 2e-4 and err_ab <= 1e-4, (err, err_ab)
    for _ in range(5):
        step()
    n = 200
    host_ms = devtime.host_ms(step, n)
    n_prof = 10
    before = dict(fc.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            step()
        torch.cuda.synchronize()
    names = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            names[e.name[:70]] = names.get(e.name[:70], 0) + 1
    per_call = sum(names.values()) / n_prof
    kernels = {k: v / n_prof for k, v in names.items()}
    log(f"[adapter] composite_fused fwd+bwd B={B} HW={HW} K={K}, strided "
        f"cotangents: max_abs_err {err:.3e}, d_alpha/d_beta rel_err {err_ab:.3e} "
        f"against the plain backward; host {host_ms:.4f} ms per call "
        f"(median of {n}), device "
        f"launches per call {per_call:g} (torch.profiler): " + json.dumps(kernels))
    assert fc.LAUNCHES["fwd"] - before["fwd"] == n_prof
    assert fc.LAUNCHES["bwd"] - before["bwd"] == n_prof
    assert per_call <= 4, kernels   # K1 + K2 + at most two ops on [R]


# --------------------------------------------------------------------------- reference

def phase_reference():
    """One InitPhase step of a tiny config on CPU (plain) and GPU (kernels)."""
    import torch
    from level_s2fm_tpu_torch.config import build_options
    from level_s2fm_tpu_torch.sfm import bundle
    from level_s2fm_tpu_torch.sfm.initialization import Initializer
    from level_s2fm_tpu_torch.sfm.pipeline import LevelSfM
    from level_s2fm_tpu_torch.train import build_var
    from level_s2fm_tpu_torch.rendering import fused_composite as fc

    opt = build_options(TINY_ARGS)
    var = build_var(opt)
    losses = {}
    params0 = None
    launches = dict(fc.LAUNCHES)
    for dev in ("cpu", "cuda"):
        m = LevelSfM(opt, seed=0, device=dev)
        if params0 is None:                 # the step updates in place
            params0 = _tree_to(m.params, "cpu")
        m.params = _tree_to(params0, dev)
        m.load_data(var)
        init = Initializer(opt, m.cfgs, m.camera_set, m.point_set,
                           _init_var(var), device=dev)
        state = init.phase.init_state(m.params)
        batch = dict(init.batch)
        batch["occ"] = bundle.maybe_build_occ(opt, m.cfgs, state["params"])
        HW = m.cfgs.H * m.cfgs.W
        met = init.phase.step(state, batch, torch.Generator().manual_seed(0),
                              rays_idx=torch.arange(HW))
        losses[dev] = {k: float(v) for k, v in met.items()}
    assert fc.LAUNCHES["fwd"] > launches["fwd"] and fc.LAUNCHES["bwd"] > launches["bwd"]
    worst = 0.0
    for k, v in losses["cpu"].items():
        g = losses["cuda"][k]
        rel = abs(g - v) / max(abs(v), 1e-6)
        worst = max(worst, rel)
        assert rel < 1e-3, (k, v, g)
    log(f"[reference] tiny InitPhase step, CPU plain vs GPU kernels: worst loss "
        f"rel diff {worst:.2e} (bar 1e-3): "
        + json.dumps({k: round(v, 6) for k, v in losses["cuda"].items()}))


def _tree_to(tree, dev):
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(dev).clone()
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return [_tree_to(v, dev) for v in tree]


def _init_var(var):
    return {"indx_init": [0, 1],
            "imgs_init": [var["images"][0], var["images"][1]],
            "kypts_init": [var["kypts"][0], var["kypts"][1]],
            "intrs_init": [var["intrs"][0], var["intrs"][1]],
            "mchs_init": [var["matches"][0], var["matches"][1]],
            "inliers_init": [var["masks"][0], var["masks"][1]],
            "poses_gt": var["poses_gt"]}


# --------------------------------------------------------------------------- init

def phase_init():
    """The main path: two-view init at full width. Returns launch counts."""
    import numpy as np
    import torch
    from level_s2fm_tpu_torch.config import build_options
    from level_s2fm_tpu_torch.rendering import fused_composite as fc
    from level_s2fm_tpu_torch.sfm.pipeline import LevelSfM
    from level_s2fm_tpu_torch.train import build_var

    steps = INIT_STEPS
    opt = build_options(FULL_WIDTH_ARGS + [f"--optim.init.max_iter={steps}"])
    model = LevelSfM(opt, seed=int(opt.seed), device="cuda")
    model.load_data(build_var(opt))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fc.reset_launches()
    t0 = time.perf_counter()
    model.train(max_views=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fc.LAUNCHES)

    init = model.initializer
    m = init._metrics
    n = len(m["all"])
    assert n == steps, n
    for k, v in m.items():
        assert np.all(np.isfinite(v)), k
    assert float(np.sum(m["nonfinite"])) == 0.0
    assert m["rgb"][-1] < m["rgb"][0], (m["rgb"][0], m["rgb"][-1])
    assert launches["fwd"] >= steps and launches["bwd"] > 0, launches
    n_tri, n_kp = init.tri_ratio
    rot_err, t_err, _ = init.pose_errors
    assert n_tri > 0 and math.isfinite(rot_err) and math.isfinite(t_err)

    # steady-state step time: a few more steps on the trained state
    # (not part of the launch count above)
    from level_s2fm_tpu_torch.sfm import bundle
    state = init.phase.init_state(model.params)
    batch = dict(init.batch)
    batch["occ"] = bundle.maybe_build_occ(opt, model.cfgs, state["params"])
    gen = torch.Generator().manual_seed(1)
    init.phase.step(state, batch, gen)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    k_steps = 10
    for _ in range(k_steps):
        init.phase.step(state, batch, gen)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t1) / k_steps * 1e3

    prof = _profile_steps(init.phase, state, batch, gen)
    prof["device_busy_share_of_steady_step"] = (
        prof["device_busy_ms_per_step"] / step_ms)
    split = _layer_split(model, state, batch)

    summary = {
        "steps": n, "init_wall_s": wall, "ms_per_step_in_init": wall / n * 1e3,
        "ms_per_step_steady": step_ms, "layer_ms": split, "profile": prof,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches": launches,
        "launches_per_step": {k: v / n for k, v in launches.items()},
        "loss_first": {k: float(v[0]) for k, v in m.items()},
        "loss_last": {k: float(v[-1]) for k, v in m.items()},
        "triangulated": [n_tri, n_kp], "rot_error_deg": rot_err,
        "t_error_deg": t_err,
    }
    log("[init] " + json.dumps(summary))
    return launches


def _layer_split(model, state, batch, n=5):
    """Wall ms (synchronised) of the init step's main parts, each run
    alone on the steady state: the 8192-ray march, its differentiable
    re-eval, the compacted render (forward + backward, both composite
    kernels), the keypoint sphere tracing, the guarded Adam update, and
    one occupancy rebuild."""
    import torch
    from level_s2fm_tpu_torch.fields import sdf as sdf_mod
    from level_s2fm_tpu_torch.geometry import transforms as T
    from level_s2fm_tpu_torch.rendering import renderer as ren_mod
    from level_s2fm_tpu_torch.sfm import bundle
    from level_s2fm_tpu_torch.sfm.phases import guarded_update
    cfgs, params, opt = model.cfgs, state["params"], state["opt"]
    leaves = opt.leaves
    HW = cfgs.H * cfgs.W
    idx = torch.randperm(HW, generator=torch.Generator().manual_seed(2))
    idx = idx[:min(cfgs.rand_rays // 2, HW)].to(model.device)
    c, r = T.get_center_and_ray(batch["poses"], batch["intr"], batch["grid"][idx])
    c1, r1 = c.reshape(1, -1, 3), r.reshape(1, -1, 3)
    m = sdf_mod.sphere_march(params["sdf"], cfgs.sdf, c1, r1)

    def grad_of(loss):
        torch.autograd.grad(loss, leaves, allow_unused=True)

    def reeval():
        d, s_last, _, _ = sdf_mod.sphere_reeval(params["sdf"], cfgs.sdf, m, c1, r1)
        grad_of(d.sum() + s_last.sum())

    def render():
        out = ren_mod.render(params["sdf"], cfgs.sdf, params["rad"], cfgs.rad,
                             cfgs.ren, c, r, occ_grid=batch["occ"])
        grad_of(out["rgb"].sum() + out["depth_mlp"].sum()
                + out["normals"].norm(dim=-1).sum())

    def trace_kp():
        tr = sdf_mod.sphere_tracing(params["sdf"], cfgs.sdf, batch["center_k"],
                                    batch["ray_k"], gen=torch.Generator())
        grad_of(tr.pts_surface.sum() + tr.sdf_surf.sum())

    zeros = [torch.zeros_like(p) for p in leaves]
    parts = {
        "march": lambda: sdf_mod.sphere_march(params["sdf"], cfgs.sdf, c1, r1),
        "march_reeval_fwd_bwd": reeval,
        "render_fwd_bwd": render,
        "keypoint_tracing_fwd_bwd": trace_kp,
        "guarded_adam": lambda: guarded_update(opt, zeros),
        "occupancy_rebuild": lambda: bundle.maybe_build_occ(model.opt, cfgs, params),
    }
    out = {}
    for name, fn in parts.items():
        fn()
        ts = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        out[name] = sorted(ts)[n // 2]
    return out


def _profile_steps(phase, state, batch, gen, n=3):
    """Device busy time and the top ops by device time over ``n`` steady
    steps (torch.profiler / CUPTI). Busy time is the union of the
    intervals of the device's own events (kernels, copies, fills). An op's
    device time is the self device time of a host-side op: each kernel
    counts once, under the op that launched it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_self(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            phase.step(state, batch, gen)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    assert spans, "the profiler saw no device event"
    busy_us, kernel_us, reach = 0.0, 0.0, -math.inf
    for start, end in spans:
        kernel_us += end - start
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CPU and dev_self(e) > 0]
    top = sorted(ops, key=dev_self, reverse=True)[:15]
    return {"steps": n, "wall_ms_per_step_profiled": wall_us / n / 1e3,
            "device_busy_ms_per_step": busy_us / n / 1e3,
            "device_event_ms_per_step": kernel_us / n / 1e3,
            "ops_device_ms_per_step": sum(map(dev_self, ops)) / n / 1e3,
            "top_op_device_ms_per_step": {e.key[:60]: dev_self(e) / n / 1e3
                                          for e in top}}


# --------------------------------------------------------------------------- main

def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "level_s2fm_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(level_s2fm_tpu_torch/ not found beside this script)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    t_start = time.time()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    phase_build()
    # the main path's composite shape: 8192 rays over 2 cameras, ray_chunk
    # 2048 -> two calls of R = 2 x 2048 rays, K = compact_samples = 32
    recs = phase_kernels(main_shape=(4096, 32))
    phase_adapter()
    phase_reference()
    launches = phase_init()
    recs[0]["launches"] = launches["fwd"]
    recs[1]["launches"] = launches["bwd"]
    log(f"[done] {time.time() - t_start:.1f} s")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in recs]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
