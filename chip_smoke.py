#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port on one NVIDIA GPU.

    python3 chip_smoke.py

Imports nothing of JAX and nothing of the JAX package. Phases (any
failure raises and exits non-zero):

1. build — the CUDA kernels (``level_s2fm_tpu_torch/csrc/*.cu``, one nvcc
   per source, started together) and the host libraries minigeom and
   pngfilter (g++), from the sources in this checkout.
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
4. reference — one step each of InitPhase, GeoInitPhase, BAPhase
   ('sfm', and 'sfm_refine' on one camera, whose se3 gradient flows
   through K1/K2) and RefinePhase at a tiny configuration on the CPU
   (plain versions) and on the GPU (kernels), from the same state and
   the same injected draws: every loss term must agree to 1e-3 relative
   (of max(|value|, 1e-4)), the se3 gradient to 1e-3 of its largest
   entry.
5. init — the first main path: ``LevelSfM.train`` two-view
   initialization of the synthetic scene at the full width of
   ``configs/levels2fm.yaml`` (hash 16 levels x 2 features x 2^19 with
   bf16 reads, SDF MLP [.,64,16], radiance MLP [.,64,64,3], 8192 rays,
   128 samples compacted to 32, occupancy 64^3, 20 march steps, geoinit
   max_rays 2048) on 128x128 images, with the step count cut to
   ``INIT_STEPS``. Losses must be finite and the rgb loss must fall.
6. register — the second main path: the same model goes on to register
   views 3 and 4 (``sfm_mode: full``: PnP, geoinit, one single-camera
   sfm_refine BA, up to 5 local and 5 global BA cycles, refine). Depth
   is cut to the iteration counts of ``configs/synthetic.yaml`` (geoinit
   30 x 5 steps, BA 150, refine 100; the full config's 100 x 5, 1000,
   500). Every view must register and every loss stay finite. Per view
   it prints PnP inliers, the triangulation ratio, the pose errors and
   the wall s per stage; then, on copies of the final state, the steady
   ms per step and the device-busy share of each phase; then K1/K2 are
   held to their plain versions at every shape the run launched.
7. bands — the 3-view ``--sfm_mode=fast`` run at
   ``configs/synthetic.yaml`` as it stands, under
   ``torch.use_deterministic_algorithms`` so that its verdict repeats
   from run to run; each final value must be
   within 2x of the known-good values (reproj 0.315 px, rot 6.0 deg, t
   0.018), and the relative rotations within the E2E oracles (views 0-1
   < 5 deg, 0-2 < 8 deg).
8. prepared — the third main path, through the port's CLI entry
   (``train.main``) on a prepared scene: ``configs/synthhard_r5.yaml`` as
   it stands (data/synthhard/scan1 through the port's loaders: 200x200,
   SIFT matches, the widths of ``configs/levels2fm.yaml``, init 400,
   geoinit 60 x 5, BA 400) in ``--sfm_mode=fast``, as the JAX package's
   committed run. Five views with a checkpoint after each; each view's
   row is held to that run's row of the same step
   (``results/synthhard_r5_metrics.jsonl``): the same view, reproj < 1 px
   and within 2x, t_err and ate within 2x, the rotation within 2x from 5
   cameras up (the Procrustes fit of 3-4 near-collinear centres is
   ill-conditioned). Then a fresh engine resumes from ``model.ckpt``,
   must adopt the saved optimizer moments and registers the sixth view
   under the same bars; then ``--get_result --refine_again`` refines
   every camera (200 steps, K1/K2) and exports the results, each file
   checked (mesh > 1000 faces with median |SDF| at its vertices below a
   grid spacing, ``render_cam0.png`` finite, its PSNR printed). K1/K2 are
   held at every shape the phase launched. Prints the per-view stage
   times, the checkpoint save / restore ms and size, and the export ms.
9. options — phase init's configuration with the SDF / renderer options
   switched on (``OPTION_SWITCHES``: the dual radiance field, the
   adaptive VolSDF sampler with ``final_sample_intvs`` 64, the
   ``paired_dense`` key, and the exact ``reeval_compact`` /
   ``march_compact`` compactions), ``OPTION_STEPS`` init steps. Losses
   must be finite and the rgb loss must fall; prints the steady ms per
   step and the device-busy share beside phase init's, and one 8192-ray
   march with and without ``march_compact`` (ms each; the tracks must
   agree to 1e-5).
10. ablations — (a) the 3-view ``configs/synthetic.yaml`` run under
   ``--sfm_mode=fast --Ablate_config.tri_trad --Ablate_config.ba_trad``
   through ``train.main``: every view registers, > 30 points with
   median | |X| - 0.5 | < 0.1, and the final reproj / rotation /
   translation errors within 2x of the JAX package's values for the same
   command, taken over its rounding spread (``TRAD_SPREAD``, from
   ``trad_spread.py``); it renders nothing, so K1/K2 do not launch.
   (b) ``polish_trad_ba`` (``--cycles=2 --iters=1500``) on the six-view
   checkpoint phase prepared leaves: the mean reprojection error must
   fall and the ATE must not rise; prints each cycle's errors and wall
   time. (c) one ``tri_trad``-only run of the synthetic scene in
   ``full`` mode (DLT triangulation with the SDF post-fit, then
   sfm_refine, BA and refine), where K1/K2 launch.

Phase reference also holds one InitPhase step and one
``BAPhase('rad_init')`` step under ``OPTION_SWITCHES`` (tiny widths) to
the CPU's plain versions, and every shape K1/K2 launched in phases
options and ablations is held against the plain versions.

Each main path is driven with the launch counts set to 0 just before it
and read just after; K1 and K2 must have launched in each.

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
#: views of the synthetic scene the register phase brings in
REGISTER_VIEWS = 4
#: known-good final values of the 3-view fast run (the JAX package on the
#: CPU) and the factor a value may reach before the bands phase fails
BANDS = {"reproj_px": 0.315, "rot_err_deg": 6.0, "t_err": 0.018}
BANDS_FACTOR = 2.0

TINY_ARGS = [
    "--yaml=" + os.path.join(REPO, "configs", "synthetic.yaml"),
    "--data.image_size=[16,16]", "--data.n_views=2", "--data.n_points=64",
    "--SDF.Hash_config.n_levels=4", "--SDF.Hash_config.log2_hashmap_size=13",
    "--SDF.arch.layers=[null,16,8]", "--RadF.arch.layers=[null,16,16,3]",
    "--SDF.VolSDF.sample_intvs=16", "--SDF.VolSDF.iters_max_st=10",
    "--Renderer.rand_rays=512", "--Renderer.compact_samples=8",
    "--Renderer.occ_res=16", "--optim.init.max_iter=1",
]
#: a loss of the CPU-vs-GPU reference steps agrees to this, relative to
#: max(|value|, REF_FLOOR)
REF_RTOL, REF_FLOOR = 1e-3, 1e-4

#: the prepared scene: configs/synthhard_r5.yaml as it stands (32 views of
#: data/synthhard/scan1, SIFT matches, 200x200), in the fast mode of the
#: JAX package's committed run, whose per-view rows it is held to
PREPARED_ARGS = ["--yaml=" + os.path.join(REPO, "configs", "synthhard_r5.yaml"),
                 "--sfm_mode=fast"]
PREPARED_ROWS = os.path.join(REPO, "results", "synthhard_r5_metrics.jsonl")
#: views registered before the checkpoint, and after the resume
PREPARED_VIEWS, RESUMED_VIEWS = 5, 6
#: the refine over every camera before the export
REFINE_AGAIN_ITERS = 200
#: a row's reproj / t_err / ate may reach this factor of the JAX row's;
#: the Procrustes rotation too, from PREPARED_ROT_MIN_CAMS cameras up
PREPARED_FACTOR, PREPARED_ROT_MIN_CAMS = 2.0, 5

#: the SDF / renderer options of the options phase and of the reference
#: phase's option steps
OPTION_SWITCHES = ["--Ablate_config.dual_field", "--SDF.VolSDF.volsdf_sampling",
                   "--SDF.Hash_config.paired_dense",
                   "--SDF.VolSDF.reeval_compact=0.5",
                   "--SDF.VolSDF.march_compact=0.25"]
#: init steps of the options phase (phase init's INIT_STEPS, halved)
OPTION_STEPS = 50
#: the ablations phase's trad run: configs/synthetic.yaml as it stands
TRAD_ARGS = ["--yaml=" + os.path.join(REPO, "configs", "synthetic.yaml"),
             "--sfm_mode=fast", "--Ablate_config.tri_trad",
             "--Ablate_config.ba_trad"]
#: the JAX package's final values of the same run, on the CPU:
#:   python train.py --cpu --yaml=configs/synthetic.yaml --sfm_mode=fast \
#:       --Ablate_config.tri_trad --Ablate_config.ba_trad --max_views=3
#: (reproj_px: its last global trad BA's printed value; the errors:
#: eval_poses after it), and the median and maximum of the same run over
#: its rounding spread (``python trad_spread.py --runs=16``: the DLT points
#: scaled by 1 + 1e-7 n in runs 1-15). The trad BA ends where Adam's step
#: meets rounding-level gradients, so these values move with rounding:
#: the 3-camera rotation error spreads 0.028-0.770 deg. A port value may
#: reach TRAD_FACTOR x the spread's maximum.
TRAD_KNOWN = {"reproj_px": 0.0398, "rot_err_deg": 0.090923972427845,
              "t_err": 9.8555872682482e-05}
TRAD_SPREAD = {"median": {"reproj_px": 0.03955, "rot_err_deg": 0.08582666888833046,
                          "t_err": 6.770097752450965e-05},
               "max": {"reproj_px": 0.046, "rot_err_deg": 0.7703208923339844,
                       "t_err": 0.0003573574067559093}}
TRAD_FACTOR = 2.0
#: the pose polish of the prepared run, as results/synthhard_r5.md ran it
POLISH_ARGS = ["--cycles=2", "--iters=1500"]
#: DLT triangulation under the neural BA and refine: configs/synthetic.yaml
#: in full mode
TRI_TRAD_ARGS = ["--yaml=" + os.path.join(REPO, "configs", "synthetic.yaml"),
                 "--Ablate_config.tri_trad"]


def log(*a):
    print(*a, flush=True)


def _out_dir(phase):
    """A fresh output directory of a phase (``output/`` is git-ignored)."""
    import shutil
    path = os.path.join(REPO, "output", "chip_smoke", phase)
    shutil.rmtree(path, ignore_errors=True)
    return path


# --------------------------------------------------------------------------- build

def phase_build():
    from level_s2fm_tpu_torch import kernels
    from level_s2fm_tpu_torch.cpp import minigeom
    from level_s2fm_tpu_torch.utils import png
    sources = sorted(f[:-3] for f in os.listdir(kernels.CSRC) if f.endswith(".cu"))
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(len(sources) + 2) as ex:
        futs = {name: ex.submit(kernels.build, name) for name in sources}
        futs["minigeom"] = ex.submit(minigeom.build)
        futs["pngfilter"] = ex.submit(png.build)
        built = {name: f.result() for name, f in futs.items()}
    for name in sources:
        kernels.load(name)
        log(f"[build] {name}: {built[name]}")
        for line in kernels.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    minigeom.load()
    log(f"[build] minigeom: {built['minigeom']}")
    log(f"[build] pngfilter: {built['pngfilter']}")
    log(f"[build] {time.time() - t0:.1f} s")


# --------------------------------------------------------------------------- kernels

#: composite shapes held against the plain versions: the main path's
#: (R = 2 x 2048 rays per call, K = 32), two cameras' worth, a ragged
#: tile, the full K = 128, the chunked instance (K > 128) and a size
#: (~70 MB of inputs) beyond the 50 MB L2
COMPOSITE_SHAPES = [(4096, 32), (8192, 32), (1000, 32), (257, 128), (300, 257),
                    (65536, 32)]


def hold_composite(shapes, dev, tag="kernels"):
    """K1/K2 against their plain versions at each (R, K) of ``shapes``
    (atol 2e-4, d_alpha/d_beta 1e-4 relative); the backward must repeat
    bit for bit. Returns the largest errors {"fwd", "bwd"}."""
    import torch
    from level_s2fm_tpu_torch.rendering import composite_bench
    from level_s2fm_tpu_torch.rendering import fused_composite as fc
    atol, rtol_ab = 2e-4, 1e-4
    err = {"fwd": 0.0, "bwd": 0.0}
    for R, K in shapes:
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
        log(f"[{tag}] R={R} K={K}: fwd max_abs_err={e_f:.3e} "
            f"bwd max_abs_err={e_b:.3e} d_alpha/d_beta rel_err={e_ab:.3e} "
            f"bwd bitwise repeatable={same}")
        assert e_f <= atol and e_b <= atol, (R, K, e_f, e_b)
        assert e_ab <= rtol_ab, (R, K, e_ab)
        assert same, (R, K)
        err["fwd"] = max(err["fwd"], e_f)
        err["bwd"] = max(err["bwd"], e_b)
        del out_r, bwd_r, out_k, bwd_k, again
    return err


def phase_kernels(main_shape):
    """K1/K2 against their plain versions, timed; returns per-kernel records."""
    import torch
    from level_s2fm_tpu_torch import devtime
    from level_s2fm_tpu_torch.rendering import composite_bench
    from level_s2fm_tpu_torch.rendering import fused_composite as fc
    dev = torch.device("cuda")
    err = hold_composite(COMPOSITE_SHAPES, dev)

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
    _compare_losses("InitPhase", losses["cpu"], losses["cuda"])
    _reference_registration()
    _reference_options()


def _compare_losses(name, cpu, gpu):
    worst = 0.0
    for k, v in cpu.items():
        rel = abs(gpu[k] - v) / max(abs(v), REF_FLOOR)
        worst = max(worst, rel)
        assert rel <= REF_RTOL, (name, k, v, gpu[k])
    log(f"[reference] tiny {name} step, CPU plain vs GPU kernels: worst loss "
        f"rel diff {worst:.2e} (bar {REF_RTOL:g} of max(|v|, {REF_FLOOR:g})): "
        + json.dumps({k: round(v, 6) for k, v in gpu.items()}))


def _reference_registration():
    """One step each of GeoInitPhase, BAPhase('sfm') over three views,
    BAPhase('sfm_refine') on view 2 alone (its se3 gradient flows through
    K1/K2) and RefinePhase, on the CPU (plain versions) and on the GPU
    (kernels): the same tiny two-view init (trained on the CPU), the
    same PnP registration of view 2 and the same draws on both."""
    import torch
    from level_s2fm_tpu_torch.config import build_options
    from level_s2fm_tpu_torch.rendering import fused_composite as fc
    from level_s2fm_tpu_torch.sfm import bundle, entities, registration
    from level_s2fm_tpu_torch.sfm.phases import GeoInitPhase
    from level_s2fm_tpu_torch.sfm.pipeline import LevelSfM
    from level_s2fm_tpu_torch.train import build_var

    opt = build_options(TINY_ARGS + ["--data.n_views=3", "--optim.init.max_iter=3"])
    m = LevelSfM(opt, seed=0, device="cpu")
    m.load_data(build_var(opt))
    m.train(max_views=2, verbose=False)
    reg = registration.Registration(opt, m.cfgs, m.camera_set)
    cam = m._make_camera(2)
    assert reg.pnp(m.params, cam, m.point_set, if_nbv=True)[0]
    m.camera_set.add(cam)
    segs, host = reg.geo_init_batch(cam, m.point_set, verbose=False)
    g = torch.Generator().manual_seed(5)
    P, E = host["valid"].shape[0], host["pts_exists"].shape[0]
    n_pick = min(4096, 2 * P)
    draws = {"factor_rand": torch.rand(2 * P, generator=g),
             "pick": torch.randperm(2 * P, generator=g)[:n_pick],
             "pick2": torch.randperm(n_pick * m.cfgs.sdf.iters_max + 2 * P,
                                     generator=g)[:4096]}
    exist_pick = torch.randperm(E, generator=g)[:min(4096, E)]
    HW = m.cfgs.H * m.cfgs.W
    rays = torch.randperm(HW, generator=g)
    og = opt.optim.geoinit
    res = {}
    for dev in ("cpu", "cuda"):
        r = res[dev] = {}
        ph = GeoInitPhase(m.cfgs, dict(opt.loss_weight.geoinit),
                          n_segments=entities.pad_to_bucket(
                              len(segs), buckets=(2, 4, 8, 16, 32, 64)),
                          lr_sdf=float(og.lr_sdf), lr_sdf_end=float(og.lr_sdf_end),
                          max_iter=int(og.max_iter) * 5)
        st = ph.init_state(_tree_to(m.params, dev))
        batch = {k: torch.as_tensor(v).to(dev) for k, v in host.items()}
        r["GeoInitPhase"] = ph.step(st, batch, None, draws=draws,
                                    exist_pick=exist_pick)
        b = bundle.Bundler(opt, m.cfgs, m.camera_set, m.point_set,
                           cam_pick_ids=[2, 0, 1], mode="sfm", device=dev)
        st = b.phase.init_state(_ba_params(m, b, dev), b.xyzs0.clone())
        r["BAPhase sfm"] = b.phase.step(st, b.batch, None)
        b = bundle.Bundler(opt, m.cfgs, m.camera_set, m.point_set,
                           cam_pick_ids=[2], mode="sfm_refine", device=dev)
        params = _ba_params(m, b, dev)
        st = b.phase.init_state(params, b.xyzs0.clone())
        batch = dict(b.batch)
        batch["occ"] = bundle.maybe_build_occ(opt, m.cfgs, params)
        n_rays = min(m.cfgs.rand_rays, HW)
        before = dict(fc.LAUNCHES)
        loss, met, _ = b.phase._losses(params, st["xyzs"], batch, None,
                                       rays_idx=rays[:n_rays], trace_cam=0)
        total = b.phase.objective(loss, met)
        grad = torch.autograd.grad(total, (params["se3_r"], params["se3_t"]))
        r["se3_grad"] = torch.cat(grad, 1).cpu()
        r["BAPhase sfm_refine"] = b.phase.step(st, batch, None,
                                               rays_idx=rays[:n_rays], trace_cam=0)
        if dev == "cuda":
            assert fc.LAUNCHES["bwd"] - before["bwd"] >= 2, fc.LAUNCHES
        rf = bundle.Refiner(opt, m.cfgs, m.camera_set, m.point_set, device=dev)
        st = rf.phase.init_state(_tree_to(m.params, dev))
        batch = dict(rf.batch)
        batch["occ"] = bundle.maybe_build_occ(opt, m.cfgs, st["params"])
        n_rays = min(m.cfgs.rand_rays // batch["images"].shape[0], HW)
        r["RefinePhase"] = rf.phase.step(st, batch, None, rays_idx=rays[:n_rays],
                                         trace_cam=1)
    for name in ("GeoInitPhase", "BAPhase sfm", "BAPhase sfm_refine", "RefinePhase"):
        _compare_losses(name, {k: float(v) for k, v in res["cpu"][name].items()},
                        {k: float(v) for k, v in res["cuda"][name].items()})
    gc, gg = res["cpu"]["se3_grad"], res["cuda"]["se3_grad"]
    err = float((gg - gc).abs().max() / gc.abs().max())
    log(f"[reference] sfm_refine se3 gradient through K1/K2, CPU vs GPU: max "
        f"diff {err:.2e} of its largest entry (bar {REF_RTOL:g}); cpu "
        f"{gc.numpy().round(5).tolist()} gpu {gg.numpy().round(5).tolist()}")
    assert float(gc.abs().max()) > 0 and err <= REF_RTOL, err


def _reference_options():
    """One InitPhase step and one BAPhase('rad_init') step (views 0 and 1,
    poses frozen) under OPTION_SWITCHES at the tiny widths, on the CPU
    (plain versions) and on the GPU (kernels), from the same state and
    the same draws; the rad_init step's poses must stay bit for bit."""
    import torch
    from level_s2fm_tpu_torch.config import build_options
    from level_s2fm_tpu_torch.rendering import fused_composite as fc
    from level_s2fm_tpu_torch.sfm import bundle
    from level_s2fm_tpu_torch.sfm.initialization import Initializer
    from level_s2fm_tpu_torch.sfm.pipeline import LevelSfM
    from level_s2fm_tpu_torch.train import build_var

    opt = build_options(TINY_ARGS + OPTION_SWITCHES + ["--optim.init.max_iter=3"])
    var = build_var(opt)
    m = LevelSfM(opt, seed=0, device="cpu")
    m.load_data(var)
    params0 = _tree_to(m.params, "cpu")
    m.train(max_views=2, verbose=False)
    HW = m.cfgs.H * m.cfgs.W
    rays = torch.randperm(HW, generator=torch.Generator().manual_seed(6))
    res = {}
    for dev in ("cpu", "cuda"):
        r = res[dev] = {}
        md = LevelSfM(opt, seed=0, device=dev)
        md.load_data(var)
        init = Initializer(opt, md.cfgs, md.camera_set, md.point_set,
                           _init_var(var), device=dev)
        st = init.phase.init_state(_tree_to(params0, dev))
        batch = dict(init.batch)
        batch["occ"] = bundle.maybe_build_occ(opt, md.cfgs, st["params"])
        before = dict(fc.LAUNCHES)
        r["InitPhase (options)"] = init.phase.step(
            st, batch, torch.Generator().manual_seed(0), rays_idx=torch.arange(HW))
        b = bundle.Bundler(opt, m.cfgs, m.camera_set, m.point_set,
                           cam_pick_ids=[0, 1], mode="rad_init", device=dev)
        params = _ba_params(m, b, dev)
        se3 = (params["se3_r"].clone(), params["se3_t"].clone())
        st = b.phase.init_state(params, b.xyzs0.clone())
        batch = dict(b.batch)
        batch["occ"] = bundle.maybe_build_occ(opt, m.cfgs, params)
        n_rays = min(m.cfgs.rand_rays // batch["images"].shape[0], HW)
        r["BAPhase rad_init (options)"] = b.phase.step(
            st, batch, None, rays_idx=rays[:n_rays], trace_cam=1)
        assert torch.equal(params["se3_r"], se3[0]) and torch.equal(params["se3_t"], se3[1])
        if dev == "cuda":
            assert fc.LAUNCHES["fwd"] - before["fwd"] >= 2, fc.LAUNCHES
            assert fc.LAUNCHES["bwd"] - before["bwd"] >= 2, fc.LAUNCHES
    for name in res["cpu"]:
        _compare_losses(name, {k: float(v) for k, v in res["cpu"][name].items()},
                        {k: float(v) for k, v in res["cuda"][name].items()})


def _ba_params(m, b, dev):
    import torch
    se3 = m.camera_set.all_se3(b.padded_ids)
    return {"sdf": _tree_to(m.params["sdf"], dev), "rad": _tree_to(m.params["rad"], dev),
            "se3_r": torch.as_tensor(se3[:, :3]).to(dev),
            "se3_t": torch.as_tensor(se3[:, 3:]).to(dev)}


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
    """The first main path: two-view init at full width. Returns (model,
    launch counts). Profiling runs on a copy of the parameters, so the
    model goes on to the register phase as the init left it."""
    import numpy as np
    import torch
    from level_s2fm_tpu_torch.config import build_options
    from level_s2fm_tpu_torch.rendering import fused_composite as fc
    from level_s2fm_tpu_torch.sfm.pipeline import LevelSfM
    from level_s2fm_tpu_torch.train import build_var

    steps = INIT_STEPS
    opt = build_options(FULL_WIDTH_ARGS + [f"--optim.init.max_iter={steps}",
                                           "--output_path=" + _out_dir("init")])
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

    # steady-state step time: a few more steps on a copy of the trained
    # state (not part of the launch count above)
    from level_s2fm_tpu_torch.sfm import bundle
    state = init.phase.init_state(_tree_to(model.params, "cuda"))
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
    return model, launches, summary


# --------------------------------------------------------------------------- register

def phase_register(model):
    """The second main path: the init phase's model registers views 3 and
    4 at full width. Returns (launch counts, launch shapes)."""
    import numpy as np
    import torch
    from level_s2fm_tpu_torch.rendering import fused_composite as fc

    probes, per_stage = {}, {}
    last = {"fwd": 0, "bwd": 0}

    def hook(stage, obj):
        """Attribute the launches since the last stage to this one and
        keep the stage's objects for the profiles below."""
        now = dict(fc.LAUNCHES)
        metrics = getattr(obj, "metrics", None) or {}
        for k, v in metrics.items():
            assert np.all(np.isfinite(v)), (stage, k, v)
        rec = per_stage.setdefault(stage, {"calls": 0, "steps": 0, "fwd": 0, "bwd": 0})
        rec["calls"] += 1
        rec["steps"] += len(metrics.get("all", ()))
        for k in ("fwd", "bwd"):
            rec[k] += now[k] - last[k]
        last.update(now)
        if hasattr(obj, "batch"):       # geoinit ran (a source view shared matches)
            probes[stage] = obj

    model.stage_hook = hook
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fc.reset_launches()
    t0 = time.perf_counter()
    ok = model.train(max_views=REGISTER_VIEWS, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fc.LAUNCHES)
    shapes = {k: dict(v) for k, v in fc.SHAPES.items()}
    model.stage_hook = None
    assert ok, "a view failed to register"
    assert len(model.camera_set) == REGISTER_VIEWS, model.camera_set.cam_ids
    assert not model.skipped_views, model.skipped_views
    for row in model.view_log:
        for k in ("reproj_px", "rot_err_deg", "t_err", "ate"):
            assert math.isfinite(row[k]), (row["view"], k, row[k])
        log("[register] view " + json.dumps({
            k: row[k] for k in ("view", "n_cams", "n_points", "pnp_inliers",
                                "pnp_ratio", "triangulated", "reproj_px",
                                "rot_err_deg", "t_err", "ate", "stage_s")}))
    assert launches["fwd"] > 0 and launches["bwd"] > 0, launches
    for stage, rec in per_stage.items():
        if rec["steps"]:
            rec["fwd_per_step"] = rec["fwd"] / rec["steps"]
            rec["bwd_per_step"] = rec["bwd"] / rec["steps"]
    log("[register] " + json.dumps({
        "views": model.camera_set.cam_ids, "wall_s": wall,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches": launches,
        "launch_shapes": {k: {f"{R}x{K}": n for (R, K), n in v.items()}
                          for k, v in shapes.items()},
        "per_stage": per_stage}))
    _profile_register(model, probes)
    return launches, shapes


def _profile_register(model, probes):
    """Steady ms per step (synchronised) and device-busy share of
    GeoInitPhase, BAPhase('sfm'), BAPhase('sfm_refine') and RefinePhase,
    each on a copy of the final parameters with its last call's batch."""
    import torch
    from level_s2fm_tpu_torch.sfm import bundle
    out = {}
    dev = torch.device("cuda")
    for stage, name in (("geo_init", "GeoInitPhase"), ("local_ba", "BAPhase sfm"),
                        ("sfm_refine", "BAPhase sfm_refine"), ("refine", "RefinePhase")):
        obj = probes[stage]
        batch = dict(obj.batch)
        if stage in ("geo_init", "refine"):
            state = obj.phase.init_state(_tree_to(model.params, dev))
        else:
            state = obj.phase.init_state(_ba_params(model, obj, dev), obj.xyzs0.clone())
        if stage in ("sfm_refine", "refine"):
            batch["occ"] = bundle.maybe_build_occ(model.opt, model.cfgs, state["params"])
        gen = torch.Generator().manual_seed(3)
        for _ in range(2):
            obj.phase.step(state, batch, gen)
        torch.cuda.synchronize()
        n = 10
        t0 = time.perf_counter()
        for _ in range(n):
            obj.phase.step(state, batch, gen)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / n * 1e3
        prof = _profile_steps(obj.phase, state, batch, gen)
        out[name] = {"ms_per_step_steady": step_ms,
                     "device_busy_ms_per_step": prof["device_busy_ms_per_step"],
                     "device_busy_share": prof["device_busy_ms_per_step"] / step_ms,
                     "top_op_device_ms_per_step": prof["top_op_device_ms_per_step"]}
        if "valid" in obj.batch:
            out[name]["P"] = int(obj.batch["valid"].shape[0])
        del state, batch
        torch.cuda.empty_cache()
    log("[register] steady steps " + json.dumps(out))


# --------------------------------------------------------------------------- bands

def phase_bands():
    """The 3-view fast run at configs/synthetic.yaml as it stands, held
    to 2x the known-good final values and to the E2E oracles."""
    import numpy as np
    import torch
    from level_s2fm_tpu_torch.config import build_options
    from level_s2fm_tpu_torch.geometry import lie
    from level_s2fm_tpu_torch.rendering import fused_composite as fc
    from level_s2fm_tpu_torch.sfm.pipeline import LevelSfM
    from level_s2fm_tpu_torch.train import build_var

    opt = build_options(["--yaml=" + os.path.join(REPO, "configs", "synthetic.yaml"),
                         "--sfm_mode=fast", "--output_path=" + _out_dir("bands")])
    model = LevelSfM(opt, seed=int(opt.seed), device="cuda")
    model.load_data(build_var(opt))
    fc.reset_launches()
    # one reproducible run: the hash grid's index_add_ backward sums in a
    # fixed order (K1/K2 are deterministic already). With float atomics,
    # runs of this seed spread 4.5-10.3 deg in the 3-camera Procrustes
    # rotation on the H100, whose sim(3) fit is poorly conditioned
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        t0 = time.perf_counter()
        ok = model.train(max_views=3, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
    assert ok and model.camera_set.cam_ids == [0, 1, 2], model.camera_set.cam_ids
    rot, t_err, ate = model.camera_set.eval_poses(verbose=False)
    got = {"reproj_px": model.view_log[-1]["reproj_px"], "rot_err_deg": rot,
           "t_err": t_err}
    poses, gt = model.camera_set.all_poses()
    p, g = torch.as_tensor(poses), torch.as_tensor(gt)

    def rel_deg(i, j):
        rel = lie.pose_compose_pair(lie.pose_invert(p[i]), p[j])
        rel_gt = lie.pose_compose_pair(lie.pose_invert(g[i]), g[j])
        return float(np.rad2deg(float(lie.rotation_distance(rel_gt[:3, :3],
                                                             rel[:3, :3]))))

    rel = {"0-1": rel_deg(0, 1), "0-2": rel_deg(0, 2)}
    log("[bands] " + json.dumps({"final": got, "ate": ate, "known_good": BANDS,
                                 "factor": BANDS_FACTOR, "rel_rot_deg": rel,
                                 "n_points": len(model.point_set),
                                 "launches": dict(fc.LAUNCHES), "wall_s": wall,
                                 "stage_s": model.view_log[-1]["stage_s"]}))
    for k, v in BANDS.items():
        assert math.isfinite(got[k]) and got[k] <= BANDS_FACTOR * v, (k, got[k], v)
    assert rel["0-1"] < 5.0 and rel["0-2"] < 8.0, rel


# --------------------------------------------------------------------------- prepared

def _check_prepared_row(row, ref):
    """One registered view against the JAX package's row of the same step."""
    got = {k: row[k] for k in ("view", "n_cams", "n_points", "reproj_px",
                               "rot_err_deg", "t_err", "ate")}
    got["view"] = int(got["view"])
    log("[prepared] view " + json.dumps({
        "port": got, "jax": {k: ref[k] for k in got},
        "pnp_inliers": row.get("pnp_inliers"), "pnp_ratio": row.get("pnp_ratio"),
        "triangulated": row.get("triangulated"), "stage_s": row["stage_s"]},
        default=lambda o: o.tolist()))
    assert int(row["view"]) == int(ref["view"]), (row["view"], ref["view"])
    assert row["n_cams"] == ref["n_cams"], (row["n_cams"], ref["n_cams"])
    f = PREPARED_FACTOR
    assert row["reproj_px"] < 1.0 and row["reproj_px"] <= f * ref["reproj_px"], got
    assert row["t_err"] <= f * ref["t_err"] and row["ate"] <= f * ref["ate"], got
    assert math.isfinite(row["rot_err_deg"]), got
    if row["n_cams"] >= PREPARED_ROT_MIN_CAMS:
        assert row["rot_err_deg"] <= f * ref["rot_err_deg"], got


def phase_prepared():
    """The third main path, through the port's CLI entry on the prepared
    scene: five views with a checkpoint after each, a fresh engine that
    resumes and registers the sixth, then ``--get_result`` with a refine
    over every camera and the export. Returns (launch counts, launch
    shapes)."""
    import numpy as np
    import torch
    from level_s2fm_tpu_torch import train
    from level_s2fm_tpu_torch.fields import sdf as sdf_mod
    from level_s2fm_tpu_torch.rendering import fused_composite as fc
    from level_s2fm_tpu_torch.sfm import optstate
    from level_s2fm_tpu_torch.utils import obs, png
    from level_s2fm_tpu_torch.utils.marching_cubes import read_ply

    out = _out_dir("prepared")
    args = PREPARED_ARGS + ["--output_path=" + out]
    with open(PREPARED_ROWS) as f:
        ref = [r for r in map(json.loads, f) if "view" in r]
    obs.HOST_TIMERS.totals.clear()
    obs.HOST_TIMERS.counts.clear()
    walls = {}
    launches = {"fwd": 0, "bwd": 0}
    shapes = {"fwd": {}, "bwd": {}}

    def run(name, argv):
        fc.reset_launches()
        t0 = time.perf_counter()
        m = train.main(argv)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        for k in launches:
            launches[k] += fc.LAUNCHES[k]
            for s, n in fc.SHAPES[k].items():
                shapes[k][s] = shapes[k].get(s, 0) + n
        log(f"[prepared] {name}: {walls[name]:.1f} s, launches "
            + json.dumps(fc.LAUNCHES) + " by (R, K) "
            + json.dumps({k: {f"{R}x{K}": n for (R, K), n in v.items()}
                          for k, v in fc.SHAPES.items()}))
        return m

    # 1. five views, a checkpoint after each
    m = run("views", args + [f"--max_views={PREPARED_VIEWS}"])
    assert len(m.camera_set) == PREPARED_VIEWS and not m.skipped_views, (
        m.camera_set.cam_ids, m.skipped_views)
    init = m.initializer
    log("[prepared] init " + json.dumps({
        "views": [int(c) for c in m.camera_set.cam_ids[:2]],
        "steps": int(len(init._metrics["all"])),
        "loss_last": {k: float(v[-1]) for k, v in init._metrics.items()},
        "triangulated": [int(v) for v in init.tri_ratio],
        "rot_error_deg": init.pose_errors[0], "t_error_deg": init.pose_errors[1]}))
    assert np.all(np.isfinite(init._metrics["all"]))
    log("[prepared] stage wall s over the run: " + json.dumps(m.timers.summary()))
    rows = m.view_log
    assert len(rows) == PREPARED_VIEWS - 2, [r["view"] for r in rows]
    for row, r in zip(rows, ref):
        _check_prepared_row(row, r)
    ckpt = os.path.join(out, "model.ckpt")
    ckpt_mb = os.path.getsize(ckpt) / 2 ** 20
    del m
    torch.cuda.empty_cache()

    # 2. a fresh engine resumes from model.ckpt and registers the next view;
    # the first phase of the saved label adopts the saved moments
    with np.load(ckpt, allow_pickle=False) as z:
        saved = json.loads(str(z["manifest"]))["optim"]
    optstate.reset()
    n_adopted = len(optstate.ADOPTED)
    m = run("resume", args + ["--resume", f"--max_views={RESUMED_VIEWS}"])
    adopted = optstate.ADOPTED[n_adopted:]
    log(f"[prepared] resume: checkpoint optimizer {saved}; adopted "
        f"(label, leaves): {adopted}")
    assert adopted == [(saved["label"], saved["n_leaves"])], (adopted, saved)
    assert len(m.camera_set) == RESUMED_VIEWS and len(m.view_log) == 1, (
        m.camera_set.cam_ids)
    _check_prepared_row(m.view_log[0], ref[RESUMED_VIEWS - 3])
    del m
    torch.cuda.empty_cache()

    # 3. refine over every camera, then the export (errors propagate)
    m = run("get_result", args + ["--get_result", "--refine_again",
                                  f"--refine_again_iters={REFINE_AGAIN_ITERS}"])
    assert np.all(np.isfinite(m.camera_set.all_se3()))
    for rel in ("model.ckpt", "pointcloud.ply", "cameras.json",
                "mesh/high_res.ply", "sparse/0/cameras.bin", "sparse/0/images.bin",
                "sparse/0/points3D.bin", "viewer.html", "render_cam0.png"):
        assert os.path.getsize(os.path.join(out, rel)) > 0, rel
    verts, faces = read_ply(os.path.join(out, "mesh", "high_res.ply"))
    v = verts - verts.mean(0)
    axes = np.linalg.eigh(np.cov(v.T))[1]
    spacing = float(np.ptp(v @ axes, axis=0).min()) / (256 - 1)
    sdf = np.concatenate([sdf_mod.infer_sdf_host(m.params["sdf"], m.sdf_cfg, c)
                          for c in np.array_split(verts, max(1, len(verts) // 65536))])
    med = float(np.median(np.abs(sdf)))
    img = png.read_png(os.path.join(out, "render_cam0.png")).astype(np.float64) / 255.0
    gt = np.asarray(m.camera_set.cameras[0].img, np.float64)
    psnr = -10.0 * math.log10(float(np.mean((img - gt) ** 2)))
    log("[prepared] export " + json.dumps({
        "mesh_faces": len(faces), "mesh_verts": len(verts),
        "median_abs_sdf_at_verts": med, "grid_spacing_bound": spacing,
        "render_cam0_psnr_db": psnr, "n_points": len(m.point_set)}))
    assert len(faces) > 1000 and med < spacing, (len(faces), med, spacing)
    assert np.all(np.isfinite(img)) and math.isfinite(psnr)
    del m
    torch.cuda.empty_cache()

    ht = obs.HOST_TIMERS
    mean_ms = {k: ht.totals[k] / ht.counts[k] * 1e3 for k in ht.totals}
    log("[prepared] " + json.dumps({
        "wall_s": walls, "launches": launches,
        "launch_shapes": {k: {f"{R}x{K}": n for (R, K), n in v.items()}
                          for k, v in shapes.items()},
        "save_checkpoint_ms": mean_ms["host_checkpoint"],
        "saves": ht.counts["host_checkpoint"],
        "restore_checkpoint_ms": mean_ms["host_restore"],
        "checkpoint_mb": ckpt_mb,
        "extract_mesh_high_res_ms": mean_ms["export_mesh"],
        "render_full_image_ms": mean_ms["export_render"],
        "export_results_ms": mean_ms["export_results"]}))
    assert launches["fwd"] > 0 and launches["bwd"] > 0, launches
    return launches, shapes


# --------------------------------------------------------------------------- options

def phase_options(init_summary):
    """Phase init's configuration with OPTION_SWITCHES: OPTION_STEPS init
    steps, then the steady step and one 8192-ray march with and without
    march_compact. Returns (launch counts, launch shapes)."""
    import dataclasses
    import numpy as np
    import torch
    from level_s2fm_tpu_torch.config import build_options
    from level_s2fm_tpu_torch.fields import sdf as sdf_mod
    from level_s2fm_tpu_torch.geometry import transforms as T
    from level_s2fm_tpu_torch.rendering import fused_composite as fc
    from level_s2fm_tpu_torch.sfm import bundle
    from level_s2fm_tpu_torch.sfm.pipeline import LevelSfM
    from level_s2fm_tpu_torch.train import build_var

    steps = OPTION_STEPS
    opt = build_options(FULL_WIDTH_ARGS + OPTION_SWITCHES + [
        # configs/levels2fm.yaml's width of the adaptive sampler's final
        # samples, which configs/synthetic.yaml cuts to 32
        "--SDF.VolSDF.final_sample_intvs=64",
        f"--optim.init.max_iter={steps}", "--output_path=" + _out_dir("options")])
    model = LevelSfM(opt, seed=int(opt.seed), device="cuda")
    model.load_data(build_var(opt))
    cfg = model.cfgs
    assert (cfg.rad.dual_field and cfg.ren.volsdf_sampling and cfg.sdf.grid.paired_dense
            and cfg.sdf.reeval_compact == 0.5 and cfg.sdf.march_compact == 0.25)
    torch.cuda.synchronize()
    fc.reset_launches()
    t0 = time.perf_counter()
    model.train(max_views=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fc.LAUNCHES)
    shapes = {k: dict(v) for k, v in fc.SHAPES.items()}
    init = model.initializer
    m = init._metrics
    assert len(m["all"]) == steps, len(m["all"])
    for k, v in m.items():
        assert np.all(np.isfinite(v)), k
    assert float(np.sum(m["nonfinite"])) == 0.0
    assert m["rgb"][-1] < m["rgb"][0], (m["rgb"][0], m["rgb"][-1])
    assert launches["fwd"] >= steps and launches["bwd"] >= steps, launches
    assert set(model.params["rad"]) == {"geo_mlp", "rad_mlp", "table"}

    state = init.phase.init_state(_tree_to(model.params, "cuda"))
    batch = dict(init.batch)
    batch["occ"] = bundle.maybe_build_occ(opt, cfg, state["params"])
    gen = torch.Generator().manual_seed(1)
    init.phase.step(state, batch, gen)
    torch.cuda.synchronize()
    k_steps = 5
    t1 = time.perf_counter()
    for _ in range(k_steps):
        init.phase.step(state, batch, gen)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t1) / k_steps * 1e3
    prof = _profile_steps(init.phase, state, batch, gen)

    # one 8192-ray march of the trained field, with and without march_compact
    params = model.params
    HW = cfg.H * cfg.W
    idx = torch.randperm(HW, generator=torch.Generator().manual_seed(2))
    idx = idx[:min(cfg.rand_rays // 2, HW)].to(model.device)
    c, r = T.get_center_and_ray(batch["poses"], batch["intr"], batch["grid"][idx])
    c1, r1 = c.reshape(1, -1, 3), r.reshape(1, -1, 3)
    cfg_plain = dataclasses.replace(cfg.sdf, march_compact=0.0)
    march, march_ms = {}, {}
    for name, scfg in (("march_compact", cfg.sdf), ("plain", cfg_plain)):
        march[name] = sdf_mod.sphere_march(params["sdf"], scfg, c1, r1)
        ts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            sdf_mod.sphere_march(params["sdf"], scfg, c1, r1)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t2) * 1e3)
        march_ms[name] = sorted(ts)[2]
    a, b = march["march_compact"], march["plain"]
    assert a.last_idx == b.last_idx, (a.last_idx, b.last_idx)
    march_err = max(float((x - y).abs().max()) for x, y in
                    ((a.track, b.track), (a.acc_e, b.acc_e), (a.min_dis, b.min_dis),
                     (a.max_dis, b.max_dis)))
    summary = {
        "steps": steps, "init_wall_s": wall, "ms_per_step_in_init": wall / steps * 1e3,
        "ms_per_step_steady": step_ms,
        "device_busy_ms_per_step": prof["device_busy_ms_per_step"],
        "device_busy_share": prof["device_busy_ms_per_step"] / step_ms,
        "phase_init_ms_per_step_steady": init_summary["ms_per_step_steady"],
        "phase_init_device_busy_share":
            init_summary["profile"]["device_busy_share_of_steady_step"],
        "top_op_device_ms_per_step": prof["top_op_device_ms_per_step"],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches": launches,
        "launch_shapes": {k: {f"{R}x{K}": n for (R, K), n in v.items()}
                          for k, v in shapes.items()},
        "loss_first": {k: float(v[0]) for k, v in m.items()},
        "loss_last": {k: float(v[-1]) for k, v in m.items()},
        "march_8192_rays_ms": march_ms, "march_steps": a.last_idx + 1,
        "march_compact_max_abs_diff": march_err}
    log("[options] " + json.dumps(summary))
    assert march_err <= 1e-5, march_err
    return launches, shapes


# --------------------------------------------------------------------------- ablations

def phase_ablations():
    """(a) the trad run against the JAX package's values, (b) the pose
    polish of phase prepared's checkpoint, (c) a tri_trad-only run in
    full mode. Returns the launch counts and shapes of (c)."""
    import numpy as np
    import torch
    from level_s2fm_tpu_torch import polish_trad_ba, train
    from level_s2fm_tpu_torch.rendering import fused_composite as fc

    # (a) DLT triangulation + classic BA; nothing is rendered
    fc.reset_launches()
    t0 = time.perf_counter()
    m = train.main(TRAD_ARGS + ["--max_views=3", "--output_path=" + _out_dir("trad")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert m.camera_set.cam_ids == [0, 1, 2] and not m.skipped_views, m.camera_set.cam_ids
    r = np.linalg.norm(m.point_set.all_xyzs(), axis=-1)
    med = float(np.median(np.abs(r - 0.5)))
    rot, t_err, ate = m.camera_set.eval_poses(verbose=False)
    got = {"reproj_px": m.view_log[-1]["reproj_px"], "rot_err_deg": rot, "t_err": t_err}
    log("[ablations] trad " + json.dumps({
        "final": got, "ate": ate, "jax": TRAD_KNOWN, "jax_spread": TRAD_SPREAD,
        "factor": TRAD_FACTOR,
        "ratio_to_jax": {k: got[k] / v for k, v in TRAD_KNOWN.items()},
        "n_points": len(m.point_set), "median_abs_radius_err": med, "wall_s": wall,
        "stage_s": m.view_log[-1]["stage_s"], "launches": dict(fc.LAUNCHES)}))
    assert len(m.point_set) > 30 and med < 0.1, (len(m.point_set), med)
    for k, v in TRAD_SPREAD["max"].items():
        assert math.isfinite(got[k]) and got[k] <= TRAD_FACTOR * v, (k, got[k], v)
    assert fc.LAUNCHES == {"fwd": 0, "bwd": 0}, fc.LAUNCHES
    del m

    # (b) global trad BA cycles on phase prepared's six-view checkpoint
    run_dir = os.path.join(REPO, "output", "chip_smoke", "prepared")
    t0 = time.perf_counter()
    res = polish_trad_ba.main([run_dir] + PREPARED_ARGS + POLISH_ARGS)
    wall = time.perf_counter() - t0
    before, after = res["before"], res["cycles"][-1]
    log("[ablations] polish " + json.dumps({
        "before": before, "cycles": res["cycles"], "wall_s": wall,
        "checkpoint": os.path.relpath(res["path"], REPO)}))
    assert after["reproj_px"] < before["reproj_px"], (before, after)
    assert after["ate"] <= before["ate"], (before, after)
    torch.cuda.empty_cache()

    # (c) DLT triangulation under the neural BA and refine (full mode)
    fc.reset_launches()
    t0 = time.perf_counter()
    m = train.main(TRI_TRAD_ARGS + ["--max_views=3",
                                    "--output_path=" + _out_dir("tri_trad_full")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fc.LAUNCHES)
    shapes = {k: dict(v) for k, v in fc.SHAPES.items()}
    assert m.camera_set.cam_ids == [0, 1, 2] and not m.skipped_views, m.camera_set.cam_ids
    row = m.view_log[-1]
    for k in ("reproj_px", "rot_err_deg", "t_err", "ate"):
        assert math.isfinite(row[k]), (k, row[k])
    log("[ablations] tri_trad full " + json.dumps({
        k: row[k] for k in ("view", "n_points", "pnp_inliers", "triangulated",
                            "reproj_px", "rot_err_deg", "t_err", "ate", "stage_s")}
        | {"wall_s": wall, "launches": launches,
           "launch_shapes": {k: {f"{R}x{K}": n for (R, K), n in v.items()}
                             for k, v in shapes.items()}}, default=lambda o: o.tolist()))
    assert launches["fwd"] > 0 and launches["bwd"] > 0, launches
    return launches, shapes


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
    log(f"[time] {time.time() - t_start:.1f} s")
    model, launches, init_summary = phase_init()
    log(f"[time] {time.time() - t_start:.1f} s")
    reg_launches, reg_shapes = phase_register(model)
    del model
    torch.cuda.empty_cache()
    log(f"[time] {time.time() - t_start:.1f} s")
    shapes = sorted(set(reg_shapes["fwd"]) | set(reg_shapes["bwd"]))
    err = hold_composite(shapes, torch.device("cuda"), tag="register kernels")
    for rec, kind in zip(recs, ("fwd", "bwd")):
        rec["launches"] = launches[kind] + reg_launches[kind]
        rec["max_abs_err"] = max(rec["max_abs_err"], err[kind])
    log("[launches] init " + json.dumps(launches) + " register "
        + json.dumps(reg_launches))
    phase_bands()
    log(f"[time] {time.time() - t_start:.1f} s")
    prep_launches, prep_shapes = phase_prepared()
    shapes = sorted(set(prep_shapes["fwd"]) | set(prep_shapes["bwd"]))
    err = hold_composite(shapes, torch.device("cuda"), tag="prepared kernels")
    for rec, kind in zip(recs, ("fwd", "bwd")):
        rec["launches"] += prep_launches[kind]
        rec["max_abs_err"] = max(rec["max_abs_err"], err[kind])
    log("[launches] prepared " + json.dumps(prep_launches))
    log(f"[time] {time.time() - t_start:.1f} s")
    opt_launches, opt_shapes = phase_options(init_summary)
    log(f"[time] {time.time() - t_start:.1f} s")
    abl_launches, abl_shapes = phase_ablations()
    log(f"[time] {time.time() - t_start:.1f} s")
    shapes = sorted(set(opt_shapes["fwd"]) | set(opt_shapes["bwd"])
                    | set(abl_shapes["fwd"]) | set(abl_shapes["bwd"]))
    err = hold_composite(shapes, torch.device("cuda"), tag="options/ablations kernels")
    for rec, kind in zip(recs, ("fwd", "bwd")):
        rec["launches"] += opt_launches[kind] + abl_launches[kind]
        rec["max_abs_err"] = max(rec["max_abs_err"], err[kind])
    log("[launches] options " + json.dumps(opt_launches) + " ablations "
        + json.dumps(abl_launches))
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
