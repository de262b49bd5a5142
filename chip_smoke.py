#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port on one NVIDIA GPU.

    python3 chip_smoke.py [--determinism]

``--determinism`` times the render phases' steady steps three ways
(phases init and register, below); the smoke itself takes no arguments. Imports nothing of JAX and nothing of the JAX package. Phases (any
failure raises and exits non-zero), run in the order 1-6, 9, then 7, 8,
14, 10, 11, 13, 15 and 12: phases 1-6 and 9 alone on the card; from
phase 7 on, three side processes (``start_checks``) run the checks whose
walls are not read (phase prepared's second engine, phase parallel's
(b) and (c)) beside the phases, and phase 12 (a) runs alone after them:

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
   With ``--determinism`` it also prints the steady ms per step three
   ways, from the same parameters: with the ordered scatter (the port),
   with ``index_add_``'s float atomics (the smoke's own switch, not the
   package's) and under ``torch.use_deterministic_algorithms``.
6. register — the second main path: the same model goes on to register
   view 3 (``REGISTER_VIEWS``; ``sfm_mode: full``: PnP, geoinit, one
   single-camera sfm_refine BA, up to 5 local and 5 global BA cycles, refine). Depth
   is cut to the iteration counts of ``configs/synthetic.yaml`` (geoinit
   30 x 5 steps, BA 150, refine 100; the full config's 100 x 5, 1000,
   500). Every view must register and every loss stay finite. Per view
   it prints PnP inliers, the triangulation ratio, the pose errors and
   the wall s per stage; then, on copies of the final state, the steady
   ms per step and the device-busy share of each phase (with
   ``--determinism``, GeoInitPhase, BAPhase ``sfm_refine`` and
   RefinePhase also the three ways of phase init, from the same
   parameters); then K1/K2 are held to their plain versions at
   every shape the run launched.
7. bands — the 3-view ``--sfm_mode=fast`` run at
   ``configs/synthetic.yaml`` as it stands, twice from the same seed,
   back to back: the two runs must be equal bit for bit (every camera's se3, the point
   count, the final row: the ordered scatter sums the hash grid's table
   cotangent in a fixed order); each final value must be
   within 2x of the known-good values (reproj 0.315 px, rot 6.0 deg, t
   0.018), and the relative rotations within the E2E oracles (views 0-1
   < 5 deg, 0-2 < 8 deg).
8. scenes — the steps before training, with the port alone (no OpenCV,
   no imageio): ``render_hard_view`` re-renders views 0 and 17 of
   data/synthhard/scan1 and ``render_multiroom_view`` the depths of views
   0 and 12 of data/scannet/multiroom0; written as the dataset writer
   writes them, they must equal the committed PNGs within one least
   significant bit (differing pixels printed). The greedy pose graph
   over each committed ``two_view.npy`` (synthhard, synthprep, multiroom)
   must be its ``pose_graph.npy``; a COLMAP database and a .txt and a
   .bin model are written and read back, and the COLMAP backend on them
   with a mapper log must give the log's order. Prints the seconds of
   each render.
9. prepared — the third main path, through the port's CLI entry
   (``train.main``) on a prepared scene: ``configs/synthhard_r5.yaml`` as
   it stands (data/synthhard/scan1 through the port's loaders: 200x200,
   SIFT matches, the widths of ``configs/levels2fm.yaml``, init 400,
   geoinit 60 x 5, BA 400) in ``--sfm_mode=fast``, as the JAX package's
   committed run. Five views with a checkpoint after each; each view's
   row is held to that run's row of the same step
   (``results/synthhard_r5_metrics.jsonl``): the same view, reproj < 1 px
   and within 2x, t_err and ate within 2x, the rotation within 2x from 5
   cameras up (the Procrustes fit of 3-4 near-collinear centres is
   ill-conditioned). A second engine runs the init and the first view
   again in a side process after this phase, and its row must repeat
   the first one bit for bit. Then a fresh engine resumes from
   ``model.ckpt``,
   must adopt the saved optimizer moments and registers the sixth view
   under the same bars; then ``--get_result --refine_again`` refines
   every camera (``REFINE_AGAIN_ITERS`` steps, K1/K2) and exports the results, each file
   checked (mesh > 1000 faces with median |SDF| at its vertices below a
   grid spacing, ``render_cam0.png`` finite, its PSNR printed). K1/K2 are
   held at every shape the phase launched. Prints the per-view stage
   times, the checkpoint save / restore ms and size, and the export ms.
10. options — phase init's configuration with the SDF / renderer options
   switched on (``OPTION_SWITCHES``: the dual radiance field, the
   adaptive VolSDF sampler with ``final_sample_intvs`` 64, the
   ``paired_dense`` key, and the exact ``reeval_compact`` /
   ``march_compact`` compactions), ``OPTION_STEPS`` init steps. Losses
   must be finite and the rgb loss must fall; prints the steady ms per
   step and the device-busy share beside phase init's, and one 8192-ray
   march with and without ``march_compact`` (ms each; the tracks must
   agree to 1e-5).
11. ablations — (a) the 3-view ``configs/synthetic.yaml`` run under
   ``--sfm_mode=fast --Ablate_config.tri_trad --Ablate_config.ba_trad``
   through ``train.main``: every view registers, > 30 points with
   median | |X| - 0.5 | < 0.1, and the final reproj / rotation /
   translation errors within 2x of the JAX package's values for the same
   command, taken over its rounding spread (``TRAD_SPREAD``, from
   ``trad_spread.py``); it renders nothing, so K1/K2 do not launch.
   (b) ``polish_trad_ba`` (``--cycles=1 --iters=1000``) on the six-view
   checkpoint phase prepared leaves: the mean reprojection error must
   fall and the ATE must not rise; prints each cycle's errors and wall
   time. (c) one ``tri_trad``-only run of the synthetic scene in
   ``full`` mode, BA and refine cut to 75 and 50 steps (DLT triangulation with the SDF post-fit, then
   sfm_refine, BA and refine), where K1/K2 launch.

12. parallel — (b) and (c) run in the side processes that start after
   phase prepared and go on beside phases bands to demo (the card and
   the host shared: their walls are not timings); (a) runs alone at the
   end. Data-parallel ranks through
   ``parallel.distributed.launch``
   (the path ``train.main`` takes): ``PARALLEL_RANKS`` ranks, which
   share the one card over gloo (CUDA tensors staged through the host),
   or one rank per card over NCCL where that many cards are visible.
   (a) One init step at phase init's full width from the seed's
   parameters and draws: every loss
   within 1e-6 relative and every parameter within 1e-5 of one rank's,
   the ranks bit for bit equal; then the steady ms per step at one rank
   and at the ranks, and the ms of one all-reduce of the gradients.
   (b) The bands run at the ranks: within the bands, and within the JAX
   package's 1-vs-8-device bounds (``WORLD_BOUNDS``, points within
   max(8, 15%)) of phase bands' one-rank values. (c)
   ``configs/scannet_multiroom_synth.yaml`` (``MULTIROOM_ARGS``: fast, 3
   views, its init and BA cut, its geoinit as it stands): its init at
   one rank, then view 3 from that
   checkpoint at one rank and at the ranks: both register it with the
   BA under 1 px, the ranks' final values within ``WORLD_BOUNDS`` of one
   rank's (the rotation by the relative rotations of the camera pairs
   against GT; the Procrustes rotation error is printed beside them),
   the ranks' parameters equal; the wall s per stage of each world.
   K1/K2 launch in every rank; their counts are summed over the ranks
   and every shape launched is held to the plain versions.

13. ab — ``python -m level_s2fm_tpu_torch.ab_adaptive_sampler`` at its
   full width (128x128, 2048 rays) with ``AB_STEPS`` steps an arm: the
   rays/s, held-out PSNR and train seconds of each arm beside the card's
   name and power limit; K1/K2 launch in arm ``uniform128+occ32`` and
   are held at its shapes.
14. diag — ``python -m level_s2fm_tpu_torch.diag_frontier_pnp`` on the
   checkpoint phase prepared leaves (6 of 32 views registered): a row
   for every unregistered view with pairs >= gated >= every inlier
   count; its ``--cpu`` run gives the same pairs and gated counts.
15. demo — ``python -m level_s2fm_tpu_torch.two_view_init_demo`` at its
   default ``--iters 200``: the pose errors and the eight files written.

After phase kernels, hold_scatter holds the ordered scatter
(``csrc/hash_scatter.cu``: a radix sort of the keys' own bits, then a
segment sum) at the main path's shapes (16.8 M contributions of the
full-width hash grid; its coarse dense level 0 alone; the occupancy
compaction's gather backward) and at the edge shapes of its sort tile
(``scatter_edge_cases``): bit for bit the CPU's plain version (the same
order), within ``SCATTER_RTOL`` of a row's sum of |contributions| of
``index_add_``'s atomics on the card, three calls bitwise equal; then
timed (each kernel's share and the launches a call from torch.profiler,
which must show the scatter's kernels and no more launches than the
parent commit's scatter) beside ``torch.sort`` of the keys (the parent's
sort), ``index_add_`` (plain) and ``index_put_`` with accumulate
(library). At the end it is held the same way at every (n, m, F) it
launched on the main paths, and its launches a call are counted and
held to the parent's at the smallest of them.

Phase reference also holds one InitPhase step and one
``BAPhase('rad_init')`` step under ``OPTION_SWITCHES`` (tiny widths) to
the CPU's plain versions, and every shape K1/K2 launched in phases
options and ablations is held against the plain versions.

Each main path is driven with the launch counts set to 0 just before it
and read just after; K1, K2 and the ordered scatter must have launched
in each (the trad run of phase ablations renders nothing: there the
scatter alone; phase diag trains nothing and launches none).

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
#: views of the synthetic scene the register phase brings in: one past
#: the init, to leave phase parallel its time
REGISTER_VIEWS = 3
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
#: the refine over every camera before the export (cut to make room for
#: the later phases)
REFINE_AGAIN_ITERS = 100
#: a row's reproj / t_err / ate may reach this factor of the JAX row's;
#: the Procrustes rotation too, from PREPARED_ROT_MIN_CAMS cameras up
PREPARED_FACTOR, PREPARED_ROT_MIN_CAMS = 2.0, 5

#: the SDF / renderer options of the options phase and of the reference
#: phase's option steps
OPTION_SWITCHES = ["--Ablate_config.dual_field", "--SDF.VolSDF.volsdf_sampling",
                   "--SDF.Hash_config.paired_dense",
                   "--SDF.VolSDF.reeval_compact=0.5",
                   "--SDF.VolSDF.march_compact=0.25"]
#: init steps of the options phase (phase init's INIT_STEPS, cut to 20 to
#: make room for phases parallel, ab, diag and demo)
OPTION_STEPS = 20
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
#: the pose polish of the prepared run: one cycle of the two
#: results/synthhard_r5.md ran, and 1000 of its 1500 steps, to leave the
#: later phases their time
POLISH_ARGS = ["--cycles=1", "--iters=1000"]
#: DLT triangulation under the neural BA and refine: configs/synthetic.yaml
#: in full mode, its BA and refine cut from 150 and 100 steps to 75 and 50
TRI_TRAD_ARGS = ["--yaml=" + os.path.join(REPO, "configs", "synthetic.yaml"),
                 "--Ablate_config.tri_trad", "--optim.ba.max_iter=75",
                 "--optim.refine.max_iter=50"]


#: phase parallel: the data-parallel ranks held against one rank
PARALLEL_RANKS = 2
#: (a) steady init steps timed at each world
PARALLEL_STEADY_STEPS = 3
#: (a) one step at PARALLEL_RANKS ranks against one: every loss to this
#: relative error, every parameter to this absolute one
PARALLEL_LOSS_RTOL, PARALLEL_PARAM_ATOL = 1e-6, 1e-5
#: (b), (c): the final values of the run at PARALLEL_RANKS ranks against
#: one rank's, to the bounds of the JAX package's 1-vs-8-device pipeline
#: test (tests/test_sharded_pipeline.py:152-156); the points within
#: max(8, 15%)
WORLD_BOUNDS = {"rot_err_deg": 4.0, "t_err": 5e-3, "ate": 5e-3, "reproj_px": 5e-2}
#: (c) configs/scannet_multiroom_synth.yaml as it stands (24 views of
#: data/scannet/multiroom0 at 192x192, the widths of configs/levels2fm.yaml),
#: fast mode, 3 views; its init 500 and BA 2000
#: steps cut to 300 and 200 to fit the time limit, its geoinit (100 steps)
#: as it stands. At that depth view 3's BA ends under 1 px at one rank, so
#: the local and the global BA each stop after one cycle; with geoinit 20
#: it stayed at 3.6 px through five cycles of each, and a second one-rank
#: run with the card's float atomics then moved t_err by 0.016 (PERF.md,
#: section 6). One rank makes the init; view 3 is then registered from its
#: checkpoint at one rank and at the ranks (the init at the ranks does
#: not fit the time limit beside them).
MULTIROOM_ARGS = ["--yaml=" + os.path.join(REPO, "configs", "scannet_multiroom_synth.yaml"),
                  "--sfm_mode=fast", "--max_views=3", "--optim.init.max_iter=300",
                  "--optim.ba.max_iter=200"]
#: (c) a converged view 3 registers below this reprojection error (the
#: BA's own stop, ``pipeline.register_view``)
MULTIROOM_MAX_REPROJ_PX = 1.0
#: (c) holds the rotation by the relative rotations of the camera pairs
#: (0, 1) and (0, 2) against GT, as phase bands' oracles do, and prints the
#: Procrustes rotation error beside them without holding it: the
#: alignment of three near-collinear camera centres leaves the rotation
#: about their line free, and it read 92.6 deg for a one-rank view 3 that
#: converged to 0.58 px with t_err 5.5e-3 (phase prepared too checks that
#: rotation only from 5 cameras up)


def log(*a):
    print(*a, flush=True)


def _reset_counts():
    """Every kernel's launch count set to 0: K1/K2 and the ordered scatter."""
    from level_s2fm_tpu_torch.fields import hash_scatter as hs
    from level_s2fm_tpu_torch.rendering import fused_composite as fc
    fc.reset_launches()
    hs.reset_launches()


def _read_counts():
    """{"fwd", "bwd", "scatter"}: the launches since ``_reset_counts``."""
    from level_s2fm_tpu_torch.fields import hash_scatter as hs
    from level_s2fm_tpu_torch.rendering import fused_composite as fc
    return {**fc.LAUNCHES, "scatter": hs.LAUNCHES["scatter"]}


def _scatter_shapes():
    """The ordered scatter's launches by (n, m, F) since ``_reset_counts``."""
    from level_s2fm_tpu_torch.fields import hash_scatter as hs
    return dict(hs.SHAPES)


def _wait_for(path, timeout_s=900.0):
    """Waits until ``path`` exists (a marker another process writes)."""
    t0 = time.perf_counter()
    while not os.path.exists(path):
        assert time.perf_counter() - t0 < timeout_s, f"no {path} after {timeout_s} s"
        time.sleep(1.0)


def _row_text(row):
    """A metrics row as comparable text, without its wall times."""
    import numpy as np
    return {k: json.dumps(v, default=lambda o: np.asarray(o).tolist())
            for k, v in row.items() if k != "stage_s"}


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
         "launches": 0, "max_abs_err": err["fwd"], "ms": kept[0], "plain_ms": t_plain["fwd"],
         "bound_ms": fwd_b, "bound_by": fwd_by, "library_ms": None},
        {"name": "laplace_composite_bwd", "route": "cuda", "source": src,
         "replaces": f"{ref}:135 (_bwd_kernel, launched at :267)",
         "launches": 0, "max_abs_err": err["bwd"], "ms": kept[2], "plain_ms": t_plain["bwd"],
         "bound_ms": bwd_b, "bound_by": bwd_by, "library_ms": None},
    ]
    log(f"[kernels] main path R={R} K={K} (no single PyTorch call computes "
        f"this function: library_ms is null): device ms fwd {kept[0]:.6f} "
        f"bwd {kept[2]:.6f}, "
        f"plain ms " + json.dumps(t_plain)
        + f", empty-kernel floor {floor_ms:.6f} ms")
    return recs


# --------------------------------------------------------------------------- ordered scatter

#: the ordered scatter's inputs at the main path's shape: the hash-grid
#: corners of one ray_chunk call of the init's render (2 cameras x 2048
#: rays x 32 compacted samples = 131,072 points, x 16 levels x 8 corners =
#: 16.8 M contributions into the 16 x 2^19 rows of configs/levels2fm.yaml),
#: drawn on a shell around the synthetic scene's sphere; the coarse dense
#: level 0 alone (17^3 rows, the longest segments); and the occupancy
#: compaction's gather backward (K = 32 of 128 samples a ray, one column)
SCATTER_POINTS = 131072
#: the ordered scatter against index_add_'s atomics on the card: the
#: largest |difference| of a row over that row's sum of |contributions|
#: (the order of a float sum moves it by a few ulp of that sum)
SCATTER_RTOL = 1e-6


#: the ordered scatter's launches by (n, m, F) on this process's main
#: paths, filled in as they run; held at the end
SCATTER_SEEN = {}
#: rows of the hash grid's coarse dense level 0 at the main width (17^3)
COARSE_ROWS = 17 ** 3


def scatter_at_shapes(shapes, dev, seed=1):
    """(name, (gi, g, m)) for every (n, m, F) in ``shapes``, with keys
    drawn at random on the card (not the launched ones): half of the
    contributions on the first ``COARSE_ROWS`` rows (a coarse dense
    level's long segments), half anywhere, shuffled."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    for n, m, F in sorted(shapes):
        half = n // 2
        gi = torch.cat([
            torch.randint(0, min(m, COARSE_ROWS), (half,), generator=gen, device=dev),
            torch.randint(0, m, (n - half,), generator=gen, device=dev)])
        gi = gi[torch.randperm(n, generator=gen, device=dev)]
        yield f"n={n} m={m} F={F}", (gi, torch.randn(n, F, generator=gen, device=dev), m)


def scatter_inputs(dev, points=SCATTER_POINTS, seed=0):
    """{name: (gi, g, m)} at the shapes of ``SCATTER_POINTS``'s note."""
    import torch
    from level_s2fm_tpu_torch.config import build_options
    from level_s2fm_tpu_torch.fields import hashgrid
    cfg = hashgrid.config_from_opt(build_options(FULL_WIDTH_ARGS))
    gen = torch.Generator().manual_seed(seed)
    d = torch.randn(points, 3, generator=gen)
    r = 0.5 + 0.02 * torch.randn(points, 1, generator=gen)
    x_unit = (d / d.norm(dim=-1, keepdim=True) * r + 1.0) / 2.0
    idx, _ = hashgrid.corner_indices(x_unit.to(dev), cfg)
    T, F = cfg.table_size, cfg.n_features_per_level
    gi = hashgrid.flat_indices(idx, T)
    cases = {"main": (gi, torch.randn(gi.numel(), F, generator=gen).to(dev),
                      cfg.n_levels * T)}
    gi0 = idx[0].reshape(-1)
    cases["level0"] = (gi0, torch.randn(gi0.numel(), F, generator=gen).to(dev), T)
    R, S, K = 2 * 2048, 128, 32
    col = torch.sort(torch.randint(0, S, (R, K), generator=gen), dim=-1).values
    gt = (col + torch.arange(R)[:, None] * S).reshape(-1)
    cases["take_along"] = (gt.to(dev), torch.randn(R * K, 1, generator=gen).to(dev), R * S)
    return cases


def scatter_edge_cases(dev, tile, seed=2):
    """(name, (gi, g, m)) at the edge shapes of a sort tile of ``tile``
    keys: no contribution, one, a tile - 1 and + 1; one row, 2^k and
    2^k + 1 rows; all keys equal; one row of 3,400 among others; keys
    outside [0, m) (they touch no row); 2^24 + 1 rows (four sort passes).
    Cotangents spread over 16 binades, so the order of a sum shows."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = [("random", 0, 5, 2), ("random", 1, 1, 1), ("random", tile - 1, 2 ** 12, 2),
              ("random", tile + 1, 2 ** 12 + 1, 4), ("random", tile + 1, 1, 8),
              ("all_equal", 2 * tile + 3, 300, 1), ("long_segment", 3600, 2 ** 16 + 1, 2),
              ("out_of_range", tile + 1, 1000, 2), ("random", 3000, 2 ** 24 + 1, 1)]
    for name, n, m, F in shapes:
        gi = torch.randint(0, m, (n,), generator=gen, device=dev)
        if name == "all_equal":
            gi.fill_(m - 1)
        elif name == "long_segment":
            gi[:3400] = m // 3
            gi = gi[torch.randperm(n, generator=gen, device=dev)]
        elif name == "out_of_range":
            gi = torch.randint(-40, m + 40, (n,), generator=gen, device=dev)
            far = torch.tensor([-2 ** 40, 2 ** 40, m, -1], device=dev)
            gi[::7] = far[torch.arange(len(gi[::7]), device=dev) % 4]
        g = torch.randn(n, F, generator=gen, device=dev) * torch.exp2(
            torch.randint(-8, 8, (n, 1), generator=gen, device=dev).float())
        yield f"edge {name} n={n} m={m} F={F}", (gi, g, m)


def hold_scatter(cases, tag="hold_scatter"):
    """The ordered scatter on the card against its plain version on the
    CPU (bit for bit: the same order), against ``index_add_`` on the card
    (``SCATTER_RTOL``), and against itself (three calls bitwise equal).
    Keys outside [0, m) are left out of the references (``index_add_``
    refuses them). Returns the largest |difference| from the CPU's plain
    version."""
    import torch
    from level_s2fm_tpu_torch.fields import hash_scatter as hs
    worst = 0.0
    for name, (gi, g, m) in cases.items():
        keep = (gi >= 0) & (gi < m)
        ki, kg = (gi, g) if bool(keep.all()) else (gi[keep], g[keep])
        runs = [hs.scatter_cuda(gi, g, m) for _ in range(3)]
        atomic = hs.scatter_plain(ki, kg, m)
        mag = hs.scatter_plain(ki, kg.abs(), m)
        torch.cuda.synchronize()
        cpu = hs.scatter_plain(ki.cpu(), kg.cpu(), m)
        repeat = all(torch.equal(runs[0], x) for x in runs[1:])
        err_cpu = float((runs[0].cpu() - cpu).abs().max())
        same_cpu = torch.equal(runs[0].cpu(), cpu)
        rel = float(((runs[0] - atomic).abs() / mag.clamp_min(1e-30)).max())
        seg = torch.bincount(ki, minlength=m)
        log(f"[{tag}] {name}: {gi.numel()} contributions ({ki.numel()} in range) "
            f"into {m} rows x {g.shape[1]}, {int((seg > 0).sum())} rows hit, longest "
            f"segment {int(seg.max())}; bitwise equal to the CPU's plain version="
            f"{same_cpu} (max_abs_err {err_cpu:.3e}); against index_add_ on "
            f"the card {rel:.3e} of a row's sum of |contributions| (bar "
            f"{SCATTER_RTOL}); three calls bitwise equal={repeat}")
        assert same_cpu, (name, err_cpu)
        assert rel <= SCATTER_RTOL, (name, rel)
        assert repeat, name
        worst = max(worst, err_cpu)
        del runs, atomic, mag, cpu, seg
    return worst


def device_kernels(fn, calls=5, tries=5):
    """{kernel: [launches a call, device ms a call]} of ``fn``'s device
    work (kernels, memsets, copies), from a torch.profiler trace of
    ``calls`` calls after one warm-up call. A trace that holds no device
    event (seen on the card now and then) is taken again, up to ``tries``
    times; then the check fails."""
    import re
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        out = {}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                name = re.sub(r"^void |\(anonymous namespace\)::", "", e.name)
                rec = out.setdefault(name.split("(")[0][:90], [0.0, 0.0])
                rec[0] += 1 / calls
                rec[1] += (e.time_range.end - e.time_range.start) / 1e3 / calls
        if out:
            return out
        log("[hold_scatter] the profiler saw no device event; tracing again")
    raise AssertionError(f"torch.profiler saw no device event in {tries} traces")


#: launches of the scatter the parent commit ran that no trace here makes:
#: its segment-sum kernel (one launch a call)
PARENT_KERNEL_LAUNCHES = 1


def scatter_launches(gi, g, m):
    """Device launches a call (torch.profiler) of the ordered scatter and
    of the parent commit's scatter, whose cast, ``torch.sort`` and zeroed
    output are traced here and whose own kernel adds
    ``PARENT_KERNEL_LAUNCHES``; fails unless the trace shows the
    scatter's kernels and it launches no more than the parent. Returns
    (launches, the parent's, {kernel: [launches, ms]} of each)."""
    import torch
    from level_s2fm_tpu_torch.fields import hash_scatter as hs
    ours = device_kernels(lambda: hs.scatter_cuda(gi, g, m))
    parent = device_kernels(lambda: (torch.sort(gi.to(torch.int32), stable=True),
                                     torch.zeros((m, g.shape[1]), device=g.device)))
    for kernel in ("digit_histogram_kernel", "onesweep_pass_kernel", "segment_sum_kernel"):
        assert any(k.startswith(kernel) for k in ours), (kernel, sorted(ours))
    launches = round(sum(v[0] for v in ours.values()), 3)
    parent_launches = round(sum(v[0] for v in parent.values()), 3) + PARENT_KERNEL_LAUNCHES
    assert launches <= parent_launches, (launches, parent_launches)
    return launches, parent_launches, ours, parent


def time_scatter(gi, g, m):
    """ms of the ordered scatter, of its parts (torch.profiler: the
    memset, the histogram, each sort pass, the sum) and its launches a
    call beside the parent commit's; of ``torch.sort`` of the keys (the
    parent's sort, a yardstick); of index_add_ (plain) and of index_put_
    with accumulate (library), and its bound; returns the record's
    numbers."""
    import torch
    from level_s2fm_tpu_torch import devtime
    from level_s2fm_tpu_torch.fields import hash_scatter as hs
    n, F = g.shape
    ms = devtime.time_ms(lambda: hs.scatter_cuda(gi, g, m), n=20)[0]
    sort_ms = devtime.time_ms(lambda: torch.sort(gi.to(torch.int32), stable=True), n=20)[0]
    launches, parent_launches, parts, parent_parts = scatter_launches(gi, g, m)
    plain_ms = devtime.time_ms(lambda: hs.scatter_plain(gi, g, m), n=20)[0]
    library_ms = devtime.time_ms(lambda: torch.zeros(m, F, device=g.device).index_put_(
        (gi,), g, accumulate=True), n=20)[0]
    bound, by = devtime.bound_ms(n * 8 + n * F * 4 + m * F * 4, n * F)
    table = lambda d: json.dumps({k: [round(a, 3), round(b, 6)] for k, (a, b) in d.items()})
    log(f"[hold_scatter] main: ordered {ms:.4f} ms, {launches:g} launches a call; "
        f"parts (launches, device ms a call): {table(parts)}; the parent's "
        f"{parent_launches:g} launches a call (its cast + torch.sort stable "
        f"{sort_ms:.4f} ms, its zeroed output, its kernel): {table(parent_parts)}; "
        f"index_add_ {plain_ms:.4f} ms, index_put_ accumulate {library_ms:.4f} ms, "
        f"bound {bound:.4f} ms ({by}; {bound / ms:.1%} of it)")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound, "bound_by": by}


def phase_hold_scatter():
    """``hold_scatter`` at the main path's shapes and at the edge shapes,
    then timed; returns the kernel's record (its launches are filled in
    from the main paths)."""
    import torch
    from level_s2fm_tpu_torch.fields import hash_scatter as hs
    dev = torch.device("cuda")
    cases = scatter_inputs(dev)
    cases.update(scatter_edge_cases(dev, hs.sort_tile()))
    err = hold_scatter(cases)
    t = time_scatter(*cases["main"])
    del cases
    torch.cuda.empty_cache()
    return {"name": "ordered_scatter", "route": "cuda",
            "source": "level_s2fm_tpu_torch/csrc/hash_scatter.cu",
            "replaces": "none: no TPU kernel (the JAX package's table cotangent is "
                        "XLA's transpose of level_s2fm_tpu/fields/hashgrid.py:190)",
            "launches": 0, "max_abs_err": err, **{k: t[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}


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

def phase_init(determinism=False):
    """The first main path: two-view init at full width. Returns (model,
    launch counts). Profiling runs on a copy of the parameters, so the
    model goes on to the register phase as the init left it. With
    ``determinism`` the steady step is also timed three ways
    (``_determinism_cost``)."""
    import numpy as np
    import torch
    from level_s2fm_tpu_torch.config import build_options
    from level_s2fm_tpu_torch.sfm.pipeline import LevelSfM
    from level_s2fm_tpu_torch.train import build_var

    steps = INIT_STEPS
    opt = build_options(FULL_WIDTH_ARGS + [f"--optim.init.max_iter={steps}",
                                           "--output_path=" + _out_dir("init")])
    model = LevelSfM(opt, seed=int(opt.seed), device="cuda")
    model.load_data(build_var(opt))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    model.train(max_views=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    SCATTER_SEEN.update(_scatter_shapes())

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
    if determinism:
        summary["determinism"] = _determinism_cost(
            init.phase, lambda: init.phase.init_state(_tree_to(model.params, "cuda")),
            batch, seed=1)
    log("[init] " + json.dumps(summary))
    return model, launches, summary


# --------------------------------------------------------------------------- register

def phase_register(model, determinism=False):
    """The second main path: the init phase's model registers views 3 to
    ``REGISTER_VIEWS`` at full width. Returns (launch counts, launch
    shapes)."""
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
    _reset_counts()
    t0 = time.perf_counter()
    ok = model.train(max_views=REGISTER_VIEWS, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    SCATTER_SEEN.update(_scatter_shapes())
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
    _profile_register(model, probes, determinism)
    return launches, shapes


def _profile_register(model, probes, determinism):
    """Steady ms per step (synchronised) and device-busy share of
    GeoInitPhase, BAPhase('sfm'), BAPhase('sfm_refine') and RefinePhase,
    each on a copy of the final parameters with its last call's batch;
    with ``determinism`` the render phases also three ways
    (``_determinism_cost``)."""
    import torch
    from level_s2fm_tpu_torch.sfm import bundle
    out = {}
    dev = torch.device("cuda")
    for stage, name in (("geo_init", "GeoInitPhase"), ("local_ba", "BAPhase sfm"),
                        ("sfm_refine", "BAPhase sfm_refine"), ("refine", "RefinePhase")):
        obj = probes[stage]
        batch = dict(obj.batch)
        if stage in ("geo_init", "refine"):
            def make_state(obj=obj):
                return obj.phase.init_state(_tree_to(model.params, dev))
        else:
            def make_state(obj=obj):
                return obj.phase.init_state(_ba_params(model, obj, dev),
                                            obj.xyzs0.clone())
        state = make_state()
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
        del state
        if determinism and stage != "local_ba":
            out[name]["determinism"] = _determinism_cost(obj.phase, make_state,
                                                         batch, seed=3)
        del batch
        torch.cuda.empty_cache()
    log("[register] steady steps " + json.dumps(out))


# --------------------------------------------------------------------------- bands

def phase_bands():
    """The 3-view fast run at configs/synthetic.yaml as it stands, twice
    from the same seed, back to back: the two runs must be equal bit for
    bit (every camera's se3, the point count, the final row), and held to
    2x the known-good final values and to the E2E oracles. Returns the
    first run's values and the launch counts of both."""
    import numpy as np
    runs, launches = [], {"fwd": 0, "bwd": 0, "scatter": 0}
    for name in ("bands", "bands_repeat"):
        _reset_counts()
        runs.append(_bands_run("cuda", _out_dir(name)))
        counts = _read_counts()
        SCATTER_SEEN.update(_scatter_shapes())
        launches = {k: v + counts[k] for k, v in launches.items()}
    a, b = runs
    same = {"se3": bool(np.array_equal(a["se3"], b["se3"])),
            "n_points": a["n_points"] == b["n_points"],
            "row": a["row"] == b["row"]}
    got = {k: a[k] for k in BANDS}
    log("[bands] " + json.dumps({"final": got, "ate": a["ate"], "known_good": BANDS,
                                 "factor": BANDS_FACTOR, "rel_rot_deg": a["rel_rot_deg"],
                                 "n_points": a["n_points"], "launches": launches,
                                 "wall_s": [r["wall_s"] for r in runs],
                                 "stage_s": a["stage_s"],
                                 "second_run_bitwise_equal": same}))
    assert a["ok"] and a["cam_ids"] == [0, 1, 2], a["cam_ids"]
    assert all(same.values()), (same, a["row"], b["row"])
    for k, v in BANDS.items():
        assert math.isfinite(got[k]) and got[k] <= BANDS_FACTOR * v, (k, got[k], v)
    assert a["rel_rot_deg"]["0-1"] < 5.0 and a["rel_rot_deg"]["0-2"] < 8.0, a["rel_rot_deg"]
    assert all(v > 0 for v in launches.values()), launches
    return {k: a[k] for k in ("reproj_px", "rot_err_deg", "t_err", "ate", "n_points")}, launches


def _side_train(argv):
    """``train.main(argv)`` in a side process: its rows (as text and as
    they are), summary, poses, the init's step count and wall, its wall,
    launches and launch shapes."""
    import numpy as np
    import torch
    from level_s2fm_tpu_torch import train
    from level_s2fm_tpu_torch.rendering import fused_composite as fc
    _reset_counts()
    t0 = time.perf_counter()
    m = train.main(argv)
    torch.cuda.synchronize()
    init = m.initializer
    return {"rows": [_row_text(r) for r in m.view_log], "view_log": m.view_log,
            "summary": getattr(m, "summary", None), "se3": m.camera_set.all_se3(),
            "pose_gt": np.stack([c.pose_gt for c in m.camera_set.cameras]),
            "init_steps": len(init._metrics["all"]) if init is not None else None,
            "init_wall": m.timers.totals.get("init"),
            "wall_s": time.perf_counter() - t0, "launches": _read_counts(),
            "shapes": {k: dict(v) for k, v in fc.SHAPES.items()},
            "scatter_shapes": _scatter_shapes()}


def _side_multiroom(marker):
    """Phase parallel (c)'s one-rank part: the multiroom init (then
    ``marker`` is written: its checkpoint is ready), then view 3 from its
    checkpoint. Returns {"mr_init", "mr_view3"}, runs as ``_side_train``
    gives them."""
    init_dir = _out_dir("parallel_multiroom_init")
    one = ["--parallel.data_devices=1"]
    try:
        init = _side_train(MULTIROOM_ARGS + one + ["--max_views=2",
                                                   "--output_path=" + init_dir])
    except BaseException:
        with open(marker, "w") as f:
            f.write("failed\n")
        raise
    with open(marker, "w") as f:
        f.write("ready\n")
    view3 = _side_train(MULTIROOM_ARGS + one + [
        "--load=" + os.path.join(init_dir, "model.ckpt"),
        "--output_path=" + _out_dir("parallel_multiroom_1")])
    return {"mr_init": init, "mr_view3": view3}


def _bands_run(device, out=os.path.join(REPO, "output", "chip_smoke", "parallel_bands")):
    """The bands run (3 views of configs/synthetic.yaml, fast mode) on
    ``device``, under the active group, into ``out``; returns its final
    values, relative rotations, final row and wall s."""
    import numpy as np
    import torch
    from level_s2fm_tpu_torch.config import build_options
    from level_s2fm_tpu_torch.geometry import lie
    from level_s2fm_tpu_torch.sfm.pipeline import LevelSfM
    from level_s2fm_tpu_torch.train import build_var
    opt = build_options(["--yaml=" + os.path.join(REPO, "configs", "synthetic.yaml"),
                         "--sfm_mode=fast", "--output_path=" + out])
    model = LevelSfM(opt, seed=int(opt.seed), device=device)
    model.load_data(build_var(opt))
    t0 = time.perf_counter()
    ok = model.train(max_views=3, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rot, t_err, ate = model.camera_set.eval_poses(verbose=False)
    poses, gt = model.camera_set.all_poses()
    p, g = torch.as_tensor(poses), torch.as_tensor(gt)
    rel = {}
    for i, j in ((0, 1), (0, 2)):
        r = lie.pose_compose_pair(lie.pose_invert(p[i]), p[j])
        r_gt = lie.pose_compose_pair(lie.pose_invert(g[i]), g[j])
        rel[f"{i}-{j}"] = float(np.rad2deg(float(lie.rotation_distance(
            r_gt[:3, :3], r[:3, :3]))))
    row = _row_text(model.view_log[-1])
    return {"ok": bool(ok), "cam_ids": list(model.camera_set.cam_ids),
            "reproj_px": model.view_log[-1]["reproj_px"], "rot_err_deg": rot,
            "t_err": t_err, "ate": ate, "n_points": len(model.point_set),
            "rel_rot_deg": rel, "wall_s": wall, "row": row,
            "stage_s": model.view_log[-1]["stage_s"], "se3": model.camera_set.all_se3()}


# --------------------------------------------------------------------------- scenes

#: the committed scenes the generators must reproduce, with the views
#: rendered: data/synthhard/scan1 is make_hard_scene_images(32, 400, 400)
#: (configs/synthhard.yaml), data/scannet/multiroom0 is
#: make_multiroom_scene(24, 384, 384)
HARD_SCENE = ("synthhard/scan1", 32, 400, (0, 17))
MULTIROOM_SCENE = ("scannet/multiroom0", 24, 384, (0, 12))
#: the committed preparations whose pose graphs the greedy order must give
PREPARED_SCENES = ("synthhard/scan1", "synthprep/scan1", "scannet/multiroom0")


def _lsb_diff(got, want, what):
    """Count the values of two uint arrays that differ; fail on any that
    differs by more than one least significant bit."""
    import numpy as np
    assert got.shape == want.shape and got.dtype == want.dtype, (
        what, got.shape, want.shape, got.dtype, want.dtype)
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    if d.ndim == 3:
        d = d.max(-1)
    rec = {"differing_pixels": int((d > 0).sum()), "max_lsb": int(d.max())}
    assert rec["max_lsb"] <= 1, (what, rec)
    return rec


def phase_scenes():
    """The generate and prepare steps a user takes before training, with
    the port alone (the GPU machine has no OpenCV or imageio): the port's
    generators re-render views of the committed hard and multiroom scenes
    and must reproduce their files; the greedy pose graph over each
    committed ``two_view.npy`` must be its ``pose_graph.npy``; a COLMAP
    database and model are written and read back, and the COLMAP backend
    runs on them with a mapper log."""
    import numpy as np
    from level_s2fm_tpu_torch.data import synthetic
    from level_s2fm_tpu_torch.data.base import sorted_images
    from level_s2fm_tpu_torch.preparation import colmap_db
    from level_s2fm_tpu_torch.preparation import main as prep
    from level_s2fm_tpu_torch.utils import colmap_model, png

    data = os.path.join(REPO, "data")
    out = {"render_s": {}, "hard": {}, "multiroom": {}}
    scene, n, size, views = HARD_SCENE
    K, poses = synthetic.hard_scene_cameras(n_views=n, H=size, W=size)
    for v in views:
        t0 = time.perf_counter()
        img = synthetic.render_hard_view(poses[v], K, size, size)
        out["render_s"][f"hard {v}"] = time.perf_counter() - t0
        got = (np.clip(img, 0, 1) * 255).astype(np.uint8)   # as the writer stores it
        want = png.read_png(os.path.join(data, scene, "images", f"{v:06d}.png"))
        out["hard"][v] = _lsb_diff(got, want, f"{scene} image {v}")
    scene, n, size, views = MULTIROOM_SCENE
    K, poses = synthetic.multiroom_cameras(n_views=n, H=size, W=size)
    for v in views:
        t0 = time.perf_counter()
        _, depth = synthetic.render_multiroom_view(poses[v], K, size, size)
        out["render_s"][f"multiroom {v}"] = time.perf_counter() - t0
        got = np.clip(depth * 1000.0, 0, 65535).astype(np.uint16)
        want = png.read_png(os.path.join(data, scene, "depth", f"{v:06d}.png"))
        out["multiroom"][v] = _lsb_diff(got, want, f"{scene} depth {v}")
    out["multiroom_color"] = ("not compared: the committed color frames are "
                              "JPEGs, which need Pillow or imageio; "
                              "tests/test_torch_port_scenes.py holds the "
                              "images bitwise")

    out["pose_graphs"] = {}
    for scene in PREPARED_SCENES:
        d = os.path.join(data, scene)
        n = len(sorted_images(prep.find_images_dir(d)))
        counts = np.zeros((n, n), np.int64)
        tv = np.load(os.path.join(d, "two_view.npy"), allow_pickle=True)[0]
        for (i, j), c in tv["counts"].items():
            counts[i, j] = counts[j, i] = c
        got = prep.greedy_pose_graph(counts)
        want = np.load(os.path.join(d, "pose_graph.npy"), allow_pickle=True).tolist()
        assert got == want, (scene, got, want)
        out["pose_graphs"][scene] = {"views": n, "equal": True}

    scene_dir = _out_dir("scenes")
    os.makedirs(os.path.join(scene_dir, "images"))
    ws = os.path.join(scene_dir, "colmap_ws")
    os.makedirs(os.path.join(ws, "sparse"))
    rng = np.random.default_rng(0)
    db = colmap_db.ColmapDatabase(os.path.join(ws, "database.db"))
    db.create_tables()
    cam = db.add_camera("PINHOLE", 64, 64, [57.6, 57.6, 32.0, 32.0])
    kps = {}
    for k in range(3):
        iid = db.add_image(f"{k:06d}.png", cam)
        kps[iid] = rng.uniform(0, 64, (40, 2)).astype(np.float32)
        db.add_keypoints(iid, kps[iid])
    matches = {}
    for i, j in ((1, 2), (3, 1), (2, 3)):
        m = np.stack([rng.permutation(40)[:25], rng.permutation(40)[:25]], 1)
        matches[(i, j)] = m
        db.add_matches(i, j, m)
        db.add_two_view_geometry(i, j, m[::2])
    db.commit()
    assert db.image_names() == {1: "000000.png", 2: "000001.png", 3: "000002.png"}
    for iid, kp in db.keypoints().items():
        assert np.array_equal(kp, kps[iid]), iid
    back = db.matches()
    for (i, j), m in matches.items():
        key, m = ((i, j), m) if i < j else ((j, i), m[:, ::-1])
        assert np.array_equal(back[key], m), key
    db.close()
    cams = {1: colmap_model.ColmapCamera(1, "PINHOLE", 64, 64,
                                         np.asarray([57.6, 57.6, 32.0, 32.0]))}
    images = {}
    for iid in (1, 3):     # image 2 left out of the model
        q = rng.normal(size=4)
        images[iid] = colmap_model.ColmapImage(
            iid, q / np.linalg.norm(q), rng.normal(size=3), 1, f"{iid - 1:06d}.png",
            rng.uniform(0, 64, (5, 2)), np.arange(5))
    pts = {p: colmap_model.ColmapPoint3D(p, rng.normal(size=3),
                                         np.asarray([10, 20, 30], np.uint8), 0.5,
                                         np.asarray([1, 3]), np.asarray([p, p]))
           for p in range(5)}
    model_dir = os.path.join(ws, "sparse", "0")
    for ext in (".txt", ".bin"):
        colmap_model.write_model(cams, images, pts, model_dir, ext=ext)
        rc, ri, rp = colmap_model.read_model(model_dir)
        assert sorted(ri) == [1, 3] and sorted(rp) == list(range(5)), ext
        for iid, im in images.items():
            assert np.array_equal(ri[iid].qvec, im.qvec) and ri[iid].name == im.name
            assert np.array_equal(ri[iid].xys, im.xys), (ext, iid)
        assert np.array_equal(rc[1].K(), [[57.6, 0, 32], [0, 57.6, 32], [0, 0, 1]])
        if ext == ".txt":       # the .bin model stays for the backend
            for name in ("cameras", "images", "points3D"):
                os.remove(os.path.join(model_dir, name + ext))
    with open(os.path.join(scene_dir, "mapper.log"), "w") as f:
        f.write("Initializing with image pair #3 and #2\n"
                "Registering image #1 (3)\n")
    kypts, pair_matches, pose_graph = prep.run_colmap_backend(scene_dir)
    # the log's order (3, 2, 1) less image 2, which left the model,
    # then the views the model lacks: image ids 3, 1 are views 2, 0
    assert pose_graph == [2, 0, 1], pose_graph
    assert sorted(pair_matches) == [(0, 1), (0, 2), (1, 2)]
    for m, mask in pair_matches.values():
        assert mask.sum() == 13 and len(m) == 25, (len(m), mask.sum())
    out["colmap"] = {"pose_graph": pose_graph,
                     "inliers": {f"{i}-{j}": int(mask.sum())
                                 for (i, j), (_, mask) in pair_matches.items()}}
    log("[scenes] " + json.dumps(out))


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
    scene, alone on the card: five views with a checkpoint after each, a
    fresh engine that resumes and registers the sixth, then
    ``--get_result`` with a refine over every camera and the export.
    Returns (launch counts, launch shapes, the first view's row as text
    for ``check_prepared_repeat``)."""
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
    launches = {"fwd": 0, "bwd": 0, "scatter": 0}
    shapes = {"fwd": {}, "bwd": {}}

    def run(name, argv):
        _reset_counts()
        t0 = time.perf_counter()
        m = train.main(argv)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        counts = _read_counts()
        SCATTER_SEEN.update(_scatter_shapes())
        for k in launches:
            launches[k] += counts[k]
        for k in shapes:
            for s, n in fc.SHAPES[k].items():
                shapes[k][s] = shapes[k].get(s, 0) + n
        log(f"[prepared] {name}: {walls[name]:.1f} s, launches "
            + json.dumps(counts) + " by (R, K) "
            + json.dumps({k: {f"{R}x{K}": n for (R, K), n in v.items()}
                          for k, v in fc.SHAPES.items()}))
        return m

    # 1. the first views, a checkpoint after each
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

    first_row = _row_text(rows[0])

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
    assert all(v > 0 for v in launches.values()), launches
    return launches, shapes, first_row


def check_prepared_repeat(first_row, rep):
    """A second engine's init and first view of phase prepared (run by
    ``_side_train`` in the checks' side process): its row must repeat the
    first engine's bit for bit. Returns (its launch counts, launch
    shapes)."""
    second = rep["rows"][0]
    differing = {k: [first_row[k], second.get(k)] for k in first_row
                 if first_row[k] != second.get(k)}
    log("[prepared] first-view row repeated by a second engine: " + json.dumps(
        {"repeats": not differing, "differing": differing,
         "launches": rep["launches"]}))
    assert not differing, differing
    SCATTER_SEEN.update(rep["scatter_shapes"])
    return rep["launches"], rep["shapes"]


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
    _reset_counts()
    t0 = time.perf_counter()
    model.train(max_views=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    SCATTER_SEEN.update(_scatter_shapes())
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
    _reset_counts()
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
        "stage_s": m.view_log[-1]["stage_s"], "launches": _read_counts()}))
    assert len(m.point_set) > 30 and med < 0.1, (len(m.point_set), med)
    for k, v in TRAD_SPREAD["max"].items():
        assert math.isfinite(got[k]) and got[k] <= TRAD_FACTOR * v, (k, got[k], v)
    assert fc.LAUNCHES == {"fwd": 0, "bwd": 0}, fc.LAUNCHES
    trad_scatter = _read_counts()["scatter"]
    assert trad_scatter > 0, "the ordered scatter did not launch in the trad run"
    SCATTER_SEEN.update(_scatter_shapes())
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
    _reset_counts()
    t0 = time.perf_counter()
    m = train.main(TRI_TRAD_ARGS + ["--max_views=3",
                                    "--output_path=" + _out_dir("tri_trad_full")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    SCATTER_SEEN.update(_scatter_shapes())
    launches["scatter"] += trad_scatter
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


def _atomic_scatter():
    """A context in which the hash grid's table cotangent is summed by
    ``index_add_`` with the card's float atomics (the port's version
    before the ordered scatter): the smoke's own switch for
    ``--determinism``'s comparison; the package has none."""
    import contextlib
    from level_s2fm_tpu_torch.fields import hash_scatter as hs

    @contextlib.contextmanager
    def ctx():
        kept = hs.ordered_scatter_add
        hs.ordered_scatter_add = hs.scatter_plain
        try:
            yield
        finally:
            hs.ordered_scatter_add = kept
    return ctx()


def _determinism_cost(phase, make_state, batch, seed, n=10):
    """Steady ms per step of ``phase`` three ways, each from a fresh
    state of the same parameters (``make_state()``): with the ordered
    scatter (the port), with ``index_add_``'s atomics, and under
    ``torch.use_deterministic_algorithms`` (with the ordered scatter);
    2 warm-up steps, then ``n`` timed (synchronised)."""
    import contextlib
    import torch
    out = {}
    for name in ("ms", "ms_atomics", "ms_deterministic"):
        ctx = _atomic_scatter() if name == "ms_atomics" else contextlib.nullcontext()
        torch.use_deterministic_algorithms(name == "ms_deterministic", warn_only=True)
        try:
            with ctx:
                state = make_state()
                gen = torch.Generator().manual_seed(seed)
                for _ in range(2):
                    phase.step(state, batch, gen)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(n):
                    phase.step(state, batch, gen)
                torch.cuda.synchronize()
                out[name] = (time.perf_counter() - t0) / n * 1e3
        finally:
            torch.use_deterministic_algorithms(False)
        del state
        torch.cuda.empty_cache()
    out["ratio_to_atomics"] = out["ms"] / out["ms_atomics"]
    out["deterministic_ratio_to_atomics"] = out["ms_deterministic"] / out["ms_atomics"]
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


# --------------------------------------------------------------------------- parallel

def _init_step(device, steady_steps):
    """(a) at full width on ``device`` under the active group: one init
    step from the seed's parameters and draws
    algorithms (its losses and parameters), then the steady ms per step
    over ``steady_steps`` more, and, under a group, the ms of one
    all-reduce of the step's gradients."""
    import torch
    from level_s2fm_tpu_torch.config import build_options
    from level_s2fm_tpu_torch.parallel import distributed as pdist
    from level_s2fm_tpu_torch.parallel import mesh as pmesh
    from level_s2fm_tpu_torch.sfm import bundle
    from level_s2fm_tpu_torch.sfm.initialization import Initializer
    from level_s2fm_tpu_torch.sfm.optim import tree_leaves
    from level_s2fm_tpu_torch.sfm.pipeline import LevelSfM
    from level_s2fm_tpu_torch.train import _digest, build_var
    opt = build_options(FULL_WIDTH_ARGS + [
        "--output_path=" + os.path.join(REPO, "output", "chip_smoke", "parallel_init")])
    m = LevelSfM(opt, seed=int(opt.seed), device=device)
    var = build_var(opt)
    m.load_data(var)
    init = Initializer(opt, m.cfgs, m.camera_set, m.point_set, _init_var(var),
                       device=device)
    state = init.phase.init_state(m.params)
    batch = dict(init.batch)
    batch["occ"] = bundle.maybe_build_occ(opt, m.cfgs, state["params"])
    gen = torch.Generator().manual_seed(1)
    met = init.phase.step(state, batch, gen)
    params = [p.detach().cpu().numpy() for p in tree_leaves(state["params"])]
    out = {"losses": {k: float(v) for k, v in met.items()}, "params": params,
           "digest": _digest(params)}
    init.phase.step(state, batch, gen)
    pdist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steady_steps):
        init.phase.step(state, batch, gen)
    torch.cuda.synchronize()
    out["ms_per_step"] = (time.perf_counter() - t0) / steady_steps * 1e3
    if pmesh.get_group() is not None:
        grads = [torch.ones_like(p) for p in state["opt"].leaves]
        pdist.all_reduce_grads(grads)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steady_steps):
            pdist.all_reduce_grads(grads)
        torch.cuda.synchronize()
        out["allreduce_ms"] = (time.perf_counter() - t0) / steady_steps * 1e3
        out["allreduce_mib"] = sum(g.numel() * g.element_size() for g in grads) / 2 ** 20
    return out


def _parallel_rank(parts, multiroom_argv=None, marker=None):
    """One rank of phase parallel, running ``parts`` of: (a)
    ``init_step``, the init step; (b) ``bands``, the bands run; (c)
    ``multiroom``, view 3 of configs/scannet_multiroom_synth.yaml from
    the one-rank init's checkpoint (once ``marker`` exists) through
    ``train._rank_run`` (the function ``train.main`` launches); with the
    kernels' launches of each part."""
    import torch
    from level_s2fm_tpu_torch import train
    from level_s2fm_tpu_torch.parallel import distributed as pdist
    from level_s2fm_tpu_torch.parallel import mesh as pmesh
    from level_s2fm_tpu_torch.rendering import fused_composite as fc
    group = pmesh.get_group()
    out = {"rank": group.rank, "device": str(group.device), "launches": {},
           "shapes": {}, "scatter_shapes": {}}
    run = {"init_step": lambda: _init_step(group.device, PARALLEL_STEADY_STEPS),
           "bands": lambda: _bands_run(group.device),
           "multiroom": lambda: train._rank_run(multiroom_argv)}
    for name in parts:
        if name == "multiroom":
            _wait_for(marker)
            with open(marker) as f:
                assert f.read().strip() == "ready", "the one-rank multiroom init failed"
        _reset_counts()
        t0 = time.perf_counter()
        out[name] = run[name]()
        torch.cuda.synchronize()
        out[name]["wall_s"] = time.perf_counter() - t0
        out["launches"][name] = _read_counts()
        out["shapes"][name] = {k: dict(v) for k, v in fc.SHAPES.items()}
        out["scatter_shapes"].update(_scatter_shapes())
        pdist.barrier()
    if group.rank and "init_step" in parts:
        out["init_step"]["params"] = None
    return out


def _parallel_devices():
    """(devices, backend) of the ranks: one per card over NCCL where
    PARALLEL_RANKS cards are visible, else all on card 0 over gloo."""
    import torch
    from level_s2fm_tpu_torch.parallel import distributed as pdist
    n_gpu = torch.cuda.device_count()
    devices = ([f"cuda:{i}" for i in range(PARALLEL_RANKS)] if n_gpu >= PARALLEL_RANKS
               else ["cuda:0"] * PARALLEL_RANKS)
    return devices, pdist.default_backend(devices)


def _side_ranks(marker):
    """Phase parallel's (b) and (c) at PARALLEL_RANKS ranks ((c) starts
    once ``_side_multiroom`` has written ``marker``). Returns {"ranks",
    "launch_s"}."""
    from level_s2fm_tpu_torch.parallel import distributed as pdist
    devices, backend = _parallel_devices()
    argv2 = MULTIROOM_ARGS + [
        "--load=" + os.path.join(REPO, "output", "chip_smoke", "parallel_multiroom_init",
                                 "model.ckpt"),
        "--output_path=" + _out_dir("parallel_multiroom_2")]
    t0 = time.perf_counter()
    ranks = pdist.launch(_parallel_rank, devices, backend,
                         args=(("bands", "multiroom"), argv2, marker))
    return {"ranks": ranks, "launch_s": time.perf_counter() - t0}


def start_checks():
    """The runs that check a main path but whose walls are not read, in
    three side processes (spawn; each loads the libraries this process
    built) that share the card with the phases after phase prepared:
    phase prepared's second engine (its init and first view), phase
    parallel (c)'s one-rank runs, and (b) and (c) at the ranks. Returns
    (pool, futures); ``finish_checks`` collects them."""
    import multiprocessing
    marker = os.path.join(_out_dir("checks"), "multiroom_init.ready")
    os.makedirs(os.path.dirname(marker))
    pool = concurrent.futures.ProcessPoolExecutor(
        3, mp_context=multiprocessing.get_context("spawn"))
    futs = {"prepared_repeat": pool.submit(_side_train, PREPARED_ARGS + [
                "--output_path=" + _out_dir("prepared_repeat"), "--max_views=3"]),
            "multiroom": pool.submit(_side_multiroom, marker),
            "ranks": pool.submit(_side_ranks, marker)}
    return pool, futs


def finish_checks(pool, futs):
    """The results of ``start_checks``' runs (a run's failure is raised
    here): {"prepared_repeat", "mr_init", "mr_view3", "ranks",
    "launch_s"}."""
    t0 = time.perf_counter()
    try:
        out = {"prepared_repeat": futs["prepared_repeat"].result(),
               **futs["multiroom"].result(), **futs["ranks"].result()}
    finally:
        pool.shutdown(cancel_futures=True)
    log(f"[checks] waited {time.perf_counter() - t0:.1f} s for the side processes")
    return out


def _close(name, got, ref, bounds):
    """The final values of a run at several ranks against one rank's."""
    diffs = {k: abs(got[k] - ref[k]) for k in bounds}
    n_ok = abs(got["n_points"] - ref["n_points"]) <= max(8, 0.15 * ref["n_points"])
    log(f"[parallel] {name}: |ranks - one rank| " + json.dumps(diffs)
        + f" points {got['n_points']} vs {ref['n_points']}")
    for k, b in bounds.items():
        assert math.isfinite(got[k]) and diffs[k] < b, (name, k, got[k], ref[k], b)
    assert n_ok, (name, got["n_points"], ref["n_points"])


def phase_parallel(bands_ref, side):
    """Data-parallel ranks on the card (``parallel.distributed.launch``,
    the path ``train.main`` takes): with one visible GPU, PARALLEL_RANKS
    ranks share it over gloo; with more, one rank per card over NCCL.
    (a) here, alone on the card: one full-width init step at the ranks
    against one rank (losses, parameters, the ranks bitwise equal) and
    the steady ms per step at each world. ``side`` holds the runs of
    ``start_checks``, which went on beside the phases after phase
    prepared: (b) the bands run at the ranks, held to the bands and to
    the 1-vs-8 bounds against phase bands' one rank; (c) the multiroom
    config's init at one rank, then its view 3 from that checkpoint at
    one rank and at the ranks, both under MULTIROOM_MAX_REPROJ_PX, held
    to the 1-vs-8 bounds. Returns (launch counts, launch shapes) summed
    over the ranks and the one-rank runs."""
    import numpy as np
    import torch
    from level_s2fm_tpu_torch.parallel import distributed as pdist
    from level_s2fm_tpu_torch.rendering import fused_composite as fc

    devices, backend = _parallel_devices()
    log(f"[parallel] {PARALLEL_RANKS} ranks on {devices} over {backend} "
        f"({torch.cuda.device_count()} visible GPU(s))")
    _reset_counts()
    one = _init_step(torch.device("cuda"), PARALLEL_STEADY_STEPS)
    launches = _read_counts()
    shapes = {k: dict(v) for k, v in fc.SHAPES.items()}
    SCATTER_SEEN.update(_scatter_shapes())
    ranks_a = pdist.launch(_parallel_rank, devices, backend, args=(("init_step",),))
    mr_init, mr_view3, ranks = side["mr_init"], side["mr_view3"], side["ranks"]
    for run in (mr_init, mr_view3):
        SCATTER_SEEN.update(run["scatter_shapes"])
        for k in launches:
            launches[k] += run["launches"][k]
        for k in shapes:
            for sh, n in run["shapes"][k].items():
                shapes[k][sh] = shapes[k].get(sh, 0) + n
    for r in ranks_a + ranks:
        SCATTER_SEEN.update(r["scatter_shapes"])
        for part in r["launches"].values():
            for k in launches:
                launches[k] += part[k]
        for part in r["shapes"].values():
            for k, v in part.items():
                for shape, n in v.items():
                    shapes[k][shape] = shapes[k].get(shape, 0) + n
    for r in ranks_a + ranks:
        for name in ("init_step", "bands"):
            if name in r["launches"]:
                n = r["launches"][name]
                assert all(v > 0 for v in n.values()), (r["rank"], name, n)

    # (a)
    r0 = ranks_a[0]["init_step"]
    assert len({r["init_step"]["digest"] for r in ranks_a}) == 1, "ranks differ"
    loss_err = {k: abs(r0["losses"][k] - v) / max(abs(v), 1e-30)
                for k, v in one["losses"].items()}
    param_err = max(float(np.abs(a - b).max()) for a, b in zip(r0["params"], one["params"]))
    log("[parallel] (a) init step at full width: "
        + json.dumps({"loss_rel_err": loss_err, "param_max_abs_err": param_err,
                      "ranks_bitwise_equal": True,
                      "ms_per_step": {"1": one["ms_per_step"],
                                      str(PARALLEL_RANKS): r0["ms_per_step"]},
                      "allreduce_ms": r0["allreduce_ms"],
                      "allreduce_mib": r0["allreduce_mib"],
                      "launches_per_rank": [r["launches"]["init_step"] for r in ranks_a]}))
    for k, e in loss_err.items():
        assert e <= PARALLEL_LOSS_RTOL, (k, r0["losses"][k], one["losses"][k])
    assert param_err <= PARALLEL_PARAM_ATOL, param_err

    # (b)
    b = ranks[0]["bands"]
    assert all(np.array_equal(r["bands"]["se3"], b["se3"]) for r in ranks)
    assert b["ok"] and b["cam_ids"] == [0, 1, 2], b["cam_ids"]
    log("[parallel] (b) bands at the ranks, in the checks' side processes: "
        + json.dumps({k: v for k, v in b.items() if k != "se3"}))
    for k, v in BANDS.items():
        assert math.isfinite(b[k]) and b[k] <= BANDS_FACTOR * v, (k, b[k], v)
    assert b["rel_rot_deg"]["0-1"] < 5.0 and b["rel_rot_deg"]["0-2"] < 8.0
    _close("(b) bands", b, bands_ref, WORLD_BOUNDS)

    # (c)
    c = ranks[0]["multiroom"]
    assert len({r["multiroom"]["params_digest"] for r in ranks}) == 1, "ranks differ"
    multi1 = mr_view3
    s1, s2 = multi1["summary"], c["summary"]
    assert s1["ok"] and s2["ok"] and len(s1["registered"]) == len(s2["registered"]) == 3
    assert c["cam_ids"] == [int(i) for i in s1["registered"]], c["cam_ids"]

    def row(s, se3):
        return {"reproj_px": s["reproj_px"], "rot_err_deg": s["rot_error_deg"],
                "t_err": s["t_error"], "ate": s["ate"], "n_points": s["n_points"],
                "rel_rot_deg": _rel_rot_deg(se3, multi1["pose_gt"])}
    r1, r2 = row(s1, multi1["se3"]), row(s2, c["se3"])
    init_steps = mr_init["init_steps"]
    log("[parallel] (c) multiroom, in the checks' side processes: " + json.dumps({
        "init_one_rank": {"wall_s": mr_init["wall_s"], "init_steps": init_steps,
                          "init_ms_per_step": mr_init["init_wall"] / init_steps * 1e3},
        "one_rank": {**r1, "wall_s": mr_view3["wall_s"],
                     "stage_s": [v["stage_s"] for v in multi1["view_log"]]},
        "ranks": {**r2, "wall_s": c["wall_s"],
                  "stage_s": [v["stage_s"] for v in c["view_log"]]},
        "launch_s": side["launch_s"]}))
    for r in (r1, r2):
        assert r["reproj_px"] < MULTIROOM_MAX_REPROJ_PX, ("(c) not converged", r)
    _close("(c) multiroom", r2, r1,
           {k: v for k, v in WORLD_BOUNDS.items() if k != "rot_err_deg"})
    for pair, deg in r2["rel_rot_deg"].items():
        diff = abs(deg - r1["rel_rot_deg"][pair])
        assert diff < WORLD_BOUNDS["rot_err_deg"], ("(c) multiroom", pair, deg, diff)
    return launches, shapes


def _rel_rot_deg(se3, pose_gt):
    """Rotation error (deg) of the relative poses of the camera pairs
    (0, 1) and (0, 2) against GT: no sim(3) alignment needed."""
    import numpy as np
    import torch
    from level_s2fm_tpu_torch.geometry import lie
    p = lie.se3_to_SE3(torch.as_tensor(np.asarray(se3, np.float32)))
    g = torch.as_tensor(np.asarray(pose_gt, np.float32))
    out = {}
    for i, j in ((0, 1), (0, 2)):
        rel = lie.pose_compose_pair(lie.pose_invert(p[i]), p[j])
        rel_gt = lie.pose_compose_pair(lie.pose_invert(g[i]), g[j])
        out[f"{i}-{j}"] = float(np.rad2deg(float(lie.rotation_distance(
            rel_gt[:3, :3], rel[:3, :3]))))
    return out


# --------------------------------------------------------------------------- main

# --------------------------------------------------------------------------- tools

#: phase ab: the A/B's training steps per arm (its default 300, cut to fit
#: the time limit) at its full width (--hw 128, --rays 2048)
AB_STEPS = 60


def _card_line():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def phase_ab():
    """``python -m level_s2fm_tpu_torch.ab_adaptive_sampler`` at its full
    width with AB_STEPS steps an arm: rays/s, held-out PSNR and train s
    per arm. Returns (launch counts, K1/K2 launch shapes)."""
    from level_s2fm_tpu_torch import ab_adaptive_sampler
    from level_s2fm_tpu_torch.rendering import fused_composite as fc
    out = os.path.join(_out_dir("ab"), "ab_adaptive_sampler.json")
    _reset_counts()
    t0 = time.perf_counter()
    res = ab_adaptive_sampler.main([f"--steps={AB_STEPS}", "--out", out])
    wall = time.perf_counter() - t0
    launches = _read_counts()
    SCATTER_SEEN.update(_scatter_shapes())
    shapes = {k: dict(v) for k, v in fc.SHAPES.items()}
    with open(out) as f:
        written = json.load(f)
    log("[ab] " + json.dumps({
        "card": _card_line(), "steps": AB_STEPS, "rays": 2048, "hw": 128,
        "arms": {m: {k: v for k, v in r.items() if k != "losses"} | {
            "loss_first": r["losses"][0], "loss_last": r["losses"][-1]}
                 for m, r in res.items()},
        "wall_s": wall, "launches": launches,
        "launch_shapes": {k: {f"{R}x{K}": n for (R, K), n in v.items()}
                          for k, v in shapes.items()}}))
    assert written["backend"] == "gpu" and set(written["results"]) == set(res)
    for m, r in res.items():
        assert all(math.isfinite(x) for x in r["losses"]), m
        assert math.isfinite(r["psnr_heldout_fg"]) and r["rays_per_s"] > 0, (m, r)
    assert all(v > 0 for v in launches.values()), launches
    return launches, shapes


def phase_diag():
    """``python -m level_s2fm_tpu_torch.diag_frontier_pnp`` on the
    checkpoint phase prepared leaves, on the card and with ``--cpu``: a
    row for every unregistered view, pairs >= gated >= every inlier
    count, and the CPU's pairs and gated counts equal to the card's."""
    from level_s2fm_tpu_torch import diag_frontier_pnp as diag
    run_dir = os.path.join(REPO, "output", "chip_smoke", "prepared")
    t0 = time.perf_counter()
    card = diag.sweep(run_dir, PREPARED_ARGS)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = diag.sweep(run_dir, PREPARED_ARGS + ["--cpu"])
    t_cpu = time.perf_counter() - t0
    log(f"[diag] registered {card['registered']}, unregistered {card['unregistered']}, "
        f"SDF gate {card['sdf_gate']}; card {t_card:.1f} s, --cpu {t_cpu:.1f} s")
    log("[diag] view pairs gated " + " ".join(f"in@{g}px" for g in diag.GATES))
    for row in card["rows"]:
        log("[diag] " + diag.format_row(row))
    assert card["device"] == "cuda" and cpu["device"] == "cpu"
    assert card["unregistered"] and [r["view"] for r in card["rows"]] == card["unregistered"]
    for row in card["rows"]:
        assert row["pairs"] >= row["gated"] >= max(row["inliers"] or [0]), row
    pg = lambda out: [(r["view"], r["pairs"], r["gated"]) for r in out["rows"]]  # noqa: E731
    assert pg(card) == pg(cpu), (pg(card), pg(cpu))


def phase_demo():
    """``python -m level_s2fm_tpu_torch.two_view_init_demo`` at its
    default ``--iters 200``: the pose errors and the files written.
    Returns (launch counts, K1/K2 launch shapes)."""
    import numpy as np
    from level_s2fm_tpu_torch import two_view_init_demo
    from level_s2fm_tpu_torch.rendering import fused_composite as fc
    _reset_counts()
    t0 = time.perf_counter()
    res = two_view_init_demo.main(["--out", _out_dir("demo")])
    wall = time.perf_counter() - t0
    launches = _read_counts()
    SCATTER_SEEN.update(_scatter_shapes())
    shapes = {k: dict(v) for k, v in fc.SHAPES.items()}
    sizes = {os.path.relpath(p, REPO): os.path.getsize(p) for p in res["written"]}
    log("[demo] " + json.dumps({"rot_error_deg": res["rot_error_deg"],
                                "t_error_deg": res["t_error_deg"], "files": sizes,
                                "wall_s": wall, "launches": launches}))
    assert len(sizes) == 8 and all(v > 0 for v in sizes.values()), sizes
    assert np.isfinite([res["rot_error_deg"], res["t_error_deg"]]).all()
    assert all(v > 0 for v in launches.values()), launches
    return launches, shapes


def main(argv=None):
    import argparse
    import torch
    ap = argparse.ArgumentParser(description="Smoke test of the port on one GPU.")
    ap.add_argument("--determinism", action="store_true",
                    help="also time the render phases three ways: with the "
                         "ordered scatter, with index_add_'s atomics and "
                         "under deterministic algorithms")
    det = ap.parse_args(argv).determinism
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
    scatter = phase_hold_scatter()
    recs.append(scatter)
    phase_adapter()
    phase_reference()
    log(f"[time] {time.time() - t_start:.1f} s")

    def held(tag, launches, shapes):
        """Adds a main path's launches to the records and holds K1/K2 at
        every shape it launched."""
        shapes = sorted(set(shapes.get("fwd", {})) | set(shapes.get("bwd", {})))
        err = hold_composite(shapes, torch.device("cuda"), tag=f"{tag} kernels")
        for rec, kind in zip(recs, ("fwd", "bwd")):
            rec["launches"] += launches[kind]
            rec["max_abs_err"] = max(rec["max_abs_err"], err[kind])
        scatter["launches"] += launches["scatter"]
        log(f"[launches] {tag} " + json.dumps(launches))
        log(f"[time] {time.time() - t_start:.1f} s")

    model, launches, init_summary = phase_init(det)
    held("init", launches, {})
    reg_launches, reg_shapes = phase_register(model, det)
    del model
    torch.cuda.empty_cache()
    held("register", reg_launches, reg_shapes)
    prep_launches, prep_shapes, prep_row = phase_prepared()
    held("prepared", prep_launches, prep_shapes)
    # the checks' runs share the card with the phases from here on
    pool, futs = start_checks()
    bands_ref, bands_launches = phase_bands()
    held("bands", bands_launches, {})
    phase_scenes()
    phase_diag()
    held("options", *phase_options(init_summary))
    held("ablations", *phase_ablations())
    held("ab", *phase_ab())
    held("demo", *phase_demo())
    checks = finish_checks(pool, futs)
    held("prepared repeat", *check_prepared_repeat(prep_row, checks["prepared_repeat"]))
    held("parallel", *phase_parallel(bands_ref, checks))
    err = 0.0
    for name, case in scatter_at_shapes(list(SCATTER_SEEN), torch.device("cuda")):
        err = max(err, hold_scatter({name: case}, tag="hold_scatter seen"))
    scatter["max_abs_err"] = max(scatter["max_abs_err"], err)
    log(f"[hold_scatter] held at all {len(SCATTER_SEEN)} (n, m, F) shapes launched "
        f"on the main paths, with random keys: max_abs_err {err}")
    (_, (gi, g, m)), = scatter_at_shapes([min(SCATTER_SEEN)], torch.device("cuda"))
    launches, parent_launches, parts, _ = scatter_launches(gi, g, m)
    log(f"[hold_scatter] smallest launched shape n={gi.numel()} m={m} F={g.shape[1]}: "
        f"{launches:g} launches a call (the parent's: {parent_launches:g}, no fewer): "
        + json.dumps({k: [round(a, 3), round(b, 6)] for k, (a, b) in parts.items()}))
    log(f"[done] {time.time() - t_start:.1f} s")

    print(_card_line())
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in recs]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
