"""CLI entry of the port: incremental neural SfM on the GPU.

    python -m level_s2fm_tpu_torch.train --yaml=configs/<cfg>.yaml \
        [--sfm_mode=fast] [--max_views=N] [--output_path=DIR] [--cpu]
        [--resume | --load=CKPT] [--get_result [--refine_again]
        [--refine_again_iters=N]] [--parallel.data_devices=N|all]

Same options as the JAX package's ``train.py`` (dot-path overrides,
``--flag`` / ``--flag!``). Runs on ``cuda`` unless ``--cpu`` is given and
raises when no GPU is there. The scene is the synthetic sphere
(``data.dataset: synthetic``, built from ``--seed``) or a prepared scene
of any dataset in ``data.loaders.LOADERS`` (DTU, ETH3D, BlendedMVS,
ScanNet). Writes ``options.yaml``, ``metrics.jsonl`` and the checkpoints
under ``output_path`` (default ``output_root/group/name``).

- A run: ``LevelSfM.train`` — the two-view initialization, then every
  further view (up to ``--max_views``) through PnP, geoinit, the BA
  cycles and, in ``full`` mode, the rendering refine; with
  ``Ablate_config.refine_again`` a final refine over all views follows.
- ``--resume`` restores ``output_path/model.ckpt`` (parameters, cameras,
  points, the last phase's optimizer state) and goes on registering;
  ``--load=CKPT`` restores another checkpoint the same way.
- ``--get_result`` restores the checkpoint, optionally refines again over
  every camera (``--refine_again``, ``--refine_again_iters``, default
  10000) and saves it, then writes the results (``export_results``: mesh,
  point cloud, cameras, COLMAP model, viewer page, a render).

Data-parallel ranks (``parallel``): ``--parallel.data_devices=N|all``
starts one rank per visible GPU (NCCL), or N ranks on the CPU under
``--cpu`` (gloo), and checks at the end that every rank holds the same
poses and parameters; under torchrun (``WORLD_SIZE`` > 1) this process
is one rank of the given world. Empty or 1: one rank, no process group.

Prints the init summary, one metrics row per registered view and a final
summary with the registered and skipped views (rank 0).
"""
from __future__ import annotations

import os
import sys
import time


def build_var(opt):
    """The scene as the pipeline's ``var`` dict."""
    if opt.data.get("dataset") == "synthetic":
        from .data import synthetic
        scene = synthetic.make_scene(
            n_views=int(opt.data.get("n_views", 4)),
            H=opt.data.image_size[0], W=opt.data.image_size[1],
            n_points=int(opt.data.get("n_points", 256)),
            seed=int(opt.get("seed", 0)))
        return synthetic.scene_to_var(scene)
    from .data import loaders
    return loaders.load_prepared_scene(opt)


def data_devices(opt):
    """The devices of the data-parallel ranks that ``parallel.data_devices``
    asks for, or None for one rank with no process group (empty or 1,
    and ``all`` with one visible device). N or ``all`` is one rank per
    visible GPU (over NCCL); under ``--cpu``, N ranks on the CPU (over
    gloo), as the JAX package's ``--cpu`` runs its mesh on CPU devices;
    ``all`` under ``--cpu`` is one. Asking for more GPUs than are visible
    raises: a run never quietly takes fewer ranks."""
    import torch
    pd = opt.get("parallel", None)
    pd = pd.get("data_devices") if pd else None
    if not pd:
        return None
    cpu = bool(opt.get("cpu", False))
    visible = 0 if cpu else torch.cuda.device_count()
    if str(pd) == "all":
        n = 1 if cpu else visible
    else:
        n = int(pd)
        if not cpu and n > visible:
            raise ValueError(
                f"parallel.data_devices={pd} asks for {n} GPUs and {visible} "
                "are visible; run with fewer ranks, or under --cpu for gloo "
                "ranks on the CPU")
    if n <= 1:
        return None
    return ["cpu"] * n if cpu else [f"cuda:{i}" for i in range(n)]


def main(argv=None):
    """One rank: the engine's model. Several (``parallel.data_devices``):
    rank 0's summary (``_rank_run``), after checking that every rank
    ended with the same poses and parameters. Under torchrun's
    environment this process is one rank of the given world."""
    argv = sys.argv[1:] if argv is None else argv
    from .config import build_options, save_options_file
    from .parallel import distributed as pdist
    from .parallel import mesh as pmesh
    opt = build_options(argv)
    group = pdist.initialize_multihost(cpu=bool(opt.get("cpu", False)))
    devices = None if group is not None else data_devices(opt)
    with pmesh.use_group(group):
        if pdist.is_primary():
            os.makedirs(opt.output_path, exist_ok=True)
            save_options_file(opt)
        if group is not None:
            return _rank_run(argv)
    if devices is None:
        return _run(opt)
    ranks = pdist.launch(_rank_run, devices, args=(argv,))
    digests = {k: [r[k] for r in ranks] for k in ("se3_digest", "params_digest")}
    equal = all(len(set(v)) == 1 for v in digests.values())
    print({"ranks": len(ranks), "backend": pdist.default_backend(devices),
           "replicas_equal": equal, **digests})
    if not equal:
        raise RuntimeError(f"the ranks' replicas differ: {digests}")
    return ranks[0]


def _digest(arrays) -> str:
    import hashlib
    import numpy as np
    h = hashlib.sha1()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def _rank_run(argv):
    """One data-parallel rank of ``main`` (run under its active group):
    the engine's run, and a picklable summary of it: the final row, the
    view rows, the init's last losses, the cameras, digests of the poses
    and the field parameters, and the composite kernels' launches."""
    from .config import build_options
    from .rendering import fused_composite as fc
    from .sfm.optim import tree_leaves
    opt = build_options(argv)
    model = _run(opt)
    init = model.initializer
    m = getattr(init, "_metrics", None) if init is not None else None
    se3 = model.camera_set.all_se3() if len(model.camera_set) else []
    return {
        "summary": getattr(model, "summary", None),
        "view_log": model.view_log,
        "init_last": None if m is None else {k: float(v[-1]) for k, v in m.items()},
        "cam_ids": list(model.camera_set.cam_ids),
        "se3": se3,
        "se3_digest": _digest([se3]),
        "params_digest": _digest([p.detach().cpu().numpy()
                                  for p in tree_leaves(model.params)]),
        "launches": dict(fc.LAUNCHES),
        "shapes": {k: dict(v) for k, v in fc.SHAPES.items()},
    }


def _run(opt):
    from .parallel import distributed as pdist
    from .parallel import mesh as pmesh
    from .sfm.bundle import Refiner
    from .sfm.pipeline import LevelSfM
    group = pmesh.get_group()
    device = ("cpu" if opt.get("cpu", False) else "cuda") if group is None \
        else group.device
    model = LevelSfM(opt, seed=int(opt.get("seed", 0)), device=device)
    model.load_data(build_var(opt))
    if opt.get("resume", False) or opt.get("get_result", False):
        # --get_result needs a checkpoint: restore it without --resume
        model.restore_checkpoint()
    elif opt.get("load", None):
        model.restore_checkpoint(opt.load)

    if opt.get("get_result", False):
        from .utils import export
        model._reload_scene()
        if opt.get("refine_again", None) or opt.Ablate_config.get("refine_again"):
            refiner = Refiner(opt, model.cfgs, model.camera_set, model.point_set,
                              max_iter=int(opt.get("refine_again_iters", 10000)),
                              device=model.device)
            model.params = refiner.run(model.params, model.next_key())
            model.save_checkpoint(latest=True)
        if pdist.is_primary():
            export.export_results(opt, model)
        return model

    max_views = opt.get("max_views", None)
    t0 = time.time()
    ok = model.train(max_views=int(max_views) if max_views else None)
    init = model.initializer
    if init is not None and getattr(init, "_metrics", None) is not None:
        m = init._metrics
        print({"init_losses_first": {k: float(v[0]) for k, v in m.items()},
               "init_losses_last": {k: float(v[-1]) for k, v in m.items()},
               "steps": int(len(m["all"])), "triangulated": init.tri_ratio,
               "rot_error_deg": init.pose_errors[0],
               "t_error_deg": init.pose_errors[1]})
    if ok and opt.Ablate_config.get("refine_again", False):
        r = Refiner(opt, model.cfgs, model.camera_set, model.point_set,
                    device=model.device)
        model.params = r.run(model.params, model.next_key())
    rot, t_err, ate = model.camera_set.eval_poses(verbose=False)
    model.summary = {
        "ok": bool(ok), "registered": list(model.camera_set.cam_ids),
        "skipped_views": model.skipped_views, "n_points": len(model.point_set),
        "reproj_px": model.view_log[-1]["reproj_px"] if model.view_log else None,
        "rot_error_deg": rot, "t_error": t_err, "ate": ate,
        "seconds": round(time.time() - t0, 3), "device": str(model.device),
        "ranks": pmesh.world_size()}
    print(model.summary)
    return model


if __name__ == "__main__":
    main()
