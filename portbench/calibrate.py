"""Read the check's numbers over many seeds, for the limits:

    python3 -m portbench.calibrate --workload <cell> [--seeds 12] [--control 3]
        [--faults 3] [--base 9000000000] [--out FILE]

For each seed: the program's first steps against the reference
(``sound``); on the first ``--control`` seeds, the reference computed
with TF32 matrix products in the program's place (``control``: the
precision below the configuration's float32 with TF32 off); on the first
``--faults`` seeds, the program with each fault of ``harness.faults``
planted. No measured window. Prints one JSON line per reading and a
summary (the largest sound reading and the smallest control and fault
readings of each number), and writes them all to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import run as run_mod
from .harness import faults


def seeds_from(base, n):
    return [base + 1000003 * i for i in range(n)]


def readings(cell_name, seeds, n_control, n_faults, device, option_edits=None, log=print):
    """{"sound": [...], "control": [...], <fault>: [...]}: per seed the
    numbers the check compares."""
    out = {"sound": [], "control": []}
    scene = None
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        r = run_mod.Run(cell_name, seed, device, option_edits=option_edits, scene=scene)
        scene = r.scene
        prog, states = run_mod.program_numbers(r.cell)
        r.free_program()
        ref_run = r.reference(states)
        ref = r.reference_at(ref_run, prog["after1"], states)
        row = {"seed": seed, **r.numbers(prog, ref, look=True)}
        out["sound"].append(row)
        log(json.dumps({"kind": "sound", **row}), flush=True)
        if i < n_control:
            ctl = r.reference(states, precision="tf32")
            row = {"seed": seed, **r.numbers(ctl, r.reference_at(ref_run, ctl["after1"], states),
                                             look=True)}
            out["control"].append(row)
            log(json.dumps({"kind": "control", **row}), flush=True)
        if i < n_faults:
            for name, plant in faults.FAULTS.items():
                if name == "pose_identity" and r.kind != "init":
                    continue
                with plant():
                    rf = run_mod.Run(cell_name, seed, device, option_edits=option_edits,
                                     scene=scene)
                    fprog, fstates = run_mod.program_numbers(rf.cell)
                rf.free_program()
                same = all(bool((a == b).all()) for a, b in zip(states, fstates))
                fref = rf.reference_at(ref_run, fprog["after1"], states)
                row = {"seed": seed, "same_draws": same, **rf.numbers(fprog, fref, look=True)}
                out.setdefault(name, []).append(row)
                log(json.dumps({"kind": name, **row}), flush=True)
        log(f"[calibrate] seed {seed}: {time.perf_counter() - t0:.1f} s", file=sys.stderr,
            flush=True)
    return out


def summary(out):
    keys = [k for k, v in out["sound"][0].items() if k != "seed" and isinstance(v, float)]
    s = {"sound_max": {k: max(r[k] for r in out["sound"]) for k in keys}}
    for kind, rows in out.items():
        if kind != "sound" and rows:
            s[f"{kind}_min"] = {k: min(r[k] for r in rows) for k in keys}
    return s


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--base", type=int, default=9000000000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    os.chdir(run_mod.ROOT)
    run_mod._set_caches()
    import torch
    if not torch.cuda.is_available():
        print("[calibrate] needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = readings(args.workload, seeds_from(args.base, args.seeds), args.control,
                   args.faults, torch.device("cuda", 0))
    s = summary(out)
    print(json.dumps({"workload": args.workload, "device": torch.cuda.get_device_name(0),
                      **s}))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "readings": out, "summary": s}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
