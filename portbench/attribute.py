"""Put one cell's device-idle gaps, kernels and host-device syncs down to
the program's layers, with the port's own tracer:

    python3 -m portbench.attribute --workload <cell> --seed <n> [--out <file>]

from the root of a checkout, on a machine with the card. It builds the
cell as ``portbench.run`` does, takes its check and warm-up steps, then
runs ``harness.spans.stretches`` (the CUDA-only device stretch with the
tracer on, the span stretch and the sync stretch) and prints, as the
last line of standard output, one JSON object: the five span metrics
(``portbench/metrics``), the span stretch's ms a step, the counters a
step, the syncs a step by span path, ``by_span`` a step, and the share
of the device stretch's idle time that falls under a named span.
``--out`` writes the same object to a file too. Until ``portbench.run``
runs these stretches in a ``--trace 1`` run, this is how they are read.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from . import run
from .harness import spans

#: the per-layer metrics that read the tracer's spans and counters
SPAN_METRICS = ("syncs_per_step", "march_idle_ms", "march_trips", "encode_ms", "adam_ms")


def attribute(cell_name, seed, device, option_edits=None, profile=None):
    """One run on ``device``; returns the report (a dict). ``profile``
    replaces ``trace.profile_steps`` (tests on the CPU)."""
    import torch
    cell = run.Run(cell_name, seed, device, option_edits=option_edits).cell
    for _ in range(run.CHECK_STEPS + run.WARM_STEPS):
        cell.step()
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    raw = spans.stretches(cell, run.PROFILE_STEPS, sync,
                          **({} if profile is None else {"profile": profile}))
    t = spans.read(raw)
    steps = run.PROFILE_STEPS
    by = t.pop("by_span")
    t["profile"] = {"steps": steps, "by_span": by}
    idle = sum(v["idle_s"] for v in by.values())
    syncs = {}
    for s in t["syncs"]:
        for path, k in s.items():
            syncs[path] = syncs.get(path, 0) + k / len(t["syncs"])
    counters = {}
    for (_, name), k in t["counters"].items():
        counters[name] = counters.get(name, 0) + k / spans.SPAN_STEPS
    return {
        "workload": cell_name, "seed": seed,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "metrics": {m: run.load_module("metrics", m).read(t) for m in SPAN_METRICS},
        "span_stretch_ms_per_step": t["span_steps_s"] * 1e3,
        "counters_per_step": counters,
        "syncs_by_span": syncs,
        "idle_named_share": (1.0 - by.get(spans.NO_SPAN, {}).get("idle_s", 0.0) / idle
                             if idle > 0 else None),
        "by_span": {p: {"idle_ms": v["idle_s"] / steps * 1e3,
                        "device_ms": v["device_s"] / steps * 1e3,
                        "launches": v["launches"] / steps} for p, v in by.items()},
    }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m portbench.attribute")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    os.chdir(run.ROOT)
    run._set_caches()
    import torch
    if not torch.cuda.is_available():
        print("[portbench] needs a CUDA device", file=sys.stderr)
        return 2
    # as portbench.run sets them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run._power_line()
    line = json.dumps(attribute(args.workload, args.seed, torch.device("cuda", 0)),
                      allow_nan=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
