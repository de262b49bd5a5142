"""Run one cell of the benchmark once:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``'s
``workloads``) names a configuration (``portbench/configs/<name>.json``)
and a traffic file (``portbench/workloads/<traffic>.json``), which names
the phase driver (``portbench/drivers/<driver>.py``). The run:

1. builds the scene, the seed's initial fields (on the card) and the
   program's phase, then drives the phase's first steps through the same
   call the window makes, keeping what the check compares; warms up;
2. steps the phase for ``--seconds`` (``step_ms``: the window's wall time
   over its steps; ``setup_s``: process start to the window);
3. with ``--trace 1``: records the march's host spans and each step's
   host time over the window, then closes the window with two profiled
   stretches (CUDA activity alone, then CPU activity too), and reports
   the per-layer metrics (``portbench/metrics/<name>.py``);
4. reads the peak memory, checks that no JAX module was loaded, frees the
   program's state, runs the plain reference (``portbench/reference``)
   over the same first steps and compares (``harness/check.py``).

The last line of standard output is the result as one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error and the result's last key. Exits non-zero, with no result, without
a CUDA card (or fewer than the cell's chips) or without the port.
"""
from __future__ import annotations

import time

_T_IMPORT = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "level_s2fm_tpu")
#: steps the check compares, and the warm-up steps after them
CHECK_STEPS, WARM_STEPS = 3, 2
#: steps of a traced run's device stretch (CUDA activity alone) and host
#: stretch (CPU activity too), profiled one after the other at the end of
#: its window
PROFILE_STEPS, HOST_STEPS = 12, 3


def process_start() -> float:
    """The process's start time (epoch seconds), from /proc; the time
    this module was imported where /proc is not there."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return _T_IMPORT


def load_module(kind: str, name: str, root=ROOT):
    """``portbench/<kind>/<name>.py`` (under ``root``) as a module of this
    package."""
    path = os.path.join(root, "portbench", kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    mod_name = f"portbench.{kind}.{name.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, bench=None, root=ROOT):
    """(benchmark, cell, options dict, traffic dict) of a cell of
    ``root/BENCHMARK.json``, its files found by name under ``root``."""
    if bench is None:
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        options = json.load(f)["options"]
    with open(os.path.join(root, "portbench", "workloads", f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)
    return bench, cell, options, traffic


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _set_caches():
    """Build and kernel caches inside the checkout, at fixed paths (the
    port builds its kernels into ``level_s2fm_tpu_torch/_build/``)."""
    cache = os.path.join(ROOT, ".portbench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_ext"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ.setdefault(var, os.path.join(cache, sub))


def program_numbers(cell):
    """Drive the first CHECK_STEPS steps; returns the numbers the check
    compares ({"loss", "grads", "change"} per step, and "after1": the
    parameters and carried track points after the first step) and the
    generator states the reference replays."""
    import torch
    from .harness.weights import clone
    from .reference.step import step_grads
    start = {k: v.detach().clone() for k, v in cell.leaves().items()}
    out = {"loss": [], "grads": [], "change": []}
    states = []
    for i in range(CHECK_STEPS):
        states.append(cell.gen.get_state())
        prev = {k: m.clone() for k, m in cell.moments().items()}
        res = cell.step()
        out["loss"].append(float(res["all"]))
        out["grads"].append(step_grads(cell.moments(), prev, cell.state["opt"].b1))
        out["change"].append({k: float(torch.linalg.norm(v.detach() - start[k]))
                              for k, v in cell.leaves().items()})
        if i == 0:
            # kept off the card, so that the window's peak memory is the program's
            xyzs = cell.state.get("xyzs")
            out["after1"] = {"params": clone(cell.state["params"], "cpu"),
                             "xyzs": None if xyzs is None else xyzs.detach().cpu()}
    return out, states


class Run:
    """One cell built on ``device``: the options, the scene, the seed's
    initial parameters (a copy kept off the card for the reference) and
    the program's phase (``cell``). ``option_edits`` ({dotted key: value})
    edits the configuration's options (tests run a cell at a small size);
    ``scene`` is one already loaded for the same options."""

    def __init__(self, cell_name, seed, device, bench=None, option_edits=None, scene=None):
        from level_s2fm_tpu_torch.config import Opt, process_options
        from .harness import cell as cell_mod, scenes, weights
        self.bench, self.cdef, self.options, self.traffic = load_cell(cell_name, bench)
        for key, val in (option_edits or {}).items():
            node = self.options
            *path, last = key.split(".")
            for k in path:
                node = node[k]
            node[last] = val
        self.name, self.seed, self.device = cell_name, seed, device
        opt = self.opt = Opt(self.options)
        process_options(opt)
        opt.output_path = os.path.join(os.environ.get("TMPDIR", "/tmp"), "portbench_out")
        params = weights.make(opt, seed, device)
        self.params0 = weights.clone(params, "cpu")
        self.scene = scenes.load(opt) if scene is None else scene
        ctx = cell_mod.Context(opt=opt, scene=self.scene, params=params,
                               traffic=self.traffic, seed=seed, device=device)
        self.cell = load_module("drivers", self.traffic["driver"]).build(ctx)
        c = self.cell
        self.kind, self.cam_ids, self.ref_scene = c.kind, c.cam_ids, c.ref_scene
        self.max_iter = c.max_iter

    def free_program(self):
        """Drop the program's phase and its state."""
        import torch
        self.cell = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, gen_states, precision="float32"):
        """The reference over the same steps from the same start."""
        from .harness import weights
        from .reference import step as ref_step
        return ref_step.run(self.kind, self.options, self.ref_scene, self.cam_ids,
                            weights.clone(self.params0, self.device), gen_states,
                            self.max_iter, precision=precision)

    def reference_at(self, ref, after1, gen_states):
        """``ref`` with the reference's gradient of the second step taken
        at the state ``after1`` that the side under check reached after
        its first step (``grads_at2``)."""
        from .harness import weights
        from .reference import step as ref_step
        g = ref_step.grads_at(self.kind, self.options, self.ref_scene, self.cam_ids,
                              weights.clone(self.params0, self.device), after1["params"],
                              gen_states[1], self.max_iter, after1["xyzs"])
        return dict(ref, grads_at2=g)

    def numbers(self, prog, ref, look=False):
        """The numbers compared (``harness.check``); with ``look``, the
        per-step readings behind them too."""
        from .harness import check
        out = check.gaps(prog, ref)
        if self.kind == "init":
            a, b = self.cam_ids
            w, g = self.ref_scene["w2c"], self.ref_scene["w2c_gt"]
            out["pose_err_deg"] = check.pose_error_deg(w[a], w[b], g[a], g[b])
        if look:
            out.update(check.per_step(prog, ref))
        return out


def run_cell(cell_name, seed, seconds, trace, device, bench=None, option_edits=None,
             t_start=None, log=print):
    """One run of a cell on ``device``; returns (result dict, check rows)."""
    import torch
    from .harness import check, trace as trace_mod

    t_start = time.time() if t_start is None else t_start
    run = Run(cell_name, seed, device, bench, option_edits)
    cell, bench = run.cell, run.bench
    prog, gen_states = program_numbers(cell)
    for _ in range(WARM_STEPS):
        cell.step()
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()

    window = {"steps_s": [], "march": [], "profile": None}
    marches = trace_mod.MarchSpans() if trace else None
    bad = [torch.zeros((), device=device)]
    clock = {"last": 0.0}

    def step():
        bad[0] = bad[0] + cell.step()["nonfinite"]
        if trace:
            now = time.perf_counter()
            window["steps_s"].append(now - clock["last"])
            window["march"].append(marches.take())
            clock["last"] = now

    load0 = _loadavg()
    setup_s = time.time() - t_start
    if marches:
        marches.__enter__()
    try:
        clock["last"] = time.perf_counter()
        n, wall = measure(step, seconds, sync)
        log(f"[portbench] window: {n} steps, {wall:.3f} s; host load average {load0} -> "
            f"{_loadavg()}", file=sys.stderr)
        if trace:
            # the profiled stretches close the traced window, once no
            # occupancy rebuild falls in them; the steps before them and
            # after the timed part are recorded with the rest
            while not _fits(cell, PROFILE_STEPS + HOST_STEPS):
                step()
                n += 1
            marches.take()
            window["profile"] = _profiled(cell, trace_mod)
    finally:
        if marches:
            marches.__exit__(None, None, None)
    failed = int(round(float(bad[0])))
    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules loaded that the port may not load: {found}")

    result = {"correct": False, "attempted": n, "failed": failed, "metrics": {},
              "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                         "kind": (torch.cuda.get_device_name(device)
                                  if device.type == "cuda" else "cpu"),
                         "count": 1, "memory_peak_bytes": peak}}
    unit = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    if not trace:
        result["metrics"] = {"step_ms": {"value": step_ms(wall, n), "unit": unit["step_ms"]},
                             "setup_s": {"value": setup_s, "unit": unit["setup_s"]}}
    else:
        raw = window["profile"]
        prof = trace_mod.reduce(raw["device"], raw["host"], PROFILE_STEPS)
        unprofiled = sum(window["steps_s"]) / len(window["steps_s"])
        log(f"[portbench] traced window: {unprofiled * 1e3:.1f} ms a step unprofiled, "
            f"{prof['wall_s'] / PROFILE_STEPS * 1e3:.1f} in the device stretch", file=sys.stderr)
        prof.update(scatter_shapes=raw["scatter_shapes"], composite_shapes=raw["composite_shapes"])
        data = {"opt": run.opt, "flop_shapes": cell.flop_shapes, "occ_every": cell.occ_every,
                "steps_s": window["steps_s"], "march": window["march"], "profile": prof}
        for m in bench["per_layer"]:
            if m.get("workloads") is not None and cell_name not in m["workloads"]:
                continue
            v = load_module("metrics", m["name"]).read(data)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        result["device"].update(busy_s=prof["busy_s"], window_s=prof["wall_s"])
        ops = sorted(prof["kernels"].items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[k[:160], v] for k, v in ops],
                               "idle_gaps": prof["idle_gaps"]}

    # the reference, once the program's state is freed
    del cell
    run.free_program()
    t_ref = time.perf_counter()
    ref = run.reference_at(run.reference(gen_states), prog["after1"], gen_states)
    log(f"[portbench] reference: {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    ok, rows = check.verdict(run.numbers(prog, ref), run.traffic.get("limits", {}))
    result["correct"] = ok and failed == 0
    result["check"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result, rows


def step_ms(wall, n):
    """``step_ms``: the window's wall time over the steps completed in it."""
    return wall / n * 1e3


def measure(step, seconds, sync, before=None, clock=time.perf_counter):
    """The measured window: ``step()`` until ``seconds`` have passed since
    the window opened (a step that starts is finished), then ``sync()``,
    which the window's wall time includes. ``before(n)``, called before
    each step with the steps so far, may run steps of its own inside the
    window and returns how many. Returns (steps, wall seconds)."""
    n = 0
    t0 = clock()
    while True:
        if before is not None:
            n += before(n)
        step()
        n += 1
        if clock() - t0 >= seconds:
            break
    sync()
    return n, clock() - t0


def _loadavg():
    try:
        with open("/proc/loadavg") as f:
            return f.read().split()[0]
    except OSError:
        return "?"


def _fits(cell, k):
    """No occupancy rebuild among the next k steps."""
    return all((cell.i + j) % cell.occ_every for j in range(k))


def _profiled(cell, trace_mod):
    """The device stretch, with the kernels' launch counts by shape over
    it, then the host stretch; reduced after the window."""
    from level_s2fm_tpu_torch.fields import hash_scatter
    from level_s2fm_tpu_torch.rendering import fused_composite as fc
    hash_scatter.reset_launches()
    fc.reset_launches()
    out = {"device": trace_mod.profile_steps(cell.step, PROFILE_STEPS, host_ops=False)}
    out["scatter_shapes"] = dict(hash_scatter.SHAPES)
    out["composite_shapes"] = {k: dict(v) for k, v in fc.SHAPES.items()}
    out["host"] = trace_mod.profile_steps(cell.step, HOST_STEPS, host_ops=True)
    return out


def main(argv=None):
    t_start = process_start()
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.chdir(ROOT)
    _set_caches()
    bench, cdef, _, _ = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cdef["chips"]):
        print(f"[portbench] needs {cdef['chips']} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if importlib.util.find_spec("level_s2fm_tpu_torch") is None:
        print("[portbench] the port level_s2fm_tpu_torch is not in this checkout",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _power_line()
    try:
        result, rows = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                torch.device("cuda", 0), bench=bench, t_start=t_start)
    except RuntimeError as e:
        print(f"[portbench] {e}", file=sys.stderr)
        return 1
    found = forbidden_modules()
    if found:
        print(f"[portbench] modules loaded that the port may not load: {found}",
              file=sys.stderr)
        return 1
    for k, v, lim in rows:
        print(f"{k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result, allow_nan=True))
    return 0


def _power_line():
    import subprocess
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=30)
        print(f"[portbench] card: {p.stdout.strip()}", file=sys.stderr)
    except (OSError, subprocess.SubprocessError):
        print("[portbench] card: nvidia-smi not available", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())

