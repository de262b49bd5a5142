"""The benchmark's arithmetic on hand-made inputs: busy intervals and
idle share, the byte bounds behind the rooflines (held to PERF.md's
kernel table), the FLOP count behind ``mfu``, ``step_ms`` over a window,
the metric readers, the check's numbers, and a cell's files found by
name; and, on the card, the control failing where the sound program
passes."""
import json
import math
import os
import shutil

import numpy as np
import pytest
import torch

from portbench import run
from portbench.harness import check, flops, trace

ROOT = run.ROOT


def _reader(name):
    return run.load_module("metrics", name)


def test_union_of_busy_intervals():
    busy, gaps = trace.union_busy([(5, 6), (0, 2), (1, 3), (5.5, 5.7), (8, 9)])
    assert busy == pytest.approx(5.0)
    assert gaps == [(3, 5), (6, 8)]
    assert trace.union_busy([]) == (0.0, [])


def test_device_idle_share():
    read = _reader("device_idle_share").read
    # 10 profiled steps busy 0.5 s: 50 ms a step, against 200 ms unprofiled
    prof = {"wall_s": 3.0, "busy_s": 0.5, "steps": 10}
    assert read({"profile": prof, "steps_s": [0.2, 0.1, 0.3]}) == pytest.approx(75.0)
    assert read({"profile": dict(prof, busy_s=0.0), "steps_s": [0.2]}) is None


def test_scatter_bound_is_the_kernel_tables():
    # the main shape: 2 cameras x 2,048 rays x 32 samples x 16 levels x 8
    # corners into 16 x 2^19 rows of 2 features: 335.5 MB, 0.1002 ms
    n, m = 2 * 2048 * 32 * 16 * 8, 16 * 2 ** 19
    b = flops.scatter_bytes(n, m, 2)
    assert b == 335_544_320
    assert b / flops.PEAK_HBM_BYTES * 1e3 == pytest.approx(0.1002, abs=5e-5)


def test_composite_bounds_are_the_kernel_tables():
    fwd, bwd = flops.composite_bytes(4096, 32)
    assert fwd / 1e6 == pytest.approx(4.47, abs=5e-3)
    assert bwd / 1e6 == pytest.approx(8.68, abs=5e-3)
    assert fwd / flops.PEAK_HBM_BYTES * 1e3 == pytest.approx(0.001335, abs=5e-7)
    assert bwd / flops.PEAK_HBM_BYTES * 1e3 == pytest.approx(0.002592, abs=5e-7)


def test_rooflines_from_a_hand_made_trace():
    shapes = {(2 * 2048 * 32 * 16 * 8, 16 * 2 ** 19, 2): 2}
    prof = {"kernels": {"void (anonymous namespace)::onesweep_pass_kernel<2>(...)": 1.0e-3,
                        "void (anonymous namespace)::segment_sum_kernel<2>(...)": 1.0e-3,
                        "ampere_sgemm": 5.0},
            "scatter_shapes": shapes, "composite_shapes": {"fwd": {(4096, 32): 1},
                                                           "bwd": {(4096, 32): 1}}}
    got = _reader("scatter_roofline").read({"profile": prof})
    assert got == pytest.approx(2 * 335_544_320 / 3.35e12 / 2e-3 * 100)
    assert _reader("composite_roofline").read({"profile": prof}) is None
    prof["kernels"]["(anonymous namespace)::fwd_regs(Src, ...)"] = 2e-6
    prof["kernels"]["(anonymous namespace)::bwd_regs(Src, ...)"] = 4e-6
    fwd, bwd = flops.composite_bytes(4096, 32)
    assert _reader("composite_roofline").read({"profile": prof}) == pytest.approx(
        (fwd + bwd) / 3.35e12 / 6e-6 * 100)
    assert _reader("scatter_roofline").read({"profile": dict(prof, kernels={})}) is None


def _opt():
    with open(os.path.join(ROOT, "portbench/configs/levels2fm-sphere128.json")) as f:
        return json.load(f)["options"]


def test_flops_of_a_point_at_the_published_widths():
    p = flops.point_flops(_opt())
    # 16 levels x 2 features; MLPs 35 -> 64 -> 17 and 49 -> 64 -> 64 -> 3
    assert p == {"enc": 16 * (16 + 32), "enc_grad": 16 * (72 + 96),
                 "geo": 2 * (35 * 64 + 64 * 17), "geo_grad": 2 * 35 * 64 + 2 * 35 * 3,
                 "rad": 2 * (49 * 64 + 64 * 64 + 64 * 3)}


def test_flops_of_a_step_and_mfu():
    opt = _opt()
    p = flops.point_flops(opt)
    sdf = p["enc"] + p["geo"]
    full = sdf + p["enc_grad"] + p["geo_grad"]
    want = 3 * (8192 * 32 * (full + p["rad"]) + 1000 * sdf) + (3000 + 64 ** 3 / 62) * sdf
    got = flops.step_flops(opt, render_points=8192 * 32, march_points=3000,
                           reeval_points=1000, surface_points=0, occ_points=64 ** 3 / 62)
    assert got == pytest.approx(want)
    # two steps of 0.2 s, each with one march call of 100 rays and 20 trips
    t = {"opt": opt, "flop_shapes": {"render_rays": 8192, "surface_points": 0},
         "occ_every": 62, "steps_s": [0.2, 0.2], "march": [[(0.05, 100, 20)]] * 2}
    one = flops.step_flops(opt, 8192 * 32, 100 * 21, 100 * 20, 0, 64 ** 3 / 62)
    assert _reader("mfu").read(t) == pytest.approx(one / 0.2 / 67e12 * 100)
    assert _reader("mfu").read(dict(t, march=[[], []])) is None


def test_host_clock_readers():
    steps = [0.2] * 95 + [0.4] * 5
    got = _reader("step_p95_ms").read({"steps_s": steps})
    assert got == pytest.approx(np.percentile(steps, 95) * 1e3)
    assert _reader("step_p95_ms").read({"steps_s": steps[:10]}) is None
    t = {"march": [[(0.05, 10, 3), (0.02, 10, 3)], [(0.07, 10, 3)]]}
    assert _reader("march_ms").read(t) == pytest.approx(70.0)
    assert _reader("march_ms").read({"march": [[], []]}) is None


def test_step_ms_over_a_window():
    """Steps of 0.25 s on a fake clock: a 1-second window takes 4 steps
    and closes after the sync, which the wall time counts."""
    now = [0.0]
    clock = lambda: now[0]  # noqa: E731

    def step():
        now[0] += 0.25

    def sync():
        now[0] += 0.1
    n, wall = run.measure(step, 1.0, sync, clock=clock)
    assert (n, wall) == (4, pytest.approx(1.1))
    assert run.step_ms(wall, n) == pytest.approx(275.0)
    # steps run by ``before`` inside the window count
    now[0] = 0.0
    n, wall = run.measure(step, 1.0, sync, clock=clock,
                          before=lambda k: 2 if k == 1 else 0)
    assert n == 6


def test_check_numbers():
    prog = {"loss": [100.0, 90.0, 80.0],
            "grads": [{"a": 1.0, "b": 2.0, "c": 1e-9, "d": 1.0},
                      {"a": 1.0, "b": 2.1, "c": 0.0, "d": 1.0}],
            "change": [{"a": 0.5, "b": 0.52, "c": 0.3, "d": 2.0},
                       {"a": 9.0, "b": 9.0, "c": 9.0, "d": 9.0}]}
    ref = {"loss": [100.0, 90.009, 70.0],
           "grads": [{"a": 1.0, "b": 2.0, "c": 0.0, "d": 1.0},
                     {"a": 5.0, "b": 5.0, "c": 5.0, "d": 5.0}],
           "grads_at2": {"a": 1.0, "b": 2.0, "c": 0.0, "d": 1.0},
           "change": [{"a": 0.5, "b": 0.5, "c": 0.1, "d": 1.0},
                      {"a": 1.0, "b": 1.0, "c": 1.0, "d": 1.0}]}
    got = check.gaps(prog, ref)
    assert got["loss_gap"] == pytest.approx(1e-4, rel=1e-3)      # steps 1 and 2 only
    assert got["grad_gap"] == pytest.approx(0.1 / 2.0)           # step 2 at the program's state
    # the first step's change of the median of a, b, d (c left out): b
    assert got["change_gap"] == pytest.approx(0.02 / 0.5)
    ok, rows = check.verdict(got, {"loss_gap": 1e-3, "grad_gap": 0.1, "change_gap": 0.1})
    assert ok and [r[0] for r in rows] == ["loss_gap", "grad_gap", "change_gap"]
    assert not check.verdict(got, {"loss_gap": 1e-3, "grad_gap": 0.1})[0]
    assert not check.verdict({"loss_gap": math.nan}, {"loss_gap": 1.0})[0]
    look = check.per_step(prog, ref)
    assert look["loss_steps"][2] == pytest.approx(10 / 70)
    assert look["grad_at2"] == ("b", pytest.approx(0.05))


def test_pose_error():
    a = np.hstack([np.eye(3), np.zeros((3, 1))])
    c, s = math.cos(0.1), math.sin(0.1)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    b = np.hstack([R, np.array([[1.0], [0], [0]])])
    assert check.pose_error_deg(a, b, a, b) == pytest.approx(0.0, abs=1e-3)  # acos near 1
    assert check.pose_error_deg(a, np.hstack([np.eye(3), b[:, 3:]]), a, b) == pytest.approx(
        math.degrees(0.1))


def test_a_dropped_cell_is_found_by_name(tmp_path):
    """A cell, its traffic, its configuration, a driver and a metric added
    as files only are found by the names in BENCHMARK.json."""
    root = tmp_path
    for d in ("workloads", "configs", "drivers", "metrics"):
        (root / "portbench" / d).mkdir(parents=True)
    shutil.copy(os.path.join(ROOT, "portbench/configs/levels2fm-sphere128.json"),
                root / "portbench/configs/new-conf.json")
    (root / "portbench/workloads/new-mix.json").write_text(
        json.dumps({"driver": "new_driver", "occ_every": 7, "limits": {}}))
    (root / "portbench/drivers/new_driver.py").write_text("def build(ctx):\n    return 42\n")
    (root / "portbench/metrics/new.metric.py").write_text("def read(t):\n    return 1.5\n")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "new-conf", "source": "x",
                             "file": "portbench/configs/new-conf.json", "reduced": [],
                             "why": "x"})
    bench["workloads"].append({"name": "new-cell", "config": "new-conf",
                               "traffic": "new-mix", "chips": 1, "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    _, cell, options, traffic = run.load_cell("new-cell", root=str(root))
    assert cell["traffic"] == "new-mix" and traffic["occ_every"] == 7
    assert options["SDF"]["Hash_config"]["log2_hashmap_size"] == 19
    assert run.load_module("drivers", "new_driver", root=str(root)).build(None) == 42
    assert run.load_module("metrics", "new.metric", root=str(root)).read({}) == 1.5


@pytest.mark.gpu
def test_control_fails_where_the_program_passes():
    """On the card at a small size: the reference with TF32 products in
    the program's place reads a loss gap that the sound program's runs
    stay well under, on three seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from portbench import calibrate
    from portbench.tests.tiny import TINY
    edits = dict(TINY, **{"data.image_size": [128, 128], "Renderer.rand_rays": 4096,
                          "SDF.Hash_config.log2_hashmap_size": 16})
    out = calibrate.readings("sphere128-refine", calibrate.seeds_from(7000000000, 3), 3, 0,
                             torch.device("cuda", 0), option_edits=edits,
                             log=lambda *a, **k: None)
    sound = max(r["loss_gap"] for r in out["sound"])
    control = min(r["loss_gap"] for r in out["control"])
    assert control > 3 * sound, (sound, control)
