"""The reading of the program's spans and counters
(``harness/spans.py``) and the five metrics that read them, on synthetic
spans and device intervals; the stretches on a stand-in cell; and one
``gpu`` test that runs the stretches of a small cell on the card."""
import pytest
import torch

from portbench import run
from portbench.harness import spans

MS = 1_000_000  # ns

#: (name, t0, t1, parent, thread, step): a step with a march and its
#: encode, a backward with a span on another thread, and an update with
#: a child
ROWS = [("step.init", 0, 100, -1, 1, 0),
        ("sdf.march", 10, 50, 0, 1, 0),
        ("hashgrid.encode", 20, 30, 1, 1, 0),
        ("backward", 60, 90, 0, 1, 0),
        ("hash_scatter.cotangent", 70, 80, 3, 2, 0),
        ("optim.update", 92, 99, 0, 1, 0),
        ("inner", 94, 96, 5, 1, 0)]
#: device events (start, end, correlation id) and their launches' host times
DEV = [(0, 15, 1), (25, 40, 2), (45, 75, 3), (95, 120, 4), (130, 140, 5)]
LAUNCH = {1: 5, 2: 22, 3: 65, 4: 93}


def _ms(rows):
    return [(n, t0 * MS, t1 * MS, p, th, st) for n, t0, t1, p, th, st in rows]


def _by_span():
    return spans.by_span([(s * MS, e * MS, c) for s, e, c in DEV],
                         {c: t * MS for c, t in LAUNCH.items()}, _ms(ROWS))


def test_paths_follow_the_parents():
    assert spans.paths(ROWS) == [
        "step.init", "step.init/sdf.march", "step.init/sdf.march/hashgrid.encode",
        "step.init/backward", "step.init/backward/hash_scatter.cotangent",
        "step.init/optim.update", "step.init/optim.update/inner"]


def test_idle_is_split_by_the_innermost_open_span():
    """Gaps 15-25, 40-45, 75-95 and 120-130 ms: each instant goes to the
    deepest span open then, the one on the other thread included; time
    after the step to no span."""
    idle = {p: round(v["idle_s"] * 1e3, 9) for p, v in _by_span().items() if v["idle_s"]}
    assert idle == {"step.init/sdf.march": 10.0, "step.init/sdf.march/hashgrid.encode": 5.0,
                    "step.init/backward/hash_scatter.cotangent": 5.0,
                    "step.init/backward": 10.0, "step.init": 2.0,
                    "step.init/optim.update": 2.0, "step.init/optim.update/inner": 1.0,
                    spans.NO_SPAN: 10.0}
    total = sum(v["idle_s"] for v in _by_span().values())
    assert total * 1e3 == pytest.approx(45.0)


def test_kernels_go_to_the_span_of_their_launch():
    """Matched by correlation id to the launch's host time; a kernel whose
    launch record is missing goes to no span."""
    by = _by_span()
    dev = {p: (round(v["device_s"] * 1e3, 9), v["launches"]) for p, v in by.items()
           if v["launches"]}
    assert dev == {"step.init": (15.0, 1), "step.init/sdf.march/hashgrid.encode": (15.0, 1),
                   "step.init/backward": (30.0, 1), "step.init/optim.update": (25.0, 1),
                   spans.NO_SPAN: (10.0, 1)}
    assert spans.under(by, "sdf.march", "idle_s") * 1e3 == pytest.approx(15.0)
    assert spans.under(by, "hashgrid.encode", "device_s") * 1e3 == pytest.approx(15.0)


def test_self_time_leaves_out_the_children():
    rows = _ms(ROWS)
    assert spans.self_s(rows, "optim.update") * 1e3 == pytest.approx(5.0)
    assert spans.self_s(rows, "backward") * 1e3 == pytest.approx(20.0)
    assert spans.self_s(rows, "step.init") * 1e3 == pytest.approx(100.0 - 40 - 30 - 7)


def test_rows_are_grouped_by_step():
    rows = [("occ.rebuild", 0, 1, -1, 1, -1), ("step.ba", 2, 5, -1, 1, 0),
            ("render", 3, 4, 1, 1, 0), ("step.ba", 6, 9, -1, 1, 1),
            ("render", 7, 8, 3, 1, 1)]
    assert spans.per_step(rows) == [
        [("step.ba", 2, 5, -1, 1, 0), ("render", 3, 4, 0, 1, 0)],
        [("step.ba", 6, 9, -1, 1, 1), ("render", 7, 8, 0, 1, 1)]]


def _t():
    by = _by_span()
    return {"profile": {"steps": 2, "by_span": by},
            "spans": [_ms(ROWS), _ms(ROWS)],
            "counters": {("step.init/sdf.march", "march.calls"): 4,
                         ("step.init/sdf.march", "march.trips"): 80,
                         ("step.init/sdf.march", "march.rays"): 4096},
            "syncs": [{"step.init/sdf.march": 30, "step.init/render_core": 2},
                      {"step.init/sdf.march": 34}]}


@pytest.mark.parametrize("name, value", [
    ("syncs_per_step", 33.0), ("march_idle_ms", 7.5), ("march_trips", 20.0),
    ("encode_ms", 7.5), ("adam_ms", 5.0)])
def test_the_span_metrics(name, value):
    m = run.load_module("metrics", name)
    assert m.read(_t()) == pytest.approx(value)
    # a run whose program has no tracer: the keys are missing
    assert m.read({"profile": {"steps": 12}, "steps_s": [0.1] * 30, "march": []}) is None


class _Cell:
    """A stand-in for a ``PhaseCell``: an occupancy rebuild every 25th
    step (each stretch fits between two), spans and march counters as
    the program's step opens them."""

    def __init__(self):
        self.i, self.occ_every, self.rebuilds = 0, 25, []

    def step(self):
        from level_s2fm_tpu_torch.utils import obs
        if self.i % self.occ_every == 0:
            # a rebuild while a stretch records
            self.rebuilds.append(obs._TRACER is not None)
        with obs.span("step.refine"):
            with obs.span("sdf.march"):
                obs.count("march.calls")
                obs.count("march.trips", 20)
            with obs.span("optim.update"):
                pass
        self.i += 1


def test_stretches_on_a_stand_in_cell():
    """Each stretch starts where no rebuild falls in it; the span stretch
    gives its rows per step and counters, the sync stretch its counters
    per step (no card here: no syncs)."""
    def no_profile(step, n, host_ops):
        for _ in range(n):
            step()
        return [], 0.0
    cell = _Cell()
    raw = spans.stretches(cell, run.PROFILE_STEPS, lambda: None, profile=no_profile)
    assert len(raw["device_rows"]) == 3 * run.PROFILE_STEPS
    assert raw["counters"] == {("step.refine/sdf.march", "march.calls"): spans.SPAN_STEPS,
                               ("step.refine/sdf.march", "march.trips"): 20 * spans.SPAN_STEPS}
    assert len(raw["sync_counters"]) == spans.SYNC_STEPS
    t = spans.read(raw)
    assert len(t["spans"]) == spans.SPAN_STEPS
    assert all([r[0] for r in rows] == ["step.refine", "sdf.march", "optim.update"]
               for rows in t["spans"])
    assert t["syncs"] == [{}] * spans.SYNC_STEPS
    assert run.load_module("metrics", "march_trips").read(t) == 20.0
    assert run.load_module("metrics", "syncs_per_step").read(t) == 0.0
    assert run.load_module("metrics", "adam_ms").read(t) >= 0.0
    assert cell.rebuilds and not any(cell.rebuilds)


def test_attribute_on_a_tiny_cpu_cell():
    """``portbench.attribute`` on a cut-down cell on the CPU (profiles
    stood in for: no device events): the counters and the host metrics
    read, the device ones have nothing to read."""
    from portbench import attribute
    from portbench.tests.tiny import SEED, TINY

    def no_profile(step, n, host_ops):
        for _ in range(n):
            step()
        return [], 0.0
    rep = attribute.attribute("sphere128-refine", SEED, torch.device("cpu"),
                              option_edits=TINY, profile=no_profile)
    m = rep["metrics"]
    assert m["syncs_per_step"] == 0.0 and m["march_trips"] >= 1 and m["adam_ms"] > 0
    assert m["march_idle_ms"] is None and m["encode_ms"] is None
    assert rep["counters_per_step"]["march.calls"] == 1
    assert rep["counters_per_step"]["march.trips"] == m["march_trips"]
    assert rep["span_stretch_ms_per_step"] > 0 and rep["idle_named_share"] is None


@pytest.mark.gpu
def test_spans_on_the_card():
    """A small init cell on the card: the five metrics read something; in
    every step of the sync stretch at least one sync a trip falls under
    ``sdf.march`` (the march reads its count every trip); the CUDA-only
    profile records the launch of every device event; and kernels
    launched inside a span start after the span's t0 on the device
    trace (the tracer and the profiler share a clock)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from portbench.tests.tiny import SEED, TINY
    edits = dict(TINY, **{"data.image_size": [128, 128], "Renderer.rand_rays": 4096,
                          "SDF.Hash_config.log2_hashmap_size": 16})
    cell = run.Run("sphere128-init", SEED, torch.device("cuda", 0), option_edits=edits).cell
    for _ in range(run.CHECK_STEPS + run.WARM_STEPS):
        cell.step()
    raw = spans.stretches(cell, 4, torch.cuda.synchronize)
    t = spans.read(raw)
    t["profile"] = {"steps": 4, "by_span": t.pop("by_span")}
    for name in ("syncs_per_step", "march_idle_ms", "march_trips", "encode_ms", "adam_ms"):
        assert run.load_module("metrics", name).read(t) is not None, name
    for c in raw["sync_counters"]:
        trips = sum(n for (_, name), n in c.items() if name == "march.trips")
        syncs = sum(n for (path, name), n in c.items()
                    if name == "sync" and "sdf.march" in path.split("/"))
        assert syncs >= trips > 0
    dev, launch = spans.launch_records(raw["device"][0])
    rows, checked = raw["device_rows"], 0
    assert dev and all(corr in launch for _, _, corr in dev)
    for s, _, corr in dev:
        inside = [r for r in rows if r[1] <= launch[corr] <= r[2]]
        if inside:
            assert s >= max(inside, key=lambda r: r[1])[1]
            checked += 1
    assert checked >= 3
