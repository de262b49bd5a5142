"""The port's tracer (``level_s2fm_tpu_torch/utils/obs.py``) on the CPU:
spans nest across threads, record nothing while no tracer is active and
stamp the torch profiler's clock; the march's counters agree with what
the march returns; a traced step changes no bit of the parameters; and
sync warnings count against the innermost span, a backward's included,
with the warning state restored on every path."""
import threading
import warnings

import pytest
import torch

from level_s2fm_tpu_torch.utils import obs

from torch_port_helpers import sphere_rays, torch_opt

#: the spans one InitPhase step opens
INIT_SPANS = {"step.init", "sdf.tracing", "sdf.march", "sdf.reeval", "render_core",
              "render", "hashgrid.encode", "backward", "hash_scatter.cotangent",
              "optim.update"}


def test_spans_nest_across_a_worker_thread():
    """A worker thread with no open span hangs its spans under the
    innermost span of the thread that entered ``tracing``, as autograd's
    device thread does under ``backward``."""
    with obs.tracing() as tr:
        with obs.span("step.init"):
            with obs.span("backward"):
                worker = threading.Thread(target=_worker_spans)
                worker.start()
                worker.join(timeout=30)
                assert not worker.is_alive()
            with obs.span("optim.update"):
                obs.count("n", 2)
        rows, counters = tr.take()
    by_name = {r[0]: (i, r) for i, r in enumerate(rows)}
    names = [r[0] for r in rows]
    assert names == ["step.init", "backward", "hash_scatter.cotangent", "inner",
                     "optim.update"]

    def parent(name):
        p = by_name[name][1][3]
        return None if p < 0 else rows[p][0]
    assert parent("step.init") is None
    assert parent("backward") == "step.init"
    assert parent("hash_scatter.cotangent") == "backward"
    assert parent("inner") == "hash_scatter.cotangent"
    assert parent("optim.update") == "step.init"
    main, other = by_name["backward"][1][4], by_name["inner"][1][4]
    assert main == threading.get_ident() and other != main
    for _, (i, (name, t0, t1, p, _, step)) in by_name.items():
        assert t0 <= t1 and step == 0
        if p >= 0:
            assert rows[p][1] <= t0 and t1 <= rows[p][2]
    assert counters == {("step.init/backward/hash_scatter.cotangent", "w"): 1,
                        ("step.init/optim.update", "n"): 2}
    assert tr.take() == ([], {})


def _worker_spans():
    with obs.span("hash_scatter.cotangent"):
        with obs.span("inner"):
            pass
        obs.count("w")


def test_no_tracer_records_nothing():
    """Without a tracer ``span`` hands out the one shared no-op object, a
    decorated function runs as itself, counts go nowhere, and a tracer
    entered later sees none of it."""
    assert obs.span("a") is obs.NO_SPAN and obs.span("b") is obs.NO_SPAN

    @obs.traced("f")
    def f(x):
        return x + 1

    with obs.span("a"):
        obs.count("c", 5)
        assert f(1) == 2
    with obs.tracing() as tr:
        assert obs.span("a") is not obs.NO_SPAN
        assert f(2) == 3
        rows, counters = tr.take()
    assert [r[0] for r in rows] == ["f"] and counters == {}
    assert obs.span("a") is obs.NO_SPAN
    with pytest.raises(RuntimeError, match="already active"):
        with obs.tracing():
            with obs.tracing():
                pass
    assert obs.span("a") is obs.NO_SPAN


def test_spans_share_the_profilers_clock():
    """A ``record_function`` opened inside a span lies, in a CPU trace of
    ``torch.profiler``, inside the span's [t0_ns, t1_ns]."""
    from torch.profiler import ProfilerActivity, profile, record_function
    x = torch.ones(256)
    with profile(activities=[ProfilerActivity.CPU]) as prof, obs.tracing() as tr:
        for _ in range(3):
            with obs.span("outer"):
                with record_function("inside_the_span"):
                    (x * 2).sum()
        rows, _ = tr.take()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "inside_the_span"]
    assert len(events) == len(rows) == 3
    for e, (_, t0, t1, *_rest) in zip(sorted(events, key=lambda e: e.start_ns()), rows):
        assert t0 <= e.start_ns() <= e.end_ns() <= t1


def test_march_counters_match_what_the_march_returns():
    """``march.calls`` / ``march.rays`` / ``march.trips`` of small CPU
    marches equal their number, their rays and the trips each march
    returns it made (``last_idx + 1``), keyed by the ``sdf.march``
    span."""
    from level_s2fm_tpu_torch.fields import sdf as sdf_mod
    cfg = sdf_mod.config_from_opt(torch_opt())
    params = sdf_mod.init_params(cfg, torch.Generator().manual_seed(0))
    rays, trips = 0, 0
    with obs.tracing() as tr:
        for n in (48, 20):
            o, d = sphere_rays(n=n, seed=n)
            with obs.span("step.init"):
                m = sdf_mod.sphere_march(params, cfg, torch.as_tensor(o), torch.as_tensor(d))
            assert m.contrib.sum() == m.last_idx + 1 >= 1
            rays, trips = rays + m.track.shape[1], trips + m.last_idx + 1
        _, counters = tr.take()
    assert rays == 48 + 20
    assert counters == {("step.init/sdf.march", "march.calls"): 2,
                        ("step.init/sdf.march", "march.rays"): rays,
                        ("step.init/sdf.march", "march.trips"): trips}


def _init_step(traced):
    """One tiny InitPhase step (its occupancy grid rebuilt first) from a
    fixed state and seed; returns (parameters after it, tracer rows)."""
    from level_s2fm_tpu_torch.data import synthetic
    from level_s2fm_tpu_torch.sfm import bundle
    from level_s2fm_tpu_torch.sfm.initialization import Initializer
    from level_s2fm_tpu_torch.sfm.optim import tree_leaves
    from level_s2fm_tpu_torch.sfm.pipeline import LevelSfM

    opt = torch_opt(["--Renderer.rand_rays=128"])
    scene = synthetic.make_scene(n_views=2, H=16, W=16, n_points=64, seed=0)
    model = LevelSfM(opt, seed=0, device="cpu")
    model.load_data(synthetic.scene_to_var(scene))
    var = model.var
    init_var = {"indx_init": [0, 1], "imgs_init": var["images"][:2],
                "kypts_init": var["kypts"][:2], "intrs_init": var["intrs"][:2],
                "mchs_init": var["matches"][:2], "inliers_init": var["masks"][:2],
                "poses_gt": var["poses_gt"]}
    init = Initializer(opt, model.cfgs, model.camera_set, model.point_set, init_var,
                       device="cpu")
    state = init.phase.init_state(model.params)
    batch = dict(init.batch)
    gen = torch.Generator().manual_seed(5)
    rows = []
    if traced:
        with obs.tracing() as tr:
            batch["occ"] = bundle.maybe_build_occ(opt, model.cfgs, state["params"])
            init.phase.step(state, batch, gen)
            rows, _ = tr.take()
    else:
        batch["occ"] = bundle.maybe_build_occ(opt, model.cfgs, state["params"])
        init.phase.step(state, batch, gen)
    return [p.detach().clone() for p in tree_leaves(state["params"])], rows


def test_traced_init_step_is_bitwise_the_untraced_one():
    plain, _ = _init_step(False)
    traced, rows = _init_step(True)
    assert all(torch.equal(a, b) for a, b in zip(plain, traced))
    assert {r[0] for r in rows} == INIT_SPANS
    steps = [i for i, r in enumerate(rows) if r[0] == "step.init"]
    assert len(steps) == 1 and rows[steps[0]][5] == 0
    # every span lies under the step; the rebuild before it opens none
    under = {r[0] for r in rows if _ancestor(rows, r, steps[0])}
    assert under == INIT_SPANS - {"step.init"} and rows[steps[0]][3] == -1
    marches = [r for r in rows if r[0] == "sdf.march"]
    assert {rows[r[3]][0] for r in marches} == {"sdf.tracing", "render_core"}


def _ancestor(rows, row, index):
    p = row[3]
    while p >= 0:
        if p == index:
            return True
        p = rows[p][3]
    return False


def test_sync_warnings_count_against_the_innermost_span(monkeypatch):
    """Planted sync warnings count as ``sync`` against the innermost span,
    each time (the same line warns thrice); on an exception the sync
    debug mode, the warning filters and the warning hook are restored."""
    modes = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    filters, hook = list(warnings.filters), warnings.showwarning
    with pytest.raises(ValueError, match="planted"):
        with obs.tracing(count_syncs=True) as tr:
            with obs.span("step.refine"):
                with obs.span("sdf.march"):
                    for _ in range(3):
                        warnings.warn(obs.SYNC_MESSAGE + ", planted")
                warnings.warn(obs.SYNC_MESSAGE)
            counted = tr.take()[1]
            raise ValueError("planted")
    assert counted == {("step.refine/sdf.march", "sync"): 3, ("step.refine", "sync"): 1}
    assert modes == ["warn", 0]
    assert warnings.filters == filters and warnings.showwarning is hook
    assert obs.span("x") is obs.NO_SPAN


class _SyncingBackward(torch.autograd.Function):
    """Identity whose backward warns as a sync would: once with no span
    of its own, twice inside ``hash_scatter.cotangent``."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        warnings.warn(obs.SYNC_MESSAGE + ", planted in a backward")
        with obs.span("hash_scatter.cotangent"):
            for _ in range(2):
                warnings.warn(obs.SYNC_MESSAGE + ", planted in a backward")
        return g


def test_backward_syncs_count_against_the_backward_spans(monkeypatch):
    """A sync warned by Python code inside a custom Function's backward
    counts under the span open there, or else under the ``backward``
    span around the call into autograd."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda mode: None)
    x = torch.ones(4, requires_grad=True)
    with obs.tracing(count_syncs=True) as tr:
        with obs.span("step.refine"):
            total = _SyncingBackward.apply(x * 2.0).sum()
            with obs.span("backward"):
                (g,) = torch.autograd.grad(total, [x])
        rows, counted = tr.take()
    assert torch.equal(g, torch.full((4,), 2.0))
    assert counted == {("step.refine/backward", "sync"): 1,
                       ("step.refine/backward/hash_scatter.cotangent", "sync"): 2}
    cot = [r for r in rows if r[0] == "hash_scatter.cotangent"]
    assert len(cot) == 1 and rows[cot[0][3]][0] == "backward"


def test_other_warnings_pass_through_while_counting(recwarn):
    """Only sync warnings are counted; others reach the hook that was
    there before, as before."""
    with obs.tracing(count_syncs=True) as tr:
        with obs.span("s"):
            warnings.warn("something else", RuntimeWarning)
        _, counters = tr.take()
    assert counters == {}
    assert [str(w.message) for w in recwarn] == ["something else"]


def test_phase_timers_track_times_into_a_row():
    """``PhaseTimers.track`` times into its totals and into ``into`` with
    one clock, and adds to both on each call."""
    timers, row = obs.PhaseTimers(), {}
    with obs.tracing() as tr:
        for _ in range(2):
            with timers.track("pnp", into=row):
                with obs.span("inner"):
                    pass
        rows, _ = tr.take()
    assert [r[0] for r in rows] == ["inner", "inner"]
    assert row == {"pnp": timers.totals["pnp"]} and timers.counts == {"pnp": 2}
    inner = sum(r[2] - r[1] for r in rows) * 1e-9
    assert inner <= timers.totals["pnp"] < inner + 1.0
    assert not hasattr(obs, "TIMERS")
