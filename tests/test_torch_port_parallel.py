"""Data-parallel ranks of the port (``level_s2fm_tpu_torch.parallel``) on
the CPU, against one rank.

The counterpart of the JAX package's ``tests/test_parallel.py``,
``test_sharded_pipeline.py`` and ``test_multihost.py``. The ranks are
gloo ranks running as threads of the test process over one in-memory
store (``distributed.launch_threads``), except in the one CLI case,
which spawns them as processes. One tiny three-view run (full mode, a
few steps per phase) gives every phase its parameters and batch. Row
counts are odd, so the last rank's rows are padded: the rays are given
(255 or 169 of them) and the track and tracing rows are cut to an odd
count.

Bars: one step at two ranks equals one rank to 1e-6 relative in every
loss term (the sums only regroup: measured <= 1.9e-7) and 1e-5 absolute in
every parameter (measured <= 7.5e-9), the JAX package's bar for its sharded BA
(``tests/test_sharded_pipeline.py:93-95``); 20 init steps agree to
2e-4, the amplification the JAX package measured over 20 sharded steps
(``:41``); the two ranks' parameters are equal bit for bit after every
step; and padded rows filled with garbage change no output bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from level_s2fm_tpu_torch.parallel import distributed as pdist
from level_s2fm_tpu_torch.parallel import mesh as pmesh
from level_s2fm_tpu_torch.sfm import bundle as tbundle
from level_s2fm_tpu_torch.sfm import optim as toptim
from level_s2fm_tpu_torch.sfm import optstate
from level_s2fm_tpu_torch.sfm.phases import InitPhase
from level_s2fm_tpu_torch.sfm.pipeline import LevelSfM
from level_s2fm_tpu_torch.train import build_var

from torch_port_helpers import TINY_ARGS, torch_opt

LOSS_RTOL, PARAM_ATOL = 1e-6, 1e-5
RUN_ARGS = ["--data.n_views=3", "--optim.init.max_iter=2",
            "--optim.geoinit.max_iter=1", "--optim.ba.max_iter=2",
            "--optim.refine.max_iter=1"]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads per rank: the ranks are threads of one test
    process, which shares the machine with the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A three-view run and the objects of its stages."""
    opt = torch_opt(RUN_ARGS + ["--output_path=" + str(tmp_path_factory.mktemp("run"))])
    model = LevelSfM(opt, seed=0, device="cpu")
    model.load_data(build_var(opt))
    stages = {}
    model.stage_hook = lambda stage, obj: stages.setdefault(stage, obj)
    assert model.train(max_views=3, verbose=False)
    return model, stages


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return [_clone(v) for v in tree]


def _odd_rows(batch, xyzs=None):
    """The batch with its track and tracing rows cut to an odd count."""
    b = dict(batch)
    if "valid" in b:
        P = b["valid"].shape[0] - 1
        for k in ("pose_idx", "kp", "valid"):
            b[k] = b[k][:P]
        xyzs = xyzs[:P]
    if "tracing" in b:
        Nt = b["tracing"]["mask"].shape[1] - 1
        b["tracing"] = {k: v[:, :Nt] for k, v in b["tracing"].items()}
    return b, xyzs


def _case(run, name):
    """(phase, batch, make_state, step kwargs) of one phase step."""
    model, stages = run
    gen = torch.Generator().manual_seed(7)
    if name == "init":
        init = model.initializer
        batch = dict(init.batch)
        batch["occ"] = tbundle.maybe_build_occ(model.opt, model.cfgs, model.params)
        HW = batch["images"].shape[1]
        kw = {"rays_idx": torch.randperm(HW, generator=gen)[:HW - 1]}
        return init.phase, batch, lambda: init.phase.init_state(
            _clone(model.params)), kw
    if name == "geoinit":
        reg = stages["geo_init"]
        return reg.phase, reg.batch, lambda: reg.phase.init_state(
            _clone(model.params)), {}
    obj = stages[{"ba_sfm": "local_ba", "ba_sfm_refine": "sfm_refine",
                  "refine": "refine"}[name]]
    batch, xyzs = _odd_rows(obj.batch, getattr(obj, "xyzs0", None))
    kw = {}
    if name != "ba_sfm":
        batch["occ"] = tbundle.maybe_build_occ(model.opt, model.cfgs, model.params)
        C, HW = batch["images"].shape[:2]
        n = min(model.cfgs.rand_rays // C, HW)
        kw = {"rays_idx": torch.randperm(HW, generator=gen)[:n - 1 + n % 2],
              "trace_cam": batch["n_real"] - 1}
    if name == "refine":
        return obj.phase, batch, lambda: obj.phase.init_state(
            _clone(model.params)), kw
    se3 = model.camera_set.all_se3(obj.padded_ids)

    def make_state():
        params = {**_clone(model.params), "se3_r": torch.tensor(se3[:, :3]),
                  "se3_t": torch.tensor(se3[:, 3:])}
        return obj.phase.init_state(params, xyzs.clone())
    return obj.phase, batch, make_state, kw


def _steps(phase, batch, make_state, kw, n=1):
    """n steps from a fresh state: (metrics of each step, parameters of
    each step, the carried points gathered)."""
    state = make_state()
    gen = torch.Generator().manual_seed(3)
    mets, params = [], []
    for _ in range(n):
        mets.append({k: v.clone() for k, v in phase.step(state, batch, gen, **kw).items()})
        params.append([p.detach().clone() for p in toptim.tree_leaves(state["params"])])
    xyzs = (pdist.fetch_host(state["xyzs"], batch["valid"].shape[0])
            if "xyzs" in state else None)
    return mets, params, xyzs


def _two_ranks(phase, batch, make_state, kw, n=1):
    return pdist.launch_threads(lambda r: _steps(phase, batch, make_state, kw, n), 2)


def _ranks_equal(ranks):
    (m0, p0, x0), (m1, p1, x1) = ranks
    for a, b in zip(p0, p1):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    for a, b in zip(m0, m1):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert x0 is None or np.array_equal(x0, x1)


PHASES = ["init", "geoinit", "ba_sfm", "ba_sfm_refine", "refine"]


@pytest.mark.parametrize("name", PHASES)
def test_one_step_at_two_ranks_equals_one_rank(run, name):
    phase, batch, make_state, kw = _case(run, name)
    (m1,), (p1,), x1 = _steps(phase, batch, make_state, kw)
    ranks = _two_ranks(phase, batch, make_state, kw)
    _ranks_equal(ranks)
    (m2,), (p2,), x2 = ranks[0]
    assert float(m1["nonfinite"]) == 0.0
    for k, v in m1.items():
        np.testing.assert_allclose(float(m2[k]), float(v), rtol=LOSS_RTOL,
                                   atol=0, err_msg=k)
    for a, b in zip(p2, p1):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=PARAM_ATOL)
    if x1 is not None:
        np.testing.assert_allclose(x2, x1, rtol=0, atol=PARAM_ATOL)


def test_twenty_init_steps_at_two_ranks(run):
    """20 InitPhase steps with the rays drawn by each rank's generator
    (the global draw: two ranks draw what one draws), at 32 rays a
    camera and 3 march steps to keep the test short: the losses agree
    to 2e-4 at every step, and the ranks' parameters are equal bit for
    bit after every step."""
    model = run[0]
    init = model.initializer
    cfgs = dataclasses.replace(model.cfgs, rand_rays=64, sdf=dataclasses.replace(
        model.cfgs.sdf, iters_max=3))
    phase = InitPhase(cfgs, init.phase.weights, max_iter=20)
    batch = dict(init.batch)
    batch["occ"] = tbundle.maybe_build_occ(model.opt, model.cfgs, model.params)

    def make_state():
        return phase.init_state(_clone(model.params))

    m1, _, _ = _steps(phase, batch, make_state, {}, n=20)
    ranks = _two_ranks(phase, batch, make_state, {}, n=20)
    _ranks_equal(ranks)
    for i, (a, b) in enumerate(zip(ranks[0][0], m1)):
        for k in b:
            np.testing.assert_allclose(float(a[k]), float(b[k]), rtol=2e-4,
                                       atol=0, err_msg=f"step {i} {k}")


def _garbage(x, axis, n_pad):
    """Padding rows that would change a result if they entered any sum
    or count: True masks, random indices within the tensor's range, and
    coordinates and targets far from the scene."""
    gen = torch.Generator().manual_seed(11)
    shape = list(x.shape)
    shape[axis] = n_pad
    if x.dtype == torch.bool:
        return torch.ones(shape, dtype=torch.bool)
    if x.is_floating_point():
        return 5.0 * torch.randn(shape, generator=gen, dtype=x.dtype)
    return torch.randint(0, int(x.max()) + 1, shape, generator=gen, dtype=x.dtype)


@pytest.mark.parametrize("name", ["ba_sfm", "ba_sfm_refine", "refine"])
def test_padded_rows_change_nothing(run, name, monkeypatch):
    """Two ranks whose padding rows (the last rank's, of the rays, the
    tracing rows and the track rows) hold garbage give every loss,
    parameter and carried point of the plain padding, bit for bit."""
    phase, batch, make_state, kw = _case(run, name)
    plain = _two_ranks(phase, batch, make_state, kw)
    monkeypatch.setattr(pmesh, "pad_rows", _garbage)
    garbage = _two_ranks(phase, batch, make_state, kw)
    _ranks_equal([plain[0], garbage[0]])
    _ranks_equal([plain[1], garbage[1]])


def test_row_helpers_round_trip():
    """``shard_rows`` / ``fetch_host`` / ``broadcast_host_array`` /
    ``broadcast_object`` / ``global_sum`` / ``replicate`` at three ranks
    over 7 rows (the last rank holds one row and two of padding), and the
    identity with no group."""
    x = torch.arange(14.0).reshape(7, 2)
    assert pmesh.shard_rows(x)[0] is x and pmesh.shard_rows(x)[1] is None
    assert np.array_equal(pdist.fetch_host(x, 5), x.numpy()[:5])

    def rank(r):
        rows, ok = pmesh.shard_rows(x)
        return (rows, ok, pdist.fetch_host(rows, 7),
                pdist.broadcast_host_array(np.full(3, r)),
                pdist.broadcast_object({"tracks": [[(r, 1)]]}),
                pdist.global_sum([torch.tensor(float(r)), ok.sum().float()]),
                pmesh.replicate([torch.full((2,), float(r))])[0])

    out = pdist.launch_threads(rank, 3)
    assert [o[1].tolist() for o in out] == [[True] * 3, [True] * 3,
                                           [True, False, False]]
    assert torch.equal(torch.cat([o[0][o[1]] for o in out]), x)
    for rows, ok, back, arr, obj, sums, rep in out:
        assert np.array_equal(back, x.numpy())
        assert np.array_equal(arr, np.zeros(3)) and obj == {"tracks": [[(0, 1)]]}
        assert [float(s) for s in sums] == [3.0, 7.0]
        assert torch.equal(rep, torch.zeros(2))


@pytest.mark.parametrize("fill", [1e-3, 0.5])
def test_large_gradient_sum_over_gloo(fill):
    """``all_reduce_grads`` over gloo of a gradient of 1 MiB and more
    beside a small one, mostly zeros or dense, a NaN among one rank's
    entries: every rank gets the plain sum."""
    n = 2 ** 18 + 3
    grads = []
    for r in range(2):
        gen = torch.Generator().manual_seed(r)
        g = torch.randn(n, generator=gen) * (torch.rand(n, generator=gen) < fill)
        grads.append(g)
    grads[1][7] = float("nan")
    small = [torch.full((3,), float(r)) for r in range(2)]
    out = pdist.launch_threads(
        lambda r: pdist.all_reduce_grads([grads[r], small[r]]), 2)
    want = grads[0] + grads[1]
    for big, sm in out:
        assert torch.equal(big.nan_to_num(), want.nan_to_num()) and big[7].isnan()
        assert torch.equal(sm, torch.ones(3))


def test_engine_at_two_ranks_writes_on_rank_zero(tmp_path):
    """The engine's two-view init at two thread ranks, each given its
    own output directory: rank 0 writes its checkpoints and metrics,
    rank 1 writes nothing, and both end with the same cameras, points
    and parameters, bit for bit."""
    def rank(r):
        opt = torch_opt(["--optim.init.max_iter=2", f"--output_path={tmp_path}/rank{r}"])
        model = LevelSfM(opt, seed=0, device="cpu")
        model.load_data(build_var(opt))
        model.train(max_views=2, verbose=False)
        return (model.camera_set.all_se3(), model.point_set.all_xyzs(),
                [p.detach() for p in toptim.tree_leaves(model.params)])

    (s0, x0, p0), (s1, x1, p1) = pdist.launch_threads(rank, 2)
    assert np.array_equal(s0, s1) and np.array_equal(x0, x1) and len(x0) > 0
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert (tmp_path / "rank0" / "model.ckpt").exists()
    assert not (tmp_path / "rank1").exists()


def test_cli_two_ranks_on_the_cpu(tmp_path, capsys, monkeypatch):
    """``train.main``, the entry of ``python -m level_s2fm_tpu_torch.train``,
    with ``--cpu --parallel.data_devices=2``, init only: two spawned gloo
    ranks (one intra-op thread each) whose poses and parameters end bit
    for bit equal, rank 0 alone writing, and whose checkpoint matches the
    one-rank run to the JAX package's init bar
    (``tests/test_sharded_pipeline.py:117-121``: 1e-4 in the parameters,
    the same point count)."""
    from level_s2fm_tpu_torch import train
    from level_s2fm_tpu_torch.utils.checkpoint import restore_checkpoint_sfm
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    argv = TINY_ARGS + ["--cpu", "--max_views=2", "--optim.init.max_iter=2"]
    two = train.main(argv + ["--parallel.data_devices=2",
                             f"--output_path={tmp_path}/two"])
    assert ("'ranks': 2, 'backend': 'gloo', 'replicas_equal': True"
            in capsys.readouterr().out)
    assert two["summary"]["ok"] and two["summary"]["ranks"] == 2
    one = train.main(argv + [f"--output_path={tmp_path}/one"])
    p2, _, pts2, _ = restore_checkpoint_sfm(str(tmp_path / "two" / "model.ckpt"),
                                            device="cpu")
    optstate.reset()    # the restore armed the saved moments for adoption
    assert len(pts2["xyzs"]) == len(one.point_set) > 0
    for a, b in zip(toptim.tree_leaves(p2), toptim.tree_leaves(one.params)):
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(), rtol=0, atol=1e-4)
    # the files of a one-rank run, written once
    listing = [sorted(str(f.relative_to(tmp_path / d)) for f in (tmp_path / d).rglob("*"))
               for d in ("two", "one")]
    assert listing[0] == listing[1] and "options.yaml" in listing[0]
    assert "model.ckpt" in listing[0]
