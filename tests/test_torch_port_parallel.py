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
import numpy as np
import pytest
import torch

from level_s2fm_tpu_torch.parallel import distributed as pdist
from level_s2fm_tpu_torch.sfm import bundle as tbundle
from level_s2fm_tpu_torch.sfm import optim as toptim
from level_s2fm_tpu_torch.sfm.pipeline import LevelSfM
from level_s2fm_tpu_torch.train import build_var

from torch_port_helpers import torch_opt

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
