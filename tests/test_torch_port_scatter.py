"""The ordered scatter (``fields/hash_scatter.py``): the hash grid's table
cotangent summed row by row in ascending contribution index.

On the CPU the wrapper runs its plain version, ``index_add_``. It must be
that sum bit for bit: the sequential reference (``np.add.at``, which adds
in index order) and the kernel's own algorithm written in torch (a stable
sort of the keys, then each segment summed in order) give the same bits.
Its gradients differentiate twice (``gradgradcheck`` in float64), and a
20-step ``InitPhase`` run twice gives equal parameters. The card's kernel
is held against the plain version by the ``gpu`` test and by
``chip_smoke.py`` phase ``hold_scatter``.
"""
import numpy as np
import pytest
import torch

from level_s2fm_tpu_torch.fields import hash_scatter as hs

from torch_port_helpers import torch_opt


@pytest.fixture
def gpu():
    """Skips unless a CUDA card is present (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


def _inputs(n, m, F, seed):
    """Shuffled keys heavy with duplicates (half on 7 rows), cotangents
    spread over 16 binades, so that the order of a sum shows in its bits."""
    rng = np.random.default_rng(seed)
    gi = np.concatenate([rng.integers(0, 7, n // 2), rng.integers(0, m, n - n // 2)])
    gi = gi[rng.permutation(n)]
    g = (rng.standard_normal((n, F)) * np.exp2(rng.integers(-8, 8, (n, 1)))).astype(np.float32)
    return gi, g


def _segment_reference(gi, g, m):
    """The kernel's algorithm in torch: stable sort of the int32 keys,
    then every segment summed from 0 in ascending order (a loop over the
    position within the segment, vectorised over the segments)."""
    keys, perm = torch.sort(gi.to(torch.int32), stable=True)
    starts = torch.ones_like(keys, dtype=torch.bool)
    starts[1:] = keys[1:] != keys[:-1]
    first = torch.nonzero(starts)[:, 0]
    length = torch.diff(torch.cat([first, torch.tensor([len(keys)])]))
    acc = torch.zeros(len(first), g.shape[1], dtype=g.dtype)
    for k in range(int(length.max())):
        live = length > k
        acc[live] = acc[live] + g[perm[first[live] + k]]
    out = torch.zeros(m, g.shape[1], dtype=g.dtype)
    out[keys[first].long()] = acc
    return out


def test_plain_version_is_the_ordered_sum_bitwise():
    for n, m, F in ((20000, 50, 2), (30001, 5000, 1)):
        gi, g = _inputs(n, m, F, seed=n)
        got = hs.ordered_scatter_add(torch.as_tensor(gi), torch.as_tensor(g), m)
        want = np.zeros((m, F), np.float32)
        np.add.at(want, gi, g)
        assert np.array_equal(got.numpy(), want)
        seg = _segment_reference(torch.as_tensor(gi), torch.as_tensor(g), m)
        assert torch.equal(got, seg)
        # another order gives other bits: the inputs do test the order
        rev = np.zeros((m, F), np.float32)
        np.add.at(rev, gi[::-1], g[::-1])
        assert not np.array_equal(rev, want)


def test_gradients_differentiate_twice():
    """gather_rows and the scatter in float64: gradcheck and
    gradgradcheck; take_along_last equals take_along_dim with its
    gradient, bit for bit, on float32."""
    gen = torch.Generator().manual_seed(0)
    flat = torch.randn(9, 2, dtype=torch.float64, generator=gen, requires_grad=True)
    gi = torch.tensor([3, 0, 3, 8, 3, 1, 0])
    g = torch.randn(7, 2, dtype=torch.float64, generator=gen, requires_grad=True)
    assert torch.autograd.gradcheck(lambda t: hs.gather_rows(t, gi), (flat,))
    assert torch.autograd.gradgradcheck(lambda t: hs.gather_rows(t, gi), (flat,))
    assert torch.autograd.gradcheck(lambda t: hs.OrderedScatter.apply(t, gi, 9), (g,))
    assert torch.autograd.gradgradcheck(lambda t: hs.OrderedScatter.apply(t, gi, 9), (g,))
    # a graph built with create_graph through the table gradient
    out = (hs.gather_rows(flat, gi) ** 3).sum()
    (d,) = torch.autograd.grad(out, flat, create_graph=True)
    (dd,) = torch.autograd.grad(d.pow(2).sum(), flat)
    assert torch.isfinite(dd).all() and dd.abs().sum() > 0

    src = torch.randn(4, 5, 12, generator=gen, requires_grad=True)
    idx = torch.sort(torch.randint(0, 12, (4, 5, 7), generator=gen), dim=-1).values
    cot = torch.randn(4, 5, 7, generator=gen)
    a = hs.take_along_last(src, idx)
    b = torch.take_along_dim(src, idx, dim=-1)
    assert torch.equal(a, b)
    (ga,) = torch.autograd.grad(a, src, cot)
    (gb,) = torch.autograd.grad(b, src, cot)
    assert torch.equal(ga, gb)


def test_cuda_entry_refuses_what_it_cannot_launch():
    """The kernel's entry raises on CPU tensors (no fallback) and the
    checks refuse wrong types and shapes before any launch."""
    gi, g = torch.tensor([0, 1, 1]), torch.ones(3, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        hs.scatter_cuda(gi, g, 4)
    for bad_gi, bad_g in ((gi.int(), g), (gi[None], g), (gi, g[:2]), (gi, g[:, 0])):
        with pytest.raises(ValueError):
            hs.check_inputs(bad_gi, bad_g, 4)
    with pytest.raises(ValueError, match="2\\^31"):
        hs.check_inputs(gi, g, 2 ** 31)
    with pytest.raises(ValueError, match="leading shape"):
        hs.take_along_last(torch.zeros(2, 5), torch.zeros(3, 1, dtype=torch.long))


def test_init_phase_repeats():
    """Twenty InitPhase steps at test size (64 rays a view), twice from
    the same state and seed: the parameters agree bit for bit."""
    from level_s2fm_tpu_torch.data import synthetic
    from level_s2fm_tpu_torch.sfm.initialization import Initializer
    from level_s2fm_tpu_torch.sfm.optim import tree_leaves
    from level_s2fm_tpu_torch.sfm import bundle
    from level_s2fm_tpu_torch.sfm.pipeline import LevelSfM

    opt = torch_opt(["--optim.init.max_iter=20", "--Renderer.rand_rays=128"])
    scene = synthetic.make_scene(n_views=2, H=16, W=16, n_points=64, seed=0)
    runs = []
    for _ in range(2):
        model = LevelSfM(opt, seed=0, device="cpu")
        model.load_data(synthetic.scene_to_var(scene))
        var = model.var
        init_var = {"indx_init": [0, 1], "imgs_init": var["images"][:2],
                    "kypts_init": var["kypts"][:2], "intrs_init": var["intrs"][:2],
                    "mchs_init": var["matches"][:2], "inliers_init": var["masks"][:2],
                    "poses_gt": var["poses_gt"]}
        init = Initializer(opt, model.cfgs, model.camera_set, model.point_set,
                           init_var, device="cpu")
        state = init.phase.init_state(model.params)
        batch = dict(init.batch)
        batch["occ"] = bundle.maybe_build_occ(opt, model.cfgs, state["params"])
        gen = torch.Generator().manual_seed(5)
        for _ in range(20):
            init.phase.step(state, batch, gen)
        runs.append([p.detach().clone() for p in tree_leaves(state["params"])])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.gpu
def test_kernel_matches_plain_version_on_gpu(gpu):
    """On the card: bit for bit the CPU's plain version, three calls
    bitwise equal, and within 1e-6 of a row's sum of |contributions| of
    index_add_'s atomics; at random shapes and at the edge shapes of the
    kernel's tile (keys outside [0, m) dropped from the references)."""
    from test_torch_port_scatter_model import KERNEL, _case, edge_cases
    tile = KERNEL["tile"]
    assert hs.sort_tile() == tile    # the model's sizes are the built kernel's
    cases = [_inputs(n, m, F, seed=n) + (m,)
             for n, m, F in ((200000, 50, 2), (300001, 700000, 1), (4096, 10, 4), (100, 3, 8))]
    cases += [_case(name, n, m, F, seed=i) + (m,)
              for i, (name, n, m, F) in enumerate(edge_cases(tile))]
    for gi, g, m in cases:
        keep = (gi >= 0) & (gi < m)
        gi_c, g_c = torch.as_tensor(gi).cuda(), torch.as_tensor(g).cuda()
        want = hs.scatter_plain(torch.as_tensor(gi[keep]), torch.as_tensor(g[keep]), m)
        runs = [hs.ordered_scatter_add(gi_c, g_c, m) for _ in range(3)]
        assert torch.equal(runs[0].cpu(), want), (len(gi), m, g.shape[1])
        assert all(torch.equal(runs[0], r) for r in runs[1:])
        ki, kg = gi_c[torch.as_tensor(keep).cuda()], g_c[torch.as_tensor(keep).cuda()]
        atomic = hs.scatter_plain(ki, kg, m)
        mag = hs.scatter_plain(ki, kg.abs(), m)
        assert float(((runs[0] - atomic).abs() / mag.clamp_min(1e-30)).max()) <= 1e-6
