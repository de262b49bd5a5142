"""The data-parallel helpers, the gradient sum over gloo, the engine's
writes at two ranks and the CLI at two CPU ranks (see
``test_torch_port_parallel.py``). Kept apart so that each test file
holds at most five tests: pytest-xdist's loadfile queue starts the
files with more tests first.
"""
import numpy as np
import pytest
import torch

from level_s2fm_tpu_torch.parallel import distributed as pdist
from level_s2fm_tpu_torch.parallel import mesh as pmesh
from level_s2fm_tpu_torch.sfm import optim as toptim
from level_s2fm_tpu_torch.sfm import optstate
from level_s2fm_tpu_torch.sfm.pipeline import LevelSfM
from level_s2fm_tpu_torch.train import build_var

from test_torch_port_parallel import _two_threads  # noqa: F401
from torch_port_helpers import TINY_ARGS, torch_opt


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
