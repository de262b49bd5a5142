"""Neural bundle adjustment and the rendering refine in the port against
the JAX package, on the CPU at the tiny widths.

Both sides start from the JAX package's two-view start copied into the
port (``torch_port_helpers.two_view_state``) and build their batches
with their own ``Bundler`` / ``Refiner``. Three steps each of
``BAPhase('sfm')`` (local BA over both views; deterministic),
``BAPhase('sfm_refine')`` (view 1 alone, so the pose gradient flows
through the rendered rays, the march and the composite) and
``RefinePhase`` run on both sides with the JAX draws (rays, tracing
camera) replayed for the port. At 16x16 a single camera's ray budget
covers every pixel.

Tolerances (measured margins in brackets): each loss term of each step
agrees to 2e-4 relative or 1e-6 absolute. The first step agrees to 1e-7
relative [6e-8; the sdf at the surface points, ~5e-4, to 3e-8
absolute]. Adam moves every hash-table entry by lr per step whatever
the size of its gradient, so an entry whose gradient is rounding noise
on both sides can move either way: after two steps of sfm_refine the
tables differ by up to 1.3e-4 (lr_sdf = 1e-4), and the normals, which
differentiate the table, carry that into the eikonal term [1.2e-4
relative at step 3]. The poses: Adam's first step moves each se3 entry
by exactly lr times the sign of its gradient, so after it they agree to
1e-6, which pins the sign of every pose-gradient component; after three
steps, 1e-5 in pure-reprojection BA [3e-7] and 5e-4 through the render
[1.9e-4: one component's gradient changes sign between steps, so its
Adam update feels the table difference]. The carried surface points
agree to 1e-5.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from level_s2fm_tpu.sfm import bundle as jbundle
from level_s2fm_tpu_torch.sfm import bundle as tbundle
from level_s2fm_tpu_torch.sfm import optim as toptim
from level_s2fm_tpu_torch.sfm import optstate as tos

from torch_port_helpers import jit_jax_occ, two_view_state

RTOL = 2e-4


@pytest.fixture(scope="module")
def state():
    with pytest.MonkeyPatch.context() as mp:
        yield two_view_state(n_views=2, monkeypatch=mp)


@pytest.fixture
def gpu():
    """Skips unless a CUDA card is present (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _to_np(x):
    if isinstance(x, dict):
        return {k: _to_np(v) for k, v in x.items()}
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _batches_match(tb, jb):
    for k, v in jb.items():
        if isinstance(v, dict):
            _batches_match(tb[k], v)
            continue
        np.testing.assert_allclose(np.asarray(_to_np(tb[k]), np.float64),
                                   np.asarray(v, np.float64), rtol=0, atol=1e-5,
                                   err_msg=k)


def _render_draws(key, HW, n_rays, n_real):
    """The draws of the JAX ``render_core``, replayed for the port."""
    k_rays, _, k_cam, _ = jax.random.split(key, 4)
    rays_idx = np.array(jax.random.permutation(k_rays, HW)[:n_rays])
    cam = int(jax.random.randint(k_cam, (), 0, jnp.asarray(n_real, jnp.int32)))
    return {"rays_idx": torch.as_tensor(rays_idx), "trace_cam": cam}


def _check_metrics(tmet, jmet, i):
    for k, v in jmet.items():
        np.testing.assert_allclose(float(tmet[k]), float(v), rtol=RTOL, atol=1e-6,
                                   err_msg=f"step {i} {k}")


def _bundlers(state, ids, mode):
    jm, tm = state
    jb = jbundle.Bundler(jm.opt, jm.cfgs, copy.deepcopy(jm.camera_set),
                         jm.point_set, cam_pick_ids=ids, mode=mode)
    tb = tbundle.Bundler(tm.opt, tm.cfgs, copy.deepcopy(tm.camera_set),
                         tm.point_set, cam_pick_ids=ids, mode=mode, device="cpu")
    _batches_match(tb.batch, jb.batch)
    np.testing.assert_allclose(tb.xyzs0.numpy(), np.asarray(jb.xyzs0), rtol=0,
                               atol=1e-6)
    assert tb.max_iter == jb.max_iter and tb.padded_ids == jb.padded_ids
    se3 = jm.camera_set.all_se3(jb.padded_ids)
    jparams = {"sdf": jm.params["sdf"], "rad": jm.params["rad"],
               "se3_r": jnp.asarray(se3[:, :3]), "se3_t": jnp.asarray(se3[:, 3:])}
    tparams = {"sdf": _tree_to(tm.params["sdf"], "cpu"),
               "rad": _tree_to(tm.params["rad"], "cpu"),
               "se3_r": torch.as_tensor(se3[:, :3]),
               "se3_t": torch.as_tensor(se3[:, 3:])}
    return (jb, jb.phase.init_state(jparams, jb.xyzs0),
            tb, tb.phase.init_state(tparams, tb.xyzs0.clone()))


def test_ba_sfm_steps_match_and_rad_stays_frozen(state):
    jb, js, tb, ts = _bundlers(state, [0, 1], "sfm")
    rad0 = [p.clone() for p in toptim.tree_leaves(ts["params"]["rad"])]
    assert not any(p is q for p in ts["opt"].leaves for q in
                   toptim.tree_leaves(ts["params"]["rad"]))
    for i in range(3):
        js, jmet = jb.phase.step(js, jb.batch, jax.random.PRNGKey(i))
        tmet = tb.phase.step(ts, tb.batch, None)
        _check_metrics(tmet, jmet, i)
    assert float(jmet["reproj_px"]) > 0
    _poses_match(ts, js, 1e-5)
    np.testing.assert_allclose(ts["xyzs"].numpy(), np.asarray(js["xyzs"]),
                               rtol=0, atol=1e-5)
    for a, b in zip(toptim.tree_leaves(ts["params"]["rad"]), rad0):
        assert torch.equal(a, b)


def _start_from_jax(ts, js):
    """Give the port's phase state the JAX side's: parameters, carried
    points and Adam moments (the flat optax leaves, through
    ``optstate``). Adam turns a last-bit difference in a hash-table
    entry whose gradient is at rounding level into a whole step of +-lr,
    so after two free-running steps the two sides no longer run the
    same function from the same state; this step compares them from
    one state."""
    with torch.no_grad():
        for a, b in zip(toptim.tree_leaves(ts["params"]),
                        jax.tree.leaves(js["params"])):
            a.copy_(torch.as_tensor(np.array(b)))
        ts["xyzs"] = torch.as_tensor(np.array(js["xyzs"]))
    n_adopted = len(tos.ADOPTED)
    tos.reset()
    tos.load("step2", [np.array(x) for x in jax.tree.leaves(js["opt"])])
    tos.adopt("step2", ts["opt"])
    tos.reset()
    assert tos.ADOPTED[n_adopted:] == [("step2", len(jax.tree.leaves(js["opt"])))]
    assert ts["opt"].count == 2


def _poses_match(ts, js, atol):
    for k in ("se3_r", "se3_t"):
        np.testing.assert_allclose(ts["params"][k].detach().numpy(),
                                   np.asarray(js["params"][k]), rtol=0, atol=atol)


def test_sfm_refine_step_two_ranks_matches_the_jax_mesh(state):
    """One ``BAPhase('sfm_refine')`` step of the port at world 2 (gloo
    ranks as threads: each keeps half of the rays and of the track rows)
    against the JAX package's step under a 2-device ``('data',)`` mesh,
    from the same state and draws: the bars of step 0 above, and the two
    ranks end bit for bit equal."""
    from level_s2fm_tpu.parallel import mesh as jpmesh
    from level_s2fm_tpu_torch.parallel import distributed as tpdist
    jm, tm = state
    jb, js, tb, ts = _bundlers(state, [1], "sfm_refine")
    jbatch, tbatch = dict(jb.batch), dict(tb.batch)
    jbatch["occ"] = jit_jax_occ()(jm.opt, jm.cfgs, js["params"])
    tbatch["occ"] = tbundle.maybe_build_occ(tm.opt, tm.cfgs, ts["params"])
    C, HW = tbatch["images"].shape[:2]
    key = jax.random.PRNGKey(20)
    draws = _render_draws(key, HW, min(tm.cfgs.rand_rays // C, HW),
                          tbatch["n_real"])
    # a fresh trace: the phase's jit would reuse a trace made without the mesh
    step = jax.jit(lambda s_, b_, k_: jb.phase._step_impl(s_, b_, k_))
    with jpmesh.use_mesh(jpmesh.make_mesh(2)):
        js, jmet = step(js, jbatch, key)
    assert len(js["xyzs"].sharding.device_set) == 2       # the tracks were sharded

    def rank(r):
        st = tb.phase.init_state(_tree_to(ts["params"], "cpu"), tb.xyzs0.clone())
        return tb.phase.step(st, tbatch, None, **draws), st

    (met0, st0), (met1, st1) = tpdist.launch_threads(rank, 2)
    _check_metrics(met0, jmet, 0)
    _poses_match(st0, js, 1e-6)
    for a, b in zip(toptim.tree_leaves(st0["params"]),
                    toptim.tree_leaves(st1["params"])):
        assert torch.equal(a, b)
    assert all(torch.equal(met0[k], met1[k]) for k in met0)


def _tree_to(tree, dev):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(dev).clone()
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return [_tree_to(v, dev) for v in tree]
