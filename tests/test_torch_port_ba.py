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
from level_s2fm_tpu_torch.config import build_options
from level_s2fm_tpu_torch.fields import sdf as tsdf
from level_s2fm_tpu_torch.sfm import bundle as tbundle
from level_s2fm_tpu_torch.sfm import optim as toptim
from level_s2fm_tpu_torch.sfm import optstate as tos
from level_s2fm_tpu_torch.sfm import phases as tphases

from torch_port_helpers import TINY_ARGS, two_view_state

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


@pytest.mark.parametrize("mode", ["sfm_refine", "refine"])
def test_rendering_steps_match(state, mode):
    """BA ``sfm_refine`` of view 1 alone (pose cotangents through the
    composite) and ``RefinePhase`` over both views, three steps each."""
    jm, tm = state
    if mode == "sfm_refine":
        jb, js, tb, ts = _bundlers(state, [1], "sfm_refine")
        jphase, tphase = jb.phase, tb.phase
        jbatch, tbatch = dict(jb.batch), dict(tb.batch)
    else:
        jr = jbundle.Refiner(jm.opt, jm.cfgs, jm.camera_set, jm.point_set)
        tr = tbundle.Refiner(tm.opt, tm.cfgs, tm.camera_set, tm.point_set,
                             device="cpu")
        _batches_match(tr.batch, jr.batch)
        jphase, tphase = jr.phase, tr.phase
        jbatch, tbatch = dict(jr.batch), dict(tr.batch)
        js = jphase.init_state(jm.params)
        ts = tphase.init_state(_tree_to(tm.params, "cpu"))
    jbatch["occ"] = jbundle.maybe_build_occ(jm.opt, jm.cfgs, js["params"])
    tbatch["occ"] = tbundle.maybe_build_occ(tm.opt, tm.cfgs, ts["params"])
    C, HW = tbatch["images"].shape[:2]
    n_rays = min(tm.cfgs.rand_rays // C, HW)
    for i in range(3):
        key = jax.random.PRNGKey(20 + i)
        if mode == "sfm_refine" and i == 2:
            _start_from_jax(ts, js)
        js, jmet = jphase.step(js, jbatch, key)
        tmet = tphase.step(ts, tbatch, None,
                           **_render_draws(key, HW, n_rays, tbatch["n_real"]))
        _check_metrics(tmet, jmet, i)
        if mode == "sfm_refine" and i == 0:
            _poses_match(ts, js, 1e-6)
    assert float(jmet["rgb"]) > 0 and float(jmet["tracing_loss"]) > 0
    if mode == "sfm_refine":
        moved = ts["params"]["se3_r"].detach().numpy() - tm.camera_set(1).se3[:3]
        assert np.abs(moved).max() > 1e-3      # the pose did move
        _poses_match(ts, js, 5e-4)


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
    jbatch["occ"] = jbundle.maybe_build_occ(jm.opt, jm.cfgs, js["params"])
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


@pytest.mark.parametrize("grads", ["identical", "drawn"])
def test_phase_adam_is_adam_stacked_to_the_last_bit(grads):
    """``PhaseAdam``'s float32 rounding: five updates equal
    ``jit(adam_stacked(...).update)``'s (through the JAX package's phase
    optimizer: per-label lr, the shared gamma) to 0 ulp, for one
    gradient repeated and for fresh gradients, of magnitudes 1e-6..10."""
    from level_s2fm_tpu.sfm import optim as joptim
    rng = np.random.default_rng(5)

    def draw(shapes):
        return {k: {n: (10.0 ** rng.uniform(-6, 1, sh) * rng.choice([-1, 1], sh))
                    .astype(np.float32) for n, sh in d.items()}
                for k, d in shapes.items()}

    shapes = {"sdf": {"table": (3, 700), "w": (16,)}, "rad": {"w": (300,)}}
    p0 = draw(shapes)
    gamma = joptim.decay_gamma(1e-3, 1e-4, 500)
    labels, lrs = {"sdf": "sdf", "rad": "color"}, {"sdf": 1e-3, "color": 1e-2}
    tx = joptim.make_phase_optimizer(p0, labels, lrs, gamma)
    st = tx.init(jax.tree.map(jnp.asarray, p0))
    opt = toptim.PhaseAdam({k: {n: torch.tensor(v) for n, v in d.items()}
                            for k, d in p0.items()}, labels, lrs, gamma)
    update = jax.jit(tx.update)
    g = draw(shapes)
    for _ in range(5):
        if grads == "drawn":
            g = draw(shapes)
        ju, st = update(jax.tree.map(jnp.asarray, g), st)
        tu = opt.updates([torch.tensor(x) for x in jax.tree.leaves(g)])
        for a, b in zip(tu, jax.tree.leaves(ju)):
            np.testing.assert_array_equal(a.numpy().view(np.int32),
                                          np.asarray(b).view(np.int32))


def test_frozen_label_gets_no_moments_and_no_update():
    p = {"sdf": {"x": torch.ones(3)}, "rad": {"y": torch.full((2,), 2.0)}}
    opt = toptim.PhaseAdam(p, {"sdf": "sdf", "rad": toptim.FROZEN},
                           {"sdf": 0.1}, gamma=1.0)
    assert len(opt.leaves) == len(opt.mu) == 1 and opt.leaves[0] is p["sdf"]["x"]
    y0 = p["rad"]["y"].clone()
    tphases.guarded_update(opt, [torch.ones(3)])
    assert torch.equal(p["rad"]["y"], y0)
    assert not torch.equal(p["sdf"]["x"], torch.ones(3))


def test_surface_projection_gradcheck():
    """BA's reprojection loss differentiates the analytic normal inside
    ``get_surface_pts`` w.r.t. the table and the MLP: the fused sdf and
    normal pass gradcheck in f64, and ``get_surface_pts``'s gradient is
    that of pts - n * sdf / |n| with |n| held constant (the divisor is
    detached, as the JAX package's stop_gradient does)."""
    opt = build_options(TINY_ARGS + ["--SDF.Hash_config.n_levels=2",
                                     "--SDF.Hash_config.log2_hashmap_size=5",
                                     "--SDF.arch.layers=[null,4,2]"])
    cfg = tsdf.config_from_opt(opt)
    gen = torch.Generator().manual_seed(0)
    params = tsdf.init_params(cfg, gen)
    table = (params["table"] + 0.05 * torch.randn(
        params["table"].shape, generator=gen)).double().requires_grad_(True)
    layers = [{k: v.double() for k, v in lay.items()}
              for lay in params["mlp"]["layers"]]
    w = layers[0]["V"].requires_grad_(True)
    pts = (0.5 * torch.randn(5, 3, generator=gen)).double()

    def field(table, w):
        return {"table": table,
                "mlp": {"layers": [dict(layers[0], V=w)] + layers[1:]}}

    def sdf_and_normal(table, w):
        s, _, n = tsdf.infer_all_with_normal(field(table, w), cfg, pts)
        return s, n

    assert torch.autograd.gradcheck(sdf_and_normal, (table, w), eps=1e-6,
                                    atol=1e-5)
    surf, _ = tsdf.get_surface_pts(field(table, w), cfg, pts)
    s, n = sdf_and_normal(table, w)
    denom = torch.linalg.norm(n, dim=-1, keepdim=True).detach()
    want = pts - n / denom * s
    torch.testing.assert_close(surf, want)
    cot = torch.randn(surf.shape, generator=gen, dtype=torch.float64)
    for a, b in zip(torch.autograd.grad(surf, (table, w), cot),
                    torch.autograd.grad(want, (table, w), cot)):
        torch.testing.assert_close(a, b)


@pytest.mark.gpu
def test_sfm_refine_step_on_gpu_matches_cpu(gpu, state):
    """One ``BAPhase('sfm_refine')`` step on the card (K1/K2) against the
    CPU's plain path from the same state and draws: losses to 1e-3
    relative, the se3 gradient to 1e-3 of its largest entry."""
    from level_s2fm_tpu_torch.rendering import fused_composite as fc
    _, tm = state
    out = {}
    for dev in ("cpu", "cuda"):
        tb = tbundle.Bundler(tm.opt, tm.cfgs, copy.deepcopy(tm.camera_set),
                             tm.point_set, cam_pick_ids=[1], mode="sfm_refine",
                             device=dev)
        se3 = tm.camera_set.all_se3(tb.padded_ids)
        params = {"sdf": _tree_to(tm.params["sdf"], dev),
                  "rad": _tree_to(tm.params["rad"], dev),
                  "se3_r": torch.as_tensor(se3[:, :3]).to(dev),
                  "se3_t": torch.as_tensor(se3[:, 3:]).to(dev)}
        st = tb.phase.init_state(params, tb.xyzs0)
        batch = dict(tb.batch)
        batch["occ"] = tbundle.maybe_build_occ(tm.opt, tm.cfgs, params)
        HW = tm.cfgs.H * tm.cfgs.W
        loss, metrics, _ = tb.phase._losses(params, st["xyzs"], batch, None,
                                            rays_idx=torch.arange(HW), trace_cam=0)
        total = tb.phase.objective(loss, metrics)
        before = dict(fc.LAUNCHES)
        g = torch.autograd.grad(total, (params["se3_r"], params["se3_t"]))
        if dev == "cuda":
            assert fc.LAUNCHES["bwd"] > before["bwd"]
        out[dev] = ({k: float(v.detach()) for k, v in {**loss, **metrics}.items()},
                    torch.cat(g, 1).cpu())
    for k, v in out["cpu"][0].items():
        assert abs(out["cuda"][0][k] - v) <= 1e-3 * max(abs(v), 1e-6), k
    gc, gg = out["cpu"][1], out["cuda"][1]
    assert (gg - gc).abs().max() <= 1e-3 * gc.abs().max()
    assert gc.abs().max() > 0


def _tree_to(tree, dev):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(dev).clone()
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return [_tree_to(v, dev) for v in tree]
