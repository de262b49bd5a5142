"""Checkpoints between the JAX package and the port, and the port's own
save / restore / resume.

Both packages write the same version-3 container (npz + JSON manifest,
``allow_pickle=False``) with the optimizer state in the JAX package's
flat ``optax.multi_transform`` layout, so a checkpoint written by either
is restored by the other. Tolerances: parameters, cameras and points
exact (they are copied, not recomputed); ``infer_sdf`` on 512 seeded
points within 1e-6 (the two packages' float32 evaluations of the same
parameters: measured ~1e-7); the adopted Adam moments equal to the saved
ones bit for bit and not zero (``adopt`` leaves a fresh, zero state on
any mismatch, so equality is what shows the layout is right).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from level_s2fm_tpu.fields import sdf as jsdf
from level_s2fm_tpu.sfm import optim as joptim
from level_s2fm_tpu.sfm import optstate as jos
from level_s2fm_tpu.utils import checkpoint as jck
from level_s2fm_tpu_torch.fields import sdf as tsdf
from level_s2fm_tpu_torch.sfm import optim as toptim
from level_s2fm_tpu_torch.sfm import optstate as tos
from level_s2fm_tpu_torch.utils import checkpoint as tck

from torch_port_helpers import TINY_ARGS, two_view_state

LABELS = {"sdf": "sdf", "rad": "color"}
LRS = {"sdf": 1e-3, "color": 1e-2}
_jit_sdf = jax.jit(lambda p, x, cfg: jsdf.infer_sdf(p, cfg, x), static_argnums=2)


@pytest.fixture(autouse=True)
def _fresh_slots():
    jos.reset()
    tos.reset()
    yield
    jos.reset()
    tos.reset()


@pytest.fixture(scope="module")
def state():
    with pytest.MonkeyPatch.context() as mp:
        yield two_view_state(n_views=3, monkeypatch=mp)


def _pts():
    return np.random.default_rng(7).uniform(-0.6, 0.6, (512, 3)).astype(np.float32)


def _assert_same_sdf(jparams, jcfg, tparams, tcfg):
    a = np.asarray(_jit_sdf(jparams["sdf"], jnp.asarray(_pts()), jcfg))
    b = tsdf.infer_sdf(tparams["sdf"], tcfg,
                       torch.as_tensor(_pts())).detach().numpy()
    assert np.max(np.abs(a - b)) <= 1e-6


def _assert_same_scene(cam_info, pts_info, cameraset, pointset):
    assert [int(c) for c in cam_info["cam_id"]] == list(cameraset.cam_ids)
    assert np.array_equal(np.asarray(cam_info["pose_para"], np.float32),
                          cameraset.all_se3())
    for m, c in zip(cam_info["idx2d_to_3ds"], cameraset.cameras):
        assert np.array_equal(np.asarray(m), c.idx2d_to_3d)
    assert np.array_equal(np.asarray(pts_info["xyzs"]), pointset.all_xyzs())
    assert [[tuple(map(int, e)) for e in t] for t in pts_info["feat_tracks"]] \
        == [[tuple(map(int, e)) for e in t] for t in pointset.tracks]


def test_jax_checkpoint_restores_in_port(state, tmp_path):
    jm, tm = state
    tx = joptim.make_phase_optimizer(jm.params, LABELS, LRS, 0.99)
    fresh = tx.init(jm.params)
    leaves, treedef = jax.tree_util.tree_flatten(fresh)
    rng = np.random.default_rng(3)
    saved = [np.asarray(3, np.int32) if l.dtype == jnp.int32
             else rng.standard_normal(l.shape).astype(np.float32) for l in leaves]
    jos.record("init", jax.tree_util.tree_unflatten(treedef, [jnp.asarray(s) for s in saved]))
    path = str(tmp_path / "jax.ckpt")
    jck.save_checkpoint_sfm(path, jm.params, jm.camera_set, jm.point_set, it=4)

    params, cam_info, pts_info, it = tck.restore_checkpoint_sfm(path, device="cpu")
    assert it == 4
    _assert_same_sdf(jm.params, jm.sdf_cfg, params, tm.sdf_cfg)
    _assert_same_scene(cam_info, pts_info, jm.camera_set, jm.point_set)

    opt = toptim.PhaseAdam(params, LABELS, LRS, 0.99)
    tos.adopt("init", opt)
    assert opt.count == 3
    flat = [x.numpy() for x in tos.flat_state(opt)]
    assert len(flat) == len(saved)
    for a, b in zip(flat, saved):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert all(np.abs(m.numpy()).max() > 0 for m in opt.mu + opt.nu)


def test_port_checkpoint_restores_in_jax(state, tmp_path):
    jm, tm = state
    opt = toptim.PhaseAdam(tm.params, LABELS, LRS, 0.99)
    rng = np.random.default_rng(4)
    with torch.no_grad():
        for m in opt.mu + opt.nu:
            m.copy_(torch.as_tensor(rng.standard_normal(tuple(m.shape)).astype(np.float32)))
    opt.count = 5
    tos.record("init", opt)
    path = str(tmp_path / "port.ckpt")
    tck.save_checkpoint_sfm(path, tm.params, tm.camera_set, tm.point_set, it=2)
    label, saved = tos.snapshot()

    params, cam_info, pts_info, it = jck.restore_checkpoint_sfm(path)
    assert it == 2
    _assert_same_sdf(params, jm.sdf_cfg, tm.params, tm.sdf_cfg)
    _assert_same_scene(cam_info, pts_info, tm.camera_set, tm.point_set)

    tx = joptim.make_phase_optimizer(params, LABELS, LRS, 0.99)
    fresh = tx.init(params)
    adopted = jax.tree_util.tree_leaves(jos.adopt(label, fresh))
    assert len(adopted) == len(saved)
    for a, b in zip(adopted, saved):
        assert np.asarray(a).dtype == b.dtype and np.array_equal(np.asarray(a), b)
    counts = [int(a) for a in adopted if np.asarray(a).dtype == np.int32]
    assert counts and set(counts) == {5}
    assert all(np.abs(np.asarray(a)).max() > 0 for a in adopted
               if np.asarray(a).dtype == np.float32)


def test_adopt_mismatch_keeps_fresh_state_and_disarms(state):
    """A wrong leaf shape leaves the fresh state as it is (zeros, step 0),
    and the slot is disarmed: a later match is not adopted either."""
    _, tm = state
    opt = toptim.PhaseAdam(tm.params, LABELS, LRS, 0.99)
    good = [x.numpy() for x in tos.flat_state(opt)]
    bad = list(good)
    bad[1] = np.zeros((2, 3), np.float32)
    tos.load("init", bad)
    tos.adopt("geoinit", opt)             # another label: stays armed
    tos.adopt("init", opt)
    assert opt.count == 0 and all(float(m.abs().max()) == 0 for m in opt.mu)
    tos.load("init", good)
    tos._armed[0] = False
    tos.adopt("init", opt)
    assert opt.count == 0


def test_loaded_state_survives_a_record_of_another_phase(state):
    """After a restore, a phase of another label records first (a resumed
    registration starts with geoinit); the first phase of the saved label
    still adopts the saved moments, not the in-process record."""
    _, tm = state
    opt = toptim.PhaseAdam(tm.params, LABELS, LRS, 0.99)
    rng = np.random.default_rng(6)
    saved = [np.asarray(7, np.int32) if x.dtype == torch.int32
             else rng.standard_normal(tuple(x.shape)).astype(np.float32)
             for x in tos.flat_state(opt)]
    tos.load("init", saved)
    tos.record("geoinit", toptim.PhaseAdam(tm.params, {"sdf": "sdf", "rad": "frozen"},
                                           {"sdf": 1e-3}, 0.99))
    tos.adopt("init", opt)
    assert opt.count == 7
    for a, b in zip(tos.flat_state(opt), saved):
        assert np.array_equal(a.numpy(), b)
    assert tos.snapshot()[0] == "geoinit"      # a checkpoint saves the newest


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A port run of three views at tiny widths through the CLI entry,
    with its checkpoints (``three_views.ckpt`` keeps the final one)."""
    import shutil
    from level_s2fm_tpu_torch import train
    out = tmp_path_factory.mktemp("port_run")
    argv = TINY_ARGS + ["--cpu", "--data.n_views=4", "--optim.geoinit.max_iter=1",
                        "--optim.ba.max_iter=4", "--optim.refine.max_iter=2",
                        f"--output_path={out}", "--freq.vis=0"]
    tos.reset()
    m = train.main(argv + ["--max_views=3"])
    shutil.copy(os.path.join(out, "model.ckpt"), os.path.join(out, "three_views.ckpt"))
    return m, out, argv
