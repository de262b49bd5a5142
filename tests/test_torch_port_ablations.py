"""The port's ablation runs and checkpoints against the JAX package, on
the CPU at small sizes: the ``tri_trad`` + ``ba_trad`` run through the
port's CLI (held to the bars of ``tests/test_trad_ablations.py``),
``polish_trad_ba`` on its checkpoint (read back by both packages), and
the ``dual_field`` ablation: its parameters, its render and gradients
(1e-5 absolute on the render [1e-6], 1e-4 of each leaf's largest
gradient entry [4e-6]), and checkpoints with their optimizer state
moved either way, every leaf's moments checked bit for bit on that leaf.
"""
import os

import numpy as np
import torch

import jax
import jax.numpy as jnp

from level_s2fm_tpu.fields import radiance as jradf
from level_s2fm_tpu.sfm import optim as joptim
from level_s2fm_tpu.sfm import optstate as jos
from level_s2fm_tpu.utils import checkpoint as jck
from level_s2fm_tpu_torch.convert import params_from_jax
from level_s2fm_tpu_torch.fields import radiance as tradf
from level_s2fm_tpu_torch.sfm import optim as toptim
from level_s2fm_tpu_torch.sfm import optstate as tos
from level_s2fm_tpu_torch.utils import checkpoint as tck

import pytest

from torch_port_helpers import (dlt_scene, jax_opt, jax_params_np, rel_err,
                                render_both, sphere_rays, torch_opt, visible_params)

DUAL = ["--Ablate_config.dual_field"]

#: tests/test_trad_ablations.py's arguments, at small hash widths and 5
#: march steps, without per-view artifacts
TRAD_ARGS = ["--yaml=configs/synthetic.yaml", "--optim.init.max_iter=20",
             "--optim.geoinit.max_iter=3", "--optim.ba.max_iter=60",
             "--sfm_mode=fast", "--Ablate_config.tri_trad",
             "--Ablate_config.ba_trad", "--data.n_views=3",
             "--SDF.Hash_config.n_levels=4", "--SDF.Hash_config.log2_hashmap_size=12",
             "--SDF.arch.layers=[null,16,8]", "--RadF.arch.layers=[null,16,16,3]",
             "--SDF.VolSDF.iters_max_st=5", "--freq.vis=0", "--cpu"]


@pytest.fixture(scope="module")
def trad_run(tmp_path_factory):
    from level_s2fm_tpu_torch import train
    out = str(tmp_path_factory.mktemp("trad"))
    return train.main(TRAD_ARGS + ["--max_views=3", f"--output_path={out}"]), out


def test_trad_run_meets_the_jax_tests_bars(trad_run):
    """All three views register, > 30 points, median | |X| - 0.5 | < 0.1
    (DLT from near-GT poses on noiseless data puts the points on the
    sphere)."""
    m, _ = trad_run
    assert list(m.camera_set.cam_ids) == [0, 1, 2] and not m.skipped_views
    assert len(m.point_set) > 30
    r = np.linalg.norm(m.point_set.all_xyzs(), axis=-1)
    assert np.median(np.abs(r - 0.5)) < 0.1
    assert m.view_log[-1]["reproj_px"] < 1.0


def test_polish_trad_ba_writes_a_checkpoint_both_packages_read(trad_run):
    from level_s2fm_tpu_torch import polish_trad_ba
    _, out = trad_run
    ckpt = os.path.join(out, "model.ckpt")
    with open(ckpt, "rb") as f:
        before = f.read()
    res = polish_trad_ba.main([out] + TRAD_ARGS + ["--cycles=1", "--iters=50"])
    with open(ckpt, "rb") as f:
        assert f.read() == before
    path = os.path.join(out, "model_polished.ckpt")
    assert res["path"] == path and len(res["cycles"]) == 1
    assert all(np.isfinite(v) for v in res["cycles"][0].values())
    tparams, tcam, tpts, _ = tck.restore_checkpoint_sfm(path, device="cpu")
    jparams, jcam, jpts, _ = jck.restore_checkpoint_sfm(path)
    np.testing.assert_array_equal(np.asarray(tcam["pose_para"]),
                                  np.asarray(jcam["pose_para"]))
    np.testing.assert_array_equal(tpts["xyzs"], np.asarray(jpts["xyzs"]))
    np.testing.assert_array_equal(tparams["sdf"]["table"].numpy(),
                                  np.asarray(jparams["sdf"]["table"]))



@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_dual_field_checkpoint_moments_land_on_their_leaves(direction, tmp_path):
    """Each leaf's saved moments are a function of that leaf (mu = 2 p,
    nu = |p| + 1), so adopting them on any other leaf of the same shape
    would show."""
    jos.reset()
    tos.reset()
    labels, lrs = {"sdf": "sdf", "rad": "color"}, {"sdf": 1e-3, "color": 1e-2}
    pnp = visible_params(jax_opt(DUAL))
    _, (jcs, jps), (tcs, tps) = dlt_scene(n_views=2)
    path = str(tmp_path / "dual.ckpt")
    try:
        if direction == "jax_to_port":
            jparams = jax.tree.map(jnp.asarray, pnp)
            tx = joptim.make_phase_optimizer(jparams, labels, lrs, 0.99)
            leaves, treedef = jax.tree_util.tree_flatten(jax.jit(tx.init)(jparams))
            # the flat layout: per label a count, one [2, *shape] per leaf
            # of that label in parameter order, the schedule count
            params_iter = iter([x for lab in ("color", "sdf") for k in sorted(pnp)
                                if labels[k] == lab for x in jax.tree.leaves(pnp[k])])
            filled = []
            for leaf in leaves:
                if leaf.dtype == jnp.int32:
                    filled.append(np.asarray(7, np.int32))
                else:
                    p = next(params_iter)
                    filled.append(np.stack([2 * p, np.abs(p) + 1]))
            jos.record("refine", jax.tree_util.tree_unflatten(treedef, filled))
            jck.save_checkpoint_sfm(path, jparams, jcs, jps, it=1)
            params, _, _, _ = tck.restore_checkpoint_sfm(path, device="cpu")
            opt = tos.adopt("refine", toptim.PhaseAdam(params, labels, lrs, 0.99))
            assert opt.count == 7 and tos.ADOPTED[-1][0] == "refine"
            names = [n for n in ("geo_mlp", "rad_mlp", "table")]
            assert sorted(params["rad"]) == names
            for p, mu, nu in zip(opt.leaves, opt.mu, opt.nu):
                assert torch.equal(mu, 2 * p) and torch.equal(nu, p.abs() + 1)
        else:
            tparams = params_from_jax(pnp, device="cpu")
            opt = toptim.PhaseAdam(tparams, labels, lrs, 0.99)
            with torch.no_grad():
                for p, mu, nu in zip(opt.leaves, opt.mu, opt.nu):
                    mu.copy_(2 * p)
                    nu.copy_(p.abs() + 1)
            opt.count = 7
            tos.record("refine", opt)
            tck.save_checkpoint_sfm(path, tparams, tcs, tps, it=1)
            params, _, _, _ = jck.restore_checkpoint_sfm(path)
            fresh = jax.jit(joptim.make_phase_optimizer(params, labels, lrs, 0.99).init)(
                params)
            adopted = jax.tree_util.tree_leaves(jos.adopt("refine", fresh))
            moments = [np.asarray(a) for a in adopted if np.asarray(a).dtype == np.float32]
            ordered = [x for lab in ("color", "sdf") for k in sorted(params)
                       if labels[k] == lab for x in jax.tree.leaves(params[k])]
            assert len(moments) == len(ordered)
            for m, p in zip(moments, ordered):
                p = np.asarray(p)
                assert np.array_equal(m[0], 2 * p) and np.array_equal(m[1], np.abs(p) + 1)
    finally:
        jos.reset()
        tos.reset()


def test_dual_field_config_and_parameters():
    """Keys and widths; at configs/synthetic.yaml's widths the decoder's
    input grows by the 16 features of the second geometry MLP."""
    from level_s2fm_tpu_torch.config import build_options
    full = [tradf.config_from_opt(build_options(["--yaml=configs/synthetic.yaml"] + x))
            for x in ([], DUAL)]
    assert full[1].dual_field and full[1].input_enc_dim == full[0].input_enc_dim + 16
    cfg = tradf.config_from_opt(torch_opt(DUAL))
    p = tradf.init_params(cfg, torch.Generator().manual_seed(0))
    jp = jax_params_np(jax_opt(DUAL))["rad"]
    assert sorted(p) == sorted(jp) == ["geo_mlp", "rad_mlp", "table"]
    for a, b in zip(toptim.tree_leaves(p), jax.tree.leaves(jp)):
        assert tuple(a.shape) == b.shape
    assert cfg.input_enc_dim == jradf.config_from_opt(jax_opt(DUAL)).input_enc_dim


def test_dual_field_render_and_gradients():
    o, d = sphere_rays()
    jout, jg, tout, tg, tp = render_both(DUAL, o, d)
    for k in ("rgb", "depth_mlp", "opacity"):
        np.testing.assert_allclose(tout[k].detach().numpy(), np.asarray(jout[k]),
                                   rtol=0, atol=1e-5, err_msg=k)
    jl = jax.tree.leaves(jg)
    tl = [tg[id(x)] for x in toptim.tree_leaves(tp)]
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        assert rel_err(a.numpy(), np.asarray(b)) <= 1e-4
    # the dual table learns from the render
    g_table = tg[id(tp["rad"]["table"])]
    assert float(g_table.abs().sum()) > 0
