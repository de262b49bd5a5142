"""The plain reference (``portbench/reference``) held to the port's plain
CPU path at a tiny size: the field's values, normals and march, the pose
maps, and the first steps of every phase the cells drive."""
import numpy as np
import pytest
import torch

from portbench import run
from portbench.reference import field, render, step
from portbench.tests.tiny import SEED, TINY, edits


def _tiny_run(cell):
    return run.Run(cell, SEED, torch.device("cpu"), option_edits=edits(cell))


@pytest.fixture(scope="module")
def init_run():
    return _tiny_run("sphere128-init")


def test_field_matches_the_port(init_run):
    from level_s2fm_tpu_torch.fields import sdf as sdf_mod
    r = init_run
    cfg = field.config(r.options)
    p = r.cell.state["params"]["sdf"]
    scfg = r.cell.phase.cfgs.sdf
    x = (torch.rand(500, 3, generator=torch.Generator().manual_seed(3)) * 2 - 1) * 0.9
    with torch.no_grad():
        s_ref, f_ref, n_ref = field.sdf_feat_normal(p, cfg, x)
        s, f, n = sdf_mod.infer_all_with_normal(p, scfg, x)
        assert torch.equal(field.sdf(p, cfg, x), sdf_mod.infer_sdf(p, scfg, x)[..., 0])
    assert torch.allclose(s_ref, s[..., 0], atol=1e-6)
    assert torch.allclose(f_ref, f, atol=1e-6)
    assert torch.allclose(n_ref, n, atol=1e-5)


def test_march_matches_the_port(init_run):
    from level_s2fm_tpu_torch.fields import sdf as sdf_mod
    r = init_run
    cfg = field.config(r.options)
    p = r.cell.state["params"]["sdf"]
    o, d = r.cell.batch["center_k"], r.cell.batch["ray_k"]
    m = field.march(p, cfg, o.reshape(-1, 3), d.reshape(-1, 3))
    mp = sdf_mod.sphere_march(p, r.cell.phase.cfgs.sdf, o, d)
    n = m["track"].shape[0]
    assert n == mp.last_idx + 1
    assert torch.equal(m["track"], mp.track[:n])
    dep, last, fin, _ = field.reeval(p, cfg, m, o.reshape(-1, 3), d.reshape(-1, 3))
    dp, lp, fp, _ = sdf_mod.sphere_reeval(p, r.cell.phase.cfgs.sdf, mp, o, d)
    assert torch.allclose(dep, dp.reshape(-1), atol=1e-6)
    assert torch.equal(fin, fp[:, 0])


def test_pose_maps_match_the_port():
    from level_s2fm_tpu_torch.geometry import lie
    w = torch.tensor([[0.3, -0.2, 0.1, 0.5, -1.0, 2.0], [1e-6, 0.0, 2e-6, 0.1, 0.2, 0.3]])
    assert torch.allclose(step.se3_to_pose(w), lie.se3_to_SE3(w), atol=1e-6)
    P = lie.se3_to_SE3(w)
    assert torch.allclose(step.pose_to_se3(P), lie.SE3_to_se3(P), atol=1e-5)


def test_occupancy_matches_the_port(init_run):
    from level_s2fm_tpu_torch.sfm import bundle
    r = init_run
    p = r.cell.state["params"]
    occ = bundle.maybe_build_occ(r.opt, r.cell.phase.cfgs, p)
    assert torch.equal(render.occupancy(p["sdf"], field.config(r.options), "cpu"), occ.occ)


@pytest.mark.parametrize("cell", ["sphere128-init", "sphere128-refine",
                                  "sphere128-sfm_refine", "synthhard200-init"])
def test_first_steps_follow_the_port(cell):
    """Each step's loss and gradients, and the change after three steps,
    of the reference against the port's plain path from the same
    parameters and draws."""
    r = _tiny_run(cell)
    prog, states = run.program_numbers(r.cell)
    ref = r.reference_at(r.reference(states), prog["after1"], states)
    nums = r.numbers(prog, ref)
    assert nums["loss_gap"] < 1e-5
    assert max(abs(a - b) / b for a, b in zip(prog["loss"], ref["loss"])) < 1e-4
    assert nums["grad_gap"] < 1e-5
    assert nums["change_gap"] < 1e-4
    first = {k: abs(prog["grads"][0][k] - g) / max(g, 1e-6) for k, g in ref["grads"][0].items()}
    assert max(first.values()) < 1e-5, first
    # the second step's gradient at the program's state reaches the table
    assert ref["grads_at2"]["sdf.table"] > 0.0
    assert abs(prog["grads"][1]["sdf.table"] / ref["grads_at2"]["sdf.table"] - 1) < 1e-5
    assert np.isfinite(ref["loss"]).all()


def test_tiny_options_cut_widths_only():
    for key in TINY:
        assert key.split(".")[0] in ("data", "SDF", "RadF", "Renderer")
