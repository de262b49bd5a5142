"""Restore and resume from the port's own checkpoints, and the older
containers, on the CPU (see ``test_torch_port_checkpoint.py``). Kept
apart so that each test file holds at most five tests: pytest-xdist's
loadfile queue starts the files with more tests first.
"""
import json
import os
import pickle

import numpy as np
import pytest
import torch

from level_s2fm_tpu.utils import checkpoint as jck
from level_s2fm_tpu_torch.sfm import optim as toptim
from level_s2fm_tpu_torch.sfm import optstate as tos
from level_s2fm_tpu_torch.sfm import pipeline as tpipe
from level_s2fm_tpu_torch.utils import checkpoint as tck

from test_torch_port_checkpoint import (  # noqa: F401
    _assert_same_scene, _assert_same_sdf, _fresh_slots, port_run, state)
from torch_port_helpers import _scene_var, torch_opt


def test_restore_rebuilds_the_saved_state(port_run):
    """A fresh engine restores the run's last checkpoint and
    ``_reload_scene``s it: parameters, cameras, points and tracks equal
    the run's."""
    m, out, _ = port_run
    fresh = tpipe.LevelSfM(torch_opt(["--data.n_views=4", f"--output_path={out}"]),
                           seed=1, device="cpu")
    fresh.load_data(_scene_var(4))
    fresh.restore_checkpoint(os.path.join(out, "three_views.ckpt"))
    fresh._reload_scene()
    assert fresh.it == m.it == 1
    for a, b in zip(toptim.tree_leaves(fresh.params), toptim.tree_leaves(m.params)):
        assert torch.equal(a, b.detach())
    _assert_same_scene(m.camera_set.get_parameters(), m.point_set.get_parameters(),
                       fresh.camera_set, fresh.point_set)
    for a, b in zip(fresh.camera_set.cameras, m.camera_set.cameras):
        assert np.array_equal(a.kypts, b.kypts) and np.array_equal(a.img, b.img)
    assert os.path.exists(os.path.join(out, "model_0.ckpt"))   # after the init


def test_resume_registers_the_next_view(port_run):
    """``--resume --max_views=4`` restores the three views, adopts the
    saved moments in the first phase of the same label, registers view
    3, and appends its row to metrics.jsonl."""
    from level_s2fm_tpu_torch import train
    m, out, argv = port_run
    tos.reset()
    n = len(tos.ADOPTED)
    with np.load(os.path.join(out, "model.ckpt"), allow_pickle=False) as z:
        saved = json.loads(str(z["manifest"]))["optim"]
    m4 = train.main(argv + ["--resume", "--max_views=4"])
    assert m4.camera_set.cam_ids == m.camera_set.cam_ids + [3]
    assert [r["view"] for r in m4.view_log] == [3]
    assert tos.ADOPTED[n:] == [(saved["label"], saved["n_leaves"])]
    with open(os.path.join(out, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["view"] for r in rows if "view" in r] == [2, 3]


def test_v3_checkpoint_loads_without_pickle(port_run):
    """The checkpoint written after the init (two cameras, the init's
    optimizer) opens with pickling disabled."""
    _, out, _ = port_run
    with np.load(os.path.join(out, "model_0.ckpt"), allow_pickle=False) as z:
        manifest = json.loads(str(z["manifest"]))
        assert manifest["version"] == 3 and manifest["it"] == 0
        assert manifest["n_cams"] == len(z["cam_id"]) == 2
        assert manifest["optim"]["label"] == "init"
        assert manifest["optim"]["n_leaves"] > 0
        assert all(z[k].dtype != object for k in z.files)


@pytest.mark.parametrize("version", [2, 1])
def test_legacy_pickle_versions(state, tmp_path, version):
    """A version-2 pickle (numpy leaves with their tree paths) restores;
    a version-1 pickle (a pickled JAX treedef) raises and says so."""
    jm, tm = state
    if version == 2:
        payload = {"version": 2,
                   "param_paths": jck._tree_paths(jm.params),
                   "cam_info": jm.camera_set.get_parameters(),
                   "pts_info": jm.point_set.get_parameters(), "it": 6}
    else:
        payload = {"treedef": b"", "leaves": [], "cam_info": {},
                   "pts_info": {}, "it": 0}
    path = tmp_path / "legacy.ckpt"
    path.write_bytes(pickle.dumps(payload))
    if version == 1:
        with pytest.raises(ValueError, match="version-1"):
            tck.restore_checkpoint_sfm(str(path), device="cpu")
        return
    params, cam_info, pts_info, it = tck.restore_checkpoint_sfm(str(path), device="cpu")
    assert it == 6
    _assert_same_sdf(jm.params, jm.sdf_cfg, params, tm.sdf_cfg)
    _assert_same_scene(cam_info, pts_info, jm.camera_set, jm.point_set)
