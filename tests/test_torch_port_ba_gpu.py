"""The ``sfm_refine`` step on the card against the CPU (skips without a
card; see ``test_torch_port_ba.py``).
Kept apart so that it runs after the suite's long files have started: pytest-xdist's loadfile queue starts the files with more tests first.
"""
import copy

import pytest
import torch

from level_s2fm_tpu_torch.sfm import bundle as tbundle

from test_torch_port_ba import _tree_to, state  # noqa: F401


@pytest.fixture(scope="module")
def gpu():
    """Skips unless a CUDA card is present (decided at run time), before
    the module-scoped ``state`` is built for nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


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
