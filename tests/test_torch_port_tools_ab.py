"""The diagnosis's usage and the A/B against the JAX script's loss path
(see ``test_torch_port_tools.py``, whose tolerances these share).
Kept apart so that it runs after the suite's long files have started: pytest-xdist's loadfile queue starts the files with more tests first.
"""
import numpy as np

from test_torch_port_tools import AB, SMALL, _jax_ab, script_ab, small_ab  # noqa: F401


def test_diag_without_a_run_dir_prints_its_usage(capsys):
    """``python -m ...diag_frontier_pnp`` exits with ``main``'s status."""
    from level_s2fm_tpu_torch import diag_frontier_pnp as diag
    for argv in ([], ["--cpu"]):
        assert diag.main(argv) == 2
        assert "RUN_DIR" in capsys.readouterr().err


def test_ab_arms_match_the_jax_loss_path(small_ab):
    import jax
    from level_s2fm_tpu.fields import radiance as jradf, sdf as jsdf
    from level_s2fm_tpu.config import Opt
    tab = small_ab
    opt = script_ab()[0]("uniform128", AB["hw"], AB["hw"], AB["rays"])
    opt["SDF"]["Hash_config"].update(SMALL)
    opt = Opt(opt)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    params_np = jax.tree.map(np.asarray, {
        "sdf": jsdf.init_params(k1, jsdf.config_from_opt(opt)),
        "rad": jradf.init_params(k2, jradf.config_from_opt(opt))})
    want = _jax_ab(params_np)
    got = tab.run(device="cpu", params0=params_np, **AB)
    for mode in tab.ARMS:
        losses, psnr = want[mode]
        g = got[mode]
        assert len(g["losses"]) == AB["steps"] and np.isfinite(g["psnr_heldout_fg"])
        assert abs(g["losses"][0] - losses[0]) <= 1e-5 * abs(losses[0]), (mode, g["losses"], losses)
        if mode == "adaptive":
            continue
        for a, b in zip(g["losses"][1:], losses[1:]):
            assert abs(a - b) <= 1e-3 * abs(b), (mode, g["losses"], losses)
        assert abs(g["psnr_heldout_fg"] - psnr) <= 1e-3 * abs(psnr), (mode, g, psnr)
        assert g["rays_per_s"] > 0 and g["train_s"] > 0
