"""The render and its gradients against the JAX package (see
``test_torch_port_renderer.py``).
Kept apart so that it runs after the suite's long files have started: pytest-xdist's loadfile queue starts the files with more tests first.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from level_s2fm_tpu.rendering import renderer as jren
from level_s2fm_tpu_torch.convert import params_from_jax
from level_s2fm_tpu_torch.rendering import renderer as tren

from test_torch_port_renderer import TOL, _tocc, setup  # noqa: F401
from torch_port_helpers import rel_err


@pytest.mark.parametrize("compact", [True, False])
def test_render_and_gradients_match_jax(setup, compact):
    opt_t, pnp, jp, jcfgs, tcfgs, c, r, jocc = setup
    if not compact:
        jcfgs = (*jcfgs[:2], dataclasses.replace(jcfgs[2], compact_samples=None))
        tcfgs = (*tcfgs[:2], dataclasses.replace(tcfgs[2], compact_samples=None))
    keys = ("rgb", "depth_mlp", "normal_mlp", "opacity")
    ws = {k: np.random.default_rng(i).normal(size=(2, 45, 3 if "rgb" in k or "normal" in k
                                                    else 1)).astype(np.float32)
          for i, k in enumerate(keys)}

    def jloss(p):
        out = jren.render(p["sdf"], jcfgs[0], p["rad"], jcfgs[1], jcfgs[2],
                          jnp.asarray(c), jnp.asarray(r), occ_grid=jocc)
        return sum(jnp.sum(out[k] * ws[k]) for k in keys), out

    (_, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    tp = params_from_jax(pnp, device="cpu")
    for leaf in (tp["sdf"]["table"], tp["sdf"]["beta"],
                 tp["rad"]["rad_mlp"]["layers"][0]["V"]):
        leaf.requires_grad_(True)
    out = tren.render(tp["sdf"], tcfgs[0], tp["rad"], tcfgs[1], tcfgs[2],
                      torch.as_tensor(c), torch.as_tensor(r), occ_grid=_tocc(jocc))
    sum((out[k] * torch.as_tensor(ws[k])).sum() for k in keys).backward()
    for k in (*keys, "sdfs_volume", "normals"):
        assert out[k].shape == jout[k].shape, k
        assert rel_err(out[k].detach(), jout[k]) < TOL, k
    assert rel_err(tp["sdf"]["table"].grad, jg["sdf"]["table"]) < 1e-4
    assert rel_err(tp["sdf"]["beta"].grad, jg["sdf"]["beta"]) < 1e-4
    assert rel_err(tp["rad"]["rad_mlp"]["layers"][0]["V"].grad,
                   jg["rad"]["rad_mlp"]["layers"][0]["V"]) < 1e-4
