"""Twenty init steps at two ranks against one, on the CPU (see
``test_torch_port_parallel_steps.py``).
Kept apart so that it runs after the suite's long files have started: pytest-xdist's loadfile queue starts the files with more tests first.
"""
import dataclasses

import numpy as np

from level_s2fm_tpu_torch.sfm import bundle as tbundle
from level_s2fm_tpu_torch.sfm.phases import InitPhase

from test_torch_port_parallel import (  # noqa: F401
    _case, _clone, _garbage, _ranks_equal, _steps, _two_ranks, _two_threads, run)



def test_twenty_init_steps_at_two_ranks(run):
    """20 InitPhase steps with the rays drawn by each rank's generator
    (the global draw: two ranks draw what one draws), at 32 rays a
    camera and 3 march steps to keep the test short: the losses agree
    to 2e-4 at every step, and the ranks' parameters are equal bit for
    bit after every step."""
    model = run[0]
    init = model.initializer
    cfgs = dataclasses.replace(model.cfgs, rand_rays=64, sdf=dataclasses.replace(
        model.cfgs.sdf, iters_max=3))
    phase = InitPhase(cfgs, init.phase.weights, max_iter=20)
    batch = dict(init.batch)
    batch["occ"] = tbundle.maybe_build_occ(model.opt, model.cfgs, model.params)

    def make_state():
        return phase.init_state(_clone(model.params))

    m1, _, _ = _steps(phase, batch, make_state, {}, n=20)
    ranks = _two_ranks(phase, batch, make_state, {}, n=20)
    _ranks_equal(ranks)
    for i, (a, b) in enumerate(zip(ranks[0][0], m1)):
        for k in b:
            np.testing.assert_allclose(float(a[k]), float(b[k]), rtol=2e-4,
                                       atol=0, err_msg=f"step {i} {k}")
