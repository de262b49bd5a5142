"""The geoinit batch, the GeoInitPhase steps and the acceptance of new
points in the port against the JAX package, on the CPU at the tiny
widths, from the state and with the tolerances of
``test_torch_port_registration.py``. Kept apart so that each test file
holds at most five tests: pytest-xdist's loadfile queue starts the
files with more tests first.
"""
import numpy as np
import pytest

from test_torch_port_registration import (  # noqa: F401
    GEO_LOSSES, _jax_geoinit_batch, _jax_segments, _registered, state)


@pytest.mark.parametrize("max_rays", [0, 20])
def test_geoinit_batch_matches(state, monkeypatch, max_rays):
    """max_rays 20 caps the 28 pair rays: the subsample is drawn from
    the same seeded numpy generator on both sides."""
    jm, tm, ((jr, jc), (tr, tc)) = _registered(state)
    for m in (jm, tm):
        m.opt.optim.geoinit.max_rays = max_rays
    _, jb = _jax_geoinit_batch(monkeypatch, jm, jr, jc)
    segs, tb = tr.geo_init_batch(tc, tm.point_set, verbose=False)
    assert sorted(tb) == sorted(jb)
    for k in tb:
        np.testing.assert_allclose(np.asarray(tb[k], np.float64),
                                   np.asarray(jb[k], np.float64),
                                   rtol=0, atol=1e-5, err_msg=k)
    assert int(np.asarray(jb["valid"]).sum()) == sum(s["n"] for s in segs)
    assert sum(s["n"] for s in segs) == (20 if max_rays else 28)
