"""Twenty init steps at two ranks, and padded rows, against one rank, on
the CPU (gloo ranks as threads), from the run and with the tolerances
of ``test_torch_port_parallel.py``. Kept apart so that each test file
holds at most five tests: pytest-xdist's loadfile queue starts the
files with more tests first.
"""
import pytest

from level_s2fm_tpu_torch.parallel import mesh as pmesh

from test_torch_port_parallel import (  # noqa: F401
    _case, _clone, _garbage, _ranks_equal, _steps, _two_ranks, _two_threads, run)


@pytest.mark.parametrize("name", ["ba_sfm", "ba_sfm_refine", "refine"])
def test_padded_rows_change_nothing(run, name, monkeypatch):
    """Two ranks whose padding rows (the last rank's, of the rays, the
    tracing rows and the track rows) hold garbage give every loss,
    parameter and carried point of the plain padding, bit for bit."""
    phase, batch, make_state, kw = _case(run, name)
    plain = _two_ranks(phase, batch, make_state, kw)
    monkeypatch.setattr(pmesh, "pad_rows", _garbage)
    garbage = _two_ranks(phase, batch, make_state, kw)
    _ranks_equal([plain[0], garbage[0]])
    _ranks_equal([plain[1], garbage[1]])
