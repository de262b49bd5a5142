"""No module of the benchmark imports JAX or the JAX package, and the
plain reference imports nothing of the program (top-level names compared
whole, so that ``level_s2fm_tpu_torch`` is not taken for
``level_s2fm_tpu``); and a run loads no such module."""
import ast
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "level_s2fm_tpu"}
PROGRAM = "level_s2fm_tpu_torch"


def _modules():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    """(top-level name or None, relative level, module) of every import."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0, a.name
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            yield (mod.split(".")[0] if node.level == 0 else None), node.level, mod


def test_the_walk_finds_every_part():
    rel = {os.path.relpath(p, HERE) for p in _modules()}
    for part in ("run.py", "calibrate.py", "reference/step.py", "harness/check.py",
                 "drivers/init.py", "metrics/mfu.py"):
        assert part in rel


@pytest.mark.parametrize("path", sorted(_modules()), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    bad = [m for top, _, m in _imports(path) if top in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_the_name_check_is_whole():
    assert PROGRAM.split(".")[0] not in FORBIDDEN
    assert "level_s2fm_tpu.fields".split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", sorted(p for p in _modules()
                                        if os.sep + "reference" + os.sep in p),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_nothing_of_the_program(path):
    for top, level, mod in _imports(path):
        assert top != PROGRAM, f"{path} imports {mod}"
        # relative imports stay inside the reference package
        assert level in (0, 1), f"{path} imports {'.' * level}{mod}"


def test_a_run_loads_no_jax_module():
    """A cell run at a tiny size on the CPU, in a fresh interpreter."""
    code = (
        "import sys, torch\n"
        "from portbench import run\n"
        "from portbench.tests.tiny import SEED, edits\n"
        "res, rows = run.run_cell('sphere128-refine', SEED, 0.2, False, torch.device('cpu'),"
        " option_edits=edits('sphere128-refine'), log=lambda *a, **k: None)\n"
        "assert res['correct'], rows\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & set(run.FORBIDDEN)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, USE_FLAX="0"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
