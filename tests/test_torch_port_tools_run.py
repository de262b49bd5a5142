"""The three tool modules in one subprocess without jax, and the demo's
files (see ``test_torch_port_tools.py``).
Kept apart so that it runs after the suite's long files have started: pytest-xdist's loadfile queue starts the files with more tests first.
"""
import os
import subprocess
import sys

import numpy as np

from test_torch_port_tools import AB, DEMO_ARGS, REPO, RUN_ARGS, SMALL, run_dir, script_ab  # noqa: F401


def test_modules_run_without_jax_and_the_demo_writes_its_files(run_dir, tmp_path):
    """One subprocess runs the demo (``--cpu --iters 2`` at the test
    widths), the diagnosis and the A/B (one step, the test's hash grid)
    through their ``main``s and finds no jax or
    ``level_s2fm_tpu`` module loaded; the demo's files are there, and its
    GIF decodes (Pillow) to its five PNG frames through its palette."""
    demo = tmp_path / "demo"
    code = (
        "import json, sys\n"
        "from level_s2fm_tpu_torch import ab_adaptive_sampler, diag_frontier_pnp, "
        "two_view_init_demo\n"
        f"r = two_view_init_demo.main(['--cpu', '--iters', '2', '--out', {str(demo)!r},"
        f" *{DEMO_ARGS!r}])\n"
        f"assert diag_frontier_pnp.main([{run_dir!r}, '--cpu', *{RUN_ARGS!r}]) == 0\n"
        "full = ab_adaptive_sampler.ab_opt\n"
        "def ab_opt(*a):\n"
        "    opt = full(*a)\n"
        f"    opt.SDF.Hash_config.update({SMALL!r})\n"
        "    return opt\n"
        "ab_adaptive_sampler.ab_opt = ab_opt\n"
        f"ab_adaptive_sampler.main(['--cpu', '--steps', '1', '--rays', '32', '--hw', '16',"
        f" '--out', {str(tmp_path / 'ab.json')!r}])\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'jaxlib'))\n"
        "             or k == 'level_s2fm_tpu' or k.startswith('level_s2fm_tpu.'))\n"
        "print('DEMO', json.dumps(r['out_dir']), 'BAD', bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    import json
    from PIL import Image
    from level_s2fm_tpu_torch.utils import gif, png
    line = next(x for x in p.stdout.splitlines() if x.startswith("DEMO"))
    out = json.loads(line.split()[1])
    names = ["init_points.ply", "matches.png", "slerp.gif"] + [f"slerp_{i}.png" for i in range(5)]
    for name in names:
        assert os.path.getsize(os.path.join(out, name)) > 0, name
    frames = np.stack([png.read_png(os.path.join(out, f"slerp_{i}.png")) for i in range(5)])
    assert frames.shape == (5, 64, 64, 3)
    im = Image.open(os.path.join(out, "slerp.gif"))
    assert im.n_frames == 5 and im.info.get("loop") == 0
    decoded = []
    for i in range(5):
        im.seek(i)
        decoded.append(np.asarray(im.convert("RGB")))
    idx, palette = gif.palette_indices(frames)
    assert np.array_equal(np.stack(decoded), palette[idx])
    with open(tmp_path / "ab.json") as f:
        ab = json.load(f)
    assert ab["backend"] == "cpu" and set(ab["results"]) == {
        "uniform128+occ32", "uniform128", "adaptive"}


def test_ab_options_arms_and_flags_are_the_scripts():
    """The port's ``ab_opt``, arms and flag defaults are
    ``scripts/ab_adaptive_sampler.py``'s, read from its source; only the
    default ``--out`` differs (under the git-ignored ``output/``)."""
    from level_s2fm_tpu_torch import ab_adaptive_sampler as tab
    script_opt, arms, flags = script_ab()
    assert tab.ARMS == arms
    for mode in arms:
        for hw, rays in ((AB["hw"], AB["rays"]), (128, 2048)):
            assert tab.ab_opt(mode, hw, hw, rays) == script_opt(mode, hw, hw, rays), mode
    port_flags = script_ab(os.path.join(REPO, "level_s2fm_tpu_torch",
                                        "ab_adaptive_sampler.py"))[2]
    assert flags.pop("--out") == "results/ab_adaptive_sampler.json"
    assert port_flags.pop("--out") == "output/ab_adaptive_sampler.json"
    assert port_flags == flags == {"--steps": 300, "--rays": 2048, "--hw": 128}
