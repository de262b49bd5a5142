"""The whole step's share of the card's float32 peak (67 TFLOP/s, TF32
off), in %: the FLOPs of the work the traced window's steps before the
profiled stretches did (``harness.flops``: the rendered points, the
march's and the re-evaluation's points as the march spans count them,
BA's track points, the occupancy grid's share), over their host time."""
from portbench.harness.flops import PEAK_F32_FLOPS, step_flops


def read(t):
    steps, marches = t["steps_s"], t["march"]
    if not steps or not any(marches):
        return None
    opt, shp = t["opt"], t["flop_shapes"]
    K = int(opt["Renderer"]["compact_samples"])
    occ = int(opt["Renderer"].get("occ_res", 64)) ** 3 / t["occ_every"]
    total = 0.0
    for calls in marches:
        total += step_flops(opt, render_points=shp["render_rays"] * K,
                            march_points=sum(bn * (1 + n) for _, bn, n in calls),
                            reeval_points=sum(bn * n for _, bn, n in calls),
                            surface_points=shp["surface_points"], occ_points=occ)
    return total / sum(steps) / PEAK_F32_FLOPS * 100.0
