"""Device ms a step of the kernels launched inside the program's
``hashgrid.encode`` spans (the hash encode forward, with and without its
spatial Jacobian, wherever it is called): each kernel of the CUDA-only
device stretch matched to the span open at its launch (device trace)."""
from portbench.harness.spans import under


def read(t):
    by, n = t["profile"].get("by_span"), t["profile"]["steps"]
    if not by or not any("hashgrid.encode" in path.split("/") for path in by):
        return None
    return under(by, "hashgrid.encode", "device_s") / n * 1e3
