"""Device-idle ms a step while the innermost open span of the program
was ``sdf.march`` or a span inside it (its hash encodes): the idle gaps
of the CUDA-only device stretch, split by the span open at each instant
(device trace, on the tracer's shared clock)."""
from portbench.harness.spans import under


def read(t):
    by, n = t["profile"].get("by_span"), t["profile"]["steps"]
    if not by or not any("sdf.march" in path.split("/") for path in by):
        return None
    return under(by, "sdf.march", "idle_s") / n * 1e3
