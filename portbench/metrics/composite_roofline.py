"""The fused composite's (K1 forward, K2 backward) share of its memory
bound, in %: the bytes of every launch the device stretch made (inputs
read once, outputs written once; ``fused_composite.SHAPES``) at 3.35
TB/s, over the device time of the composite's kernels (device trace)."""
from portbench.harness.flops import PEAK_HBM_BYTES, composite_bytes

KERNELS = ("fwd_regs", "fwd_chunked", "bwd_regs", "bwd_chunked")


def read(t):
    p = t["profile"]
    dev = sum(s for name, s in p["kernels"].items() if any(k in name for k in KERNELS))
    shapes = p.get("composite_shapes") or {}
    if dev <= 0 or not any(shapes.values()):
        return None
    need = sum(c * composite_bytes(R, K)[0] for (R, K), c in shapes.get("fwd", {}).items())
    need += sum(c * composite_bytes(R, K)[1] for (R, K), c in shapes.get("bwd", {}).items())
    return need / PEAK_HBM_BYTES / dev * 100.0
