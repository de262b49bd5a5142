"""The ordered scatter's share of its memory bound, in %: the bytes of
every call the device stretch made (an 8-byte key and the cotangent read
a contribution, a row written once; counted by shape in
``hash_scatter.SHAPES``) at the HBM's 3.35 TB/s, over the device time of
the scatter's kernels (device trace: the digit histogram, the sort
passes and the segment sum; the look-back state's memset, ~0.004 ms a
call, is not told apart from other memsets and is left out)."""
from portbench.harness.flops import PEAK_HBM_BYTES, scatter_bytes

KERNELS = ("digit_histogram_kernel", "onesweep_pass_kernel", "segment_sum_kernel")


def read(t):
    p = t["profile"]
    dev = sum(s for name, s in p["kernels"].items() if any(k in name for k in KERNELS))
    shapes = p.get("scatter_shapes") or {}
    if dev <= 0 or not shapes:
        return None
    need = sum(c * scatter_bytes(n, m, F) for (n, m, F), c in shapes.items())
    return need / PEAK_HBM_BYTES / dev * 100.0
