"""The share of a step's wall time in which no operation runs on the
device, in %: 1 - (the union of the device's busy intervals a step, in
the device stretch) / (the host seconds a step of the traced window's
unprofiled steps). The device stretch records CUDA activity alone; its
busy time is the device's, while its wall time carries the profiler's
cost on the host, so the wall comes from the unprofiled steps (device
trace and host clock)."""


def read(t):
    p, steps = t["profile"], t["steps_s"]
    if not p or p["busy_s"] <= 0 or not steps:
        return None
    return (1.0 - p["busy_s"] / p["steps"] / (sum(steps) / len(steps))) * 100.0
