"""Timing on the card, for ``chip_smoke.py`` and the kernels' ablations.

``time_ms`` times a call on the device back to back: the stream is held
by a spin kernel while the calls are enqueued, so CUDA events measure the
device's work without the host's per-call cost. ``host_ms`` is that
per-call cost (the median time a call takes to return). ``bound_ms`` is
the least time an H100 SXM could take for a given number of bytes and
f32 operations. Every function here needs a CUDA device.
"""
from __future__ import annotations

import math
import time

import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (data sheet)
F32_FLOPS = 67e12               # H100 SXM float32 outside the tensor cores


def host_ms(fn, n=200):
    """Host ms per call: the median over ``n`` calls of the time each
    takes to return (to enqueue its work), the device running behind."""
    torch.cuda.synchronize()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return sorted(ts)[n // 2] * 1e3


def time_ms(fn, reps=3, n=100):
    """Device time per call, in ms: the stream is held by a spin kernel
    (``torch.cuda._sleep``) while ``n`` calls are enqueued, so the events
    time the calls back to back on the card, without the host's per-call
    overhead. Returns (device_ms, host_ms) per call: the best of ``reps``
    and the median host time of ``host_ms``."""
    for _ in range(5):
        fn()
    host = host_ms(fn)
    cycles = int(host * 1e-3 * n * 2.5e9 * 3) + 1_000_000
    best = math.inf
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / n)
    return best, host


def bound_ms(nbytes, nops):
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the f32 operations over the peak rate."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = nops / F32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")
