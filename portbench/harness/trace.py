"""What a ``--trace 1`` run records, and the reading of its profiles.

- ``MarchSpans``: the host time of every call of the program's
  ``fields.sdf.sphere_march`` and its shape (rays, trips made), by
  wrapping the module attribute from here; the port is not changed. The
  march reads a count back from the device every trip, so its host span
  is its time.
- ``profile_steps``: ``torch.profiler`` over a stretch of steps. With
  CUDA activity alone (the device stretch) the host runs nearly as
  unprofiled, so the stretch's wall time and the device's busy intervals
  give the idle share, and the kernels' device times the rooflines. With
  CPU activity too (the host stretch) every host op is recorded, which
  slows the host; that stretch only names what the host was doing in the
  longest idle gaps.
- ``reduce``: both stretches to seconds, after the window.
"""
from __future__ import annotations

import time


class MarchSpans:
    """Wraps ``sphere_march`` while active; ``calls`` holds (seconds, rays,
    trips) per call since the last ``take``."""

    def __init__(self):
        from level_s2fm_tpu_torch.fields import sdf as sdf_mod
        self._mod, self._orig, self.calls = sdf_mod, sdf_mod.sphere_march, []

        def timed(*a, **k):
            t0 = time.perf_counter()
            m = self._orig(*a, **k)
            self.calls.append((time.perf_counter() - t0, int(m.track.shape[1]),
                               int(m.last_idx) + 1))
            return m
        self._timed = timed

    def __enter__(self):
        self._mod.sphere_march = self._timed
        return self

    def __exit__(self, *exc):
        self._mod.sphere_march = self._orig

    def take(self):
        out, self.calls = self.calls, []
        return out


def union_busy(intervals):
    """Total length covered by (start, end) intervals, and the gaps
    between them as (start, end), in time order."""
    busy, reach, gaps = 0.0, None, []
    for s, e in sorted(intervals):
        if reach is None:
            busy, reach = e - s, e
            continue
        if s > reach:
            gaps.append((reach, s))
        if e > reach:
            busy += e - max(s, reach)
            reach = e
    return busy, gaps


def profile_steps(step, n, host_ops):
    """Run ``step()`` n times under the profiler (CUDA activity, and CPU
    activity with ``host_ops``). Returns (the profiler's events, the
    stretch's wall seconds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof.profiler.kineto_results.events(), wall


def _split(events):
    """(device events, host events) as (start_ns, end_ns, name)."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in events:
        row = (e.start_ns(), e.end_ns(), e.name())
        (dev if e.device_type() == DeviceType.CUDA else host).append(row)
    return dev, host


def reduce(device_stretch, host_stretch, n):
    """Seconds: ``wall_s`` and ``busy_s`` of the device stretch, its
    kernels' device time by name (``kernels``), and the ten longest idle
    gaps of the host stretch, each with the innermost host op that was
    running at its middle (``idle_gaps``)."""
    (dev_events, wall), (host_events, _) = device_stretch, host_stretch
    dev, _ = _split(dev_events)
    busy, _ = union_busy([(s, e) for s, e, _ in dev])
    kernels = {}
    for s, e, name in dev:
        kernels[name] = kernels.get(name, 0.0) + (e - s) * 1e-9
    hdev, host = _split(host_events)
    _, gaps = union_busy([(s, e) for s, e, _ in hdev])
    idle = []
    for gs, ge in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (gs + ge) / 2
        inside = [(e - s, name) for s, e, name in host if s <= mid <= e]
        idle.append([min(inside)[1] if inside else "(no host op)", (ge - gs) * 1e-9])
    return {"wall_s": wall, "busy_s": busy * 1e-9, "steps": n, "kernels": kernels,
            "idle_gaps": idle}
