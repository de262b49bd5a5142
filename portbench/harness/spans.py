"""The program's own spans and counters (the port's tracer,
``level_s2fm_tpu_torch/utils/obs.py``) over the stretches of a traced
run, and their reading.

- ``stretches``: a device stretch (``trace.profile_steps`` with CUDA
  activity alone) with the tracer on (its rows stamp the profiler's
  clock, so the stretch's idle gaps and kernels can be put down to the
  span open at the time), then ``SPAN_STEPS`` unprofiled steps with the
  tracer on (host spans and counters), then ``SYNC_STEPS`` steps that
  count each host-device sync. Each stretch starts once no occupancy
  rebuild falls in it.
- ``by_span``: the device stretch by span path (a span's names from the
  step down, joined by ``/``): the device's idle time while that span was
  the innermost open one, and the device time and count of the kernels
  launched inside it (each kernel matched, through its correlation id,
  to the CUDA runtime record of its launch and that record's host time;
  a CUDA-only profile records those launches).
- ``read``: the new keys of a metric's ``t``: ``spans`` (rows per step of
  the span stretch), ``span_steps_s`` (its host seconds per step),
  ``counters`` (over it), ``syncs`` ({span path: syncs} per step of the
  sync stretch) and ``by_span`` (for ``t["profile"]``).

The metrics that read these keys return None where a run's ``t`` lacks
them.
"""
from __future__ import annotations

import bisect
import heapq
import time

from .trace import profile_steps, union_busy

#: steps of the span stretch and of the sync stretch
SPAN_STEPS, SYNC_STEPS = 20, 3
#: the key of time and work while no span was open
NO_SPAN = "(no span)"


def fit(cell, k):
    """Step until no occupancy rebuild falls among the next k steps."""
    while not all((cell.i + j) % cell.occ_every for j in range(k)):
        cell.step()


def stretches(cell, profile_steps_n, sync, profile=profile_steps):
    """The traced stretches (see the module's docstring). ``sync()``
    waits for the device; ``profile`` is ``trace.profile_steps`` (another
    on the CPU in tests)."""
    from level_s2fm_tpu_torch.utils import obs
    out = {}
    fit(cell, profile_steps_n)
    with obs.tracing() as tr:
        out["device"] = profile(cell.step, profile_steps_n, host_ops=False)
        out["device_rows"] = tr.take()[0]
    fit(cell, SPAN_STEPS)
    sync()
    with obs.tracing() as tr:
        t0 = time.perf_counter()
        for _ in range(SPAN_STEPS):
            cell.step()
        sync()
        out["span_wall_s"] = time.perf_counter() - t0
        out["span_rows"], out["counters"] = tr.take()
    fit(cell, SYNC_STEPS)
    sync()
    out["sync_counters"] = []
    with obs.tracing(count_syncs=True) as tr:
        for _ in range(SYNC_STEPS):
            cell.step()
            out["sync_counters"].append(tr.take()[1])
    sync()
    return out


def read(raw):
    """The metrics' new keys from ``stretches``' output."""
    spans = per_step(raw["span_rows"])
    return {"by_span": by_span(*launch_records(raw["device"][0]), raw["device_rows"]),
            "spans": spans, "counters": raw["counters"],
            "span_steps_s": raw["span_wall_s"] / SPAN_STEPS,
            "syncs": [{path: n for (path, name), n in c.items() if name == "sync"}
                      for c in raw["sync_counters"]]}


def launch_records(events):
    """(device events as (start_ns, end_ns, correlation id), {correlation
    id: host ns of the CUDA runtime or driver call that launched it}) of
    a profile's events."""
    from torch.autograd import DeviceType
    dev, launch = [], {}
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            dev.append((e.start_ns(), e.end_ns(), e.correlation_id()))
        elif e.name().startswith("cu") and e.correlation_id():
            launch[e.correlation_id()] = e.start_ns()
    return dev, launch


def paths(rows):
    """Each row's path: its names from the outermost span, joined by '/'."""
    out = []
    for name, _, _, parent, *_ in rows:
        out.append(name if parent < 0 else f"{out[parent]}/{name}")
    return out


def timeline(rows):
    """The innermost open span over time: (bounds, labels), where
    labels[i] is the path of the deepest span open over [bounds[i],
    bounds[i+1]) (the latest opened among equals), or ``NO_SPAN``. Rows
    of every thread count: autograd's device thread nests its spans under
    ``backward``."""
    ps = paths(rows)
    edges = sorted([(r[1], 1, i) for i, r in enumerate(rows)]
                   + [(r[2], 0, i) for i, r in enumerate(rows)])
    bounds, labels, heap, done = [], [], [], set()
    k = 0
    while k < len(edges):
        t = edges[k][0]
        while k < len(edges) and edges[k][0] == t:
            _, opens, i = edges[k]
            if opens:
                heapq.heappush(heap, (-ps[i].count("/"), -rows[i][1], i))
            else:
                done.add(i)
            k += 1
        while heap and heap[0][2] in done:
            heapq.heappop(heap)
        bounds.append(t)
        labels.append(ps[heap[0][2]] if heap else NO_SPAN)
    return bounds, labels


def label_at(bounds, labels, t):
    i = bisect.bisect_right(bounds, t) - 1
    return labels[i] if i >= 0 else NO_SPAN


def split(intervals, bounds, labels):
    """{path: seconds} of (start_ns, end_ns) intervals, split by the
    innermost open span."""
    out = {}
    for s, e in intervals:
        i = bisect.bisect_right(bounds, s) - 1
        t = s
        while t < e:
            lab = labels[i] if i >= 0 else NO_SPAN
            nxt = bounds[i + 1] if i + 1 < len(bounds) else e
            end = min(e, nxt)
            out[lab] = out.get(lab, 0.0) + (end - t) * 1e-9
            t, i = end, i + 1
    return out


def by_span(dev, launch, rows):
    """{span path: {"idle_s", "device_s", "launches"}} of a profiled
    stretch: the device's idle gaps (between the union of its busy
    intervals) split by the innermost open span; each device event's
    time and count under the innermost span open at its launch's host
    time (``NO_SPAN`` where none was or its launch record is missing)."""
    bounds, labels = timeline(rows)
    out = {}

    def entry(path):
        return out.setdefault(path, {"idle_s": 0.0, "device_s": 0.0, "launches": 0})
    _, gaps = union_busy([(s, e) for s, e, _ in dev])
    for path, sec in split(gaps, bounds, labels).items():
        entry(path)["idle_s"] += sec
    for s, e, corr in dev:
        t = launch.get(corr)
        d = entry(NO_SPAN if t is None else label_at(bounds, labels, t))
        d["device_s"] += (e - s) * 1e-9
        d["launches"] += 1
    return out


def per_step(rows):
    """Rows grouped by their step (rows before the first step dropped),
    each group's parents re-indexed within it (-1 where outside it)."""
    groups = {}
    for i, r in enumerate(rows):
        if r[5] >= 0:
            groups.setdefault(r[5], []).append(i)
    out = []
    for step in sorted(groups):
        idx = {old: new for new, old in enumerate(groups[step])}
        out.append([rows[i][:3] + (idx.get(rows[i][3], -1),) + rows[i][4:]
                    for i in groups[step]])
    return out


def self_s(rows, name):
    """Seconds inside spans called ``name``, less their children's."""
    total = 0.0
    for name_, t0, t1, parent, *_ in rows:
        if name_ == name:
            total += (t1 - t0) * 1e-9
        if parent >= 0 and rows[parent][0] == name:
            total -= (t1 - t0) * 1e-9
    return total


def under(by, name, key):
    """The sum of ``key`` over the paths that pass through a span called
    ``name``."""
    return sum(v[key] for path, v in by.items() if name in path.split("/"))
