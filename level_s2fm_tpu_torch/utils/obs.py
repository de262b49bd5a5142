"""Observability: colored logging, per-phase wall timers, metric rows,
and the tracer's spans and counters.

Counterpart of ``level_s2fm_tpu/utils/obs.py``: ``Log``, the JSONL
``MetricRecorder`` (TensorBoard scalars only when a ``tb_dir`` is given,
and only if ``torch.utils.tensorboard`` imports), ``PhaseTimers`` and the
module-level ``HOST_TIMERS``. The JAX package's ``CompileCounter`` (XLA
compile buckets) and ``jax_trace`` have no counterpart: the port compiles
nothing per shape. Under data-parallel ranks only rank 0 logs and writes
metric files; the timers stay per rank.

The tracer: ``span(name)`` (``traced(name)`` as a decorator) marks a
layer's work and ``count(name, n)`` adds to a counter of the innermost
open span. Both do nothing while no tracer is active; inside
``tracing()`` spans are kept in memory as rows on ``time.time_ns()``,
the clock the torch profiler stamps its host and device events with, so
a profile's kernels and idle gaps can be put down to the span open at
the time (``portbench/harness/spans.py``). ``tracing(count_syncs=True)``
also counts each host-device sync the card reports (``sync``). Device
time is read with ``torch.profiler`` (``chip_smoke.py``,
``portbench/harness/``) and, for one kernel alone, with CUDA events
(``devtime.py``).
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import threading
import time
import warnings
from typing import Dict, Optional

import torch

from ..parallel import distributed as pdist


class Log:
    """Minimal colored stdout logger."""
    _COLORS = {"info": "\033[96m", "warn": "\033[93m", "error": "\033[91m",
               "title": "\033[95m", "ok": "\033[92m"}
    _END = "\033[0m"
    enabled = True

    @classmethod
    def _emit(cls, level, *msg):
        if not cls.enabled or not pdist.is_primary():
            return
        color = cls._COLORS.get(level, "")
        print(f"{color}[{level}]{cls._END}", *msg, flush=True)

    @classmethod
    def info(cls, *msg):
        cls._emit("info", *msg)

    @classmethod
    def warn(cls, *msg):
        cls._emit("warn", *msg)

    @classmethod
    def error(cls, *msg):
        cls._emit("error", *msg)

    @classmethod
    def title(cls, *msg):
        cls._emit("title", *msg)


class MetricRecorder:
    """Append-only JSONL scalar history + in-memory rows."""

    def __init__(self, path: Optional[str] = None, tb_dir: Optional[str] = None):
        if not pdist.is_primary():
            path = tb_dir = None
        self.path = path
        self.history = []
        self._tb = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if tb_dir:
            # optional TensorBoard scalars; fail soft when the writer is
            # not installed
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir=tb_dir)
            except Exception:
                self._tb = None

    @staticmethod
    def _json_default(o):
        # numpy scalars and arrays and tensors (e.g. np.int64 view ids)
        if hasattr(o, "tolist"):
            return o.tolist()
        raise TypeError(
            f"Object of type {type(o).__name__} is not JSON serializable")

    def log(self, step: int, **scalars):
        rec = {"step": step, "t": time.time(), **scalars}
        self.history.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec, default=self._json_default) + "\n")
        if self._tb is not None:
            for k, v in scalars.items():
                try:
                    self._tb.add_scalar(k, float(v), step)
                except (TypeError, ValueError):
                    pass
            self._tb.flush()

    def log_image(self, step: int, name: str, image):
        """TensorBoard image; no-op without a tb_dir. image: [H,W,3]
        float in [0,1] or uint8."""
        if self._tb is None:
            return
        import numpy as np
        img = np.asarray(image)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
        try:
            self._tb.add_image(name, img, step, dataformats="HWC")
            self._tb.flush()
        except Exception:
            pass

    def last(self, key: str):
        for rec in reversed(self.history):
            if key in rec:
                return rec[key]
        return None


class PhaseTimers:
    """Accumulated wall time per phase name."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def track(self, name: str, into: Optional[Dict[str, float]] = None):
        """Time the block into ``name``'s total (and into ``into[name]``
        where ``into`` is given)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            if into is not None:
                into[name] = into.get(name, 0.0) + dt

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": round(v, 3), "count": self.counts[k],
                    "mean_s": round(v / self.counts[k], 3)}
                for k, v in self.totals.items()}


#: host-side work outside the phase timers (checkpointing, export)
HOST_TIMERS = PhaseTimers()


# ----------------------------------------------------------------- the tracer

#: the active tracer (``tracing``); None: spans and counts do nothing
_TRACER: Optional["Tracer"] = None
#: the start of the warning the card's sync debug mode gives at each sync
SYNC_MESSAGE = "called a synchronizing CUDA operation"
#: spans whose names start so open a step (a row's ``step``)
STEP_PREFIX = "step."


class _NoSpan:
    """What ``span`` returns while no tracer is active: it records
    nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("tracer", "name")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        self.tracer.open(self.name)
        return self

    def __exit__(self, *exc):
        self.tracer.close()
        return False


def span(name: str):
    """A context manager around one layer's work: a row of the active
    tracer, or the shared ``NO_SPAN`` while there is none."""
    tracer = _TRACER
    return NO_SPAN if tracer is None else _Span(tracer, name)


def traced(name: str):
    """Decorator: each call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            tracer = _TRACER
            if tracer is None:
                return fn(*args, **kwargs)
            with _Span(tracer, name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n=1):
    """Add ``n`` to the counter ``name`` of the innermost open span, while
    a tracer is active."""
    tracer = _TRACER
    if tracer is not None:
        tracer.add(name, n)


class Tracer:
    """The spans and counters recorded while ``tracing`` is active, kept
    in memory until ``take``.

    Each thread keeps its own stack of open spans. A span opened on a
    thread with none open (autograd's device thread, which runs the
    backward of CUDA tensors while the thread that called into autograd
    waits in its ``backward`` span) takes as parent the innermost span
    open on the thread that entered ``tracing``; so does a count.
    """

    def __init__(self):
        self._local = threading.local()
        self._ids = itertools.count()
        self._lock = threading.Lock()
        self._rows = []
        self._counters: Dict = {}
        #: ``step.*`` spans opened so far, less one
        self.step = -1
        self._owner = self._stack()

    def _stack(self):
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _innermost(self, stack):
        try:
            return (stack or self._owner)[-1]
        except IndexError:          # the owner's span closed meanwhile
            return None

    def open(self, name: str):
        stack = self._stack()
        outer = self._innermost(stack)
        if name.startswith(STEP_PREFIX):
            self.step += 1
        # (id, name, path from the outermost span, parent id, step, t0)
        stack.append((next(self._ids), name,
                      name if outer is None else f"{outer[2]}/{name}",
                      -1 if outer is None else outer[0], self.step, time.time_ns()))

    def close(self):
        t1 = time.time_ns()
        rid, name, _, parent, step, t0 = self._stack().pop()
        self._rows.append((rid, name, t0, t1, parent, threading.get_ident(), step))

    def add(self, name: str, n=1):
        outer = self._innermost(self._stack())
        key = ("" if outer is None else outer[2], name)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + n

    def take(self):
        """(rows, counters) recorded since the last ``take``; both start
        anew. A row is (name, t0_ns, t1_ns, parent_row, thread_id, step):
        ``parent_row`` indexes the list (-1: no parent, or one still
        open), ``step`` counts the ``step.*`` spans opened before it since
        ``tracing`` began, less one. Counters are keyed by (the path of
        the innermost open span, its names from the outermost joined by
        ``/``, or "" for none; the counter's name)."""
        rows, self._rows = self._rows, []
        with self._lock:
            counters, self._counters = self._counters, {}
        rows.sort()
        index = {r[0]: i for i, r in enumerate(rows)}
        return ([(name, t0, t1, index.get(parent, -1), tid, step)
                 for _, name, t0, t1, parent, tid, step in rows], counters)


@contextlib.contextmanager
def tracing(count_syncs: bool = False):
    """Record spans and counters while active (yields the ``Tracer``).
    With ``count_syncs``, each host-device sync counts as ``sync``
    against the innermost span open on the thread that shows its
    warning: the card's sync debug mode is set to warn, and those
    warnings are shown every time and counted instead of printed. A sync
    of an op called from Python shows where it is made, on autograd's
    device thread too (a custom Function's backward, under its own span
    or else the caller's ``backward``); one made inside PyTorch's own
    backward formulas is held by autograd until the backward ends and
    shows on the thread that called it, so it counts under the span
    around that call (``backward``). The mode, the warning filters and
    the warning hook are restored on exit."""
    global _TRACER
    if _TRACER is not None:
        raise RuntimeError("a tracer is already active")
    tracer = Tracer()
    with _counting_syncs(tracer) if count_syncs else contextlib.nullcontext():
        _TRACER = tracer
        try:
            yield tracer
        finally:
            _TRACER = None


@contextlib.contextmanager
def _counting_syncs(tracer: Tracer):
    cuda = torch.cuda.is_available()
    with warnings.catch_warnings():
        warnings.filterwarnings("always", message=SYNC_MESSAGE, category=UserWarning)
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if issubclass(category, UserWarning) and str(message).startswith(SYNC_MESSAGE):
                tracer.add("sync")
            else:
                shown(message, category, filename, lineno, file, line)
        warnings.showwarning = show
        mode = torch.cuda.get_sync_debug_mode() if cuda else None
        if cuda:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(mode)
