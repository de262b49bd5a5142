"""Observability: colored logging, per-phase wall timers, metric rows.

Counterpart of ``level_s2fm_tpu/utils/obs.py``: ``Log``, the JSONL
``MetricRecorder`` (TensorBoard scalars only when a ``tb_dir`` is given,
and only if ``torch.utils.tensorboard`` imports), ``PhaseTimers`` and the
module-level ``HOST_TIMERS`` / ``TIMERS``. The JAX package's
``CompileCounter`` (XLA compile buckets) and ``jax_trace`` have no
counterpart: the port compiles nothing per shape, and device time is read
with ``torch.profiler`` (``chip_smoke.py``). Under data-parallel ranks
only rank 0 logs and writes metric files; the timers stay per rank.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

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
    def track(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": round(v, 3), "count": self.counts[k],
                    "mean_s": round(v / self.counts[k], 3)}
                for k, v in self.totals.items()}


#: host-side work outside the phase timers (checkpointing, export)
HOST_TIMERS = PhaseTimers()

TIMERS = PhaseTimers()
