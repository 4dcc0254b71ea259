"""Tracing, structured metrics and checkpoint/resume for long runs
(counterpart of ``difflexmm_tpu/utils/observability.py``).

- ``trace``: a context manager timing a phase by the host clock, and with
  a ``trace_dir`` recording it with ``torch.profiler`` (CPU activity, and
  CUDA activity where a card is present) into a Chrome trace file there.
- ``MetricsLogger``: per-iteration metrics appended to a JSONL file, with
  the JAX package's keys.
- ``OptimizationCheckpoint``: a periodic snapshot of an optimization (the
  design, the histories and extras), resumable in another process, saved
  and read with ``utils.types.save_data`` / ``load_data``.
"""

import json
import os
import re
import time
from contextlib import contextmanager
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Optional, Union

import torch

from difflexmm_tpu_torch.utils.types import load_data, save_data


@contextmanager
def trace(label: str, trace_dir: Optional[Union[str, Path]] = None, verbose: bool = True):
    """Time a phase; with ``trace_dir``, record it with ``torch.profiler``
    into ``<trace_dir>/<label>.<pid>.<ns>.trace.json`` (Chrome's trace
    format; CUDA activity included where ``torch.cuda.is_available()``,
    the device synchronised before the profiler stops so that the trace
    holds the phase's kernels). Prints ``[trace] label: x s`` as JAX's
    does.

    Usage::

        with trace("fwd+grad", trace_dir="traces"):
            value, grad = step(design)
    """

    profiler = None
    cuda = torch.cuda.is_available()
    if trace_dir is not None:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if profiler is not None:
            if cuda:
                torch.cuda.synchronize()
            profiler.stop()
        elapsed = time.perf_counter() - t0
        if profiler is not None:
            out = Path(trace_dir)
            out.mkdir(parents=True, exist_ok=True)
            name = re.sub(r"[^A-Za-z0-9_.+-]", "_", label)
            profiler.export_chrome_trace(
                str(out / f"{name}.{os.getpid()}.{time.time_ns()}.trace.json"))
        if verbose:
            print(f"[trace] {label}: {elapsed:.4f} s")


class MetricsLogger:
    """Append-only JSONL metrics stream with wall-clock deltas: each record
    holds ``step``, ``time``, ``seconds_since_last`` and the metrics given
    (numbers, and 0-dim tensors, as floats)."""

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._last_time = time.perf_counter()

    def log(self, step: int, **metrics: Any) -> None:
        now = time.perf_counter()
        record = {
            "step": step,
            "time": time.time(),
            "seconds_since_last": round(now - self._last_time, 6),
        }
        self._last_time = now
        for key, value in metrics.items():
            try:
                record[key] = float(value)
            except (TypeError, ValueError, RuntimeError):
                record[key] = value
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def read(self) -> list:
        if not self.path.exists():
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]


@dataclass
class OptimizationCheckpoint:
    """Periodic snapshot of an optimization run, resumable.

    Holds the current design, the iteration histories and extras, written
    by ``save_data`` as numpy arrays (detached copies on the host, so a
    snapshot never aliases the run's tensors) and read back by
    :meth:`restore` as tensors on the device asked for.
    """

    path: Union[str, Path]
    every: int = 10

    def save(self, iteration: int, design: Any, objective_values=None, design_values=None,
             extras: Optional[Dict[str, Any]] = None, force: bool = False) -> bool:
        """Snapshot if due (every ``self.every`` iterations) or ``force``;
        returns whether a snapshot was written."""

        if not force and (iteration % self.every != 0):
            return False
        save_data(self.path, {
            "iteration": iteration,
            "design": design,
            "objective_values": objective_values or [],
            "design_values": design_values or [],
            "extras": extras or {},
        })
        return True

    def restore(self, device="cuda") -> Optional[Dict[str, Any]]:
        """The last snapshot, its arrays as tensors on ``device``, or None
        if there is none."""

        path = Path(self.path)
        if not path.exists():
            return None
        return load_data(path, device=device)

    def exists(self) -> bool:
        return Path(self.path).exists()
