"""Tracing and timing utilities.

Counterpart of ``vectorizedbayesiannetwork_tpu/utils/profiling.py``:
``trace`` captures a ``torch.profiler`` trace (CPU and CUDA activity)
around a block and writes it as a Chrome trace, ``annotate`` opens a named
span that shows in such traces, and ``timed_call`` times a call up to the
end of the device work its result needs (it synchronizes the result's
device before it reads the clock). ``StageTimer`` sums wall-clock ms per
stage.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch

from ..core.cache import DEFAULT_DIR

_DEFAULT_TRACE_DIR = str(DEFAULT_DIR.parent / "trace")  # build/trace


@contextlib.contextmanager
def trace(log_dir: str = _DEFAULT_TRACE_DIR):
    """Profile a block with ``torch.profiler`` and write
    ``<log_dir>/trace.json`` (chrome://tracing, Perfetto). Yields the
    profiler, whose ``key_averages()`` gives the per-op table."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named span that shows up inside profiler traces."""
    return torch.profiler.record_function(name)


def _devices(out, found):
    if isinstance(out, torch.Tensor):
        found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _devices(v, found)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _devices(v, found)
    return found


def timed_call(fn, *args, **kwargs):
    """(result, ms): the call's wall time up to the end of the work on
    every CUDA device its tensor outputs lie on."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    for dev in _devices(out, set()):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return out, (time.perf_counter() - t0) * 1000.0


class StageTimer:
    """Accumulate per-stage wall-clock ms across repeated calls."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            ms = (time.perf_counter() - t0) * 1000.0
            self.totals[name] = self.totals.get(name, 0.0) + ms
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_ms": self.totals[name],
                "calls": self.counts[name],
                "mean_ms": self.totals[name] / self.counts[name],
            }
            for name in self.totals
        }
