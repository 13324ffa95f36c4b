"""Tracing and timing utilities: the port's spans, counters and timers.

Counterpart of ``vectorizedbayesiannetwork_tpu/utils/profiling.py``:
``trace`` captures a ``torch.profiler`` trace (CPU and CUDA activity)
around a block and writes it as a Chrome trace, ``timed_call`` times a call
up to the end of the device work its result needs (it synchronizes the
result's device before it reads the clock), and ``StageTimer`` sums
wall-clock ms per stage.

Spans. ``annotate(name, **attrs)`` is the port's span; ``spanned(name)``
puts a function's every call in one. A span records only while a
``torch.profiler`` session is active (``torch.autograd._profiler_enabled()``):
with none, it costs that one check and nothing else. While one is, a span
opens a ``record_function(name)`` range, so it lies on the profiler's own
timeline beside the CUDA kernels and copies, and appends a record to a
bounded in-memory buffer (``spans()``, cleared by ``reset_spans()``):

    {"name", "start_ns", "end_ns" (time.perf_counter_ns), "parent" (the
     enclosing span's index in spans(), -1 for a root), "call" (the root's
     call id, shared by its descendants), "attrs", "index" (its own)}

A span opened with no span open is a root and takes a new call id; a root
also records in ``attrs["builds"]`` what ``BUILDS`` counted inside it, in
``attrs["mlp_rows"]`` the rows of ``MLP`` forwards it ran, and in
``attrs["mlp_fused_rows"]`` those of them that ``vbn_gauss_mlp`` ran. The
served entries of ``VBN`` open one ``vbn.call`` root a call; the stages
below it are ``vbn.normalize``, ``vbn.plan``, ``vbn.pack``,
``vbn.upload``, ``vbn.build``, ``vbn.tables``, ``vbn.kernel.<name>``,
``vbn.draw``, ``vbn.sweep.<route>``, ``vbn.mlp.<sample|log_prob>`` (a
neural Gaussian CPD's forward), ``vbn.reduce.<path>``, ``vbn.fetch`` and
``vbn.sync``. The buffer holds spans of one thread: the served entries
are not re-entrant across threads. Spans past ``MAX_SPANS`` are not kept
(``spans_dropped()`` counts them), but still reach the profiler.

Waiting. A host-to-device copy from pageable memory waits for the work
queued on the stream before it returns, so its span's self time would be
the card's. Each such blocking point of a served path calls ``wait``
first: under a profiler the host waits there, inside a ``vbn.sync`` span
that no reader of host time reads, and the copy after it holds its own
cost alone. A fetch (``.cpu()``) is a ``vbn.fetch`` span, wait and copy
both.

Counters. A module makes each of its counters with ``counter(name,
keys)``, which registers it; ``counters()`` is one snapshot of every
registered counter, ``reset_counters()`` zeroes them. Importing the
package registers all eight: ``LAUNCHES`` (``ops/_launch.py``: kernel
launches by wrapper), ``TRACES`` (``ops/sweep.py``), ``ROUTES`` and
``GROUPS`` (``inference/_sweep.py``), ``SWEEPS``
(``inference/_dynamic_sweep.py``: per-node dynamic sweeps by what they
gave, each row's target block ``target_planes`` or the whole store
``packed``), ``CHAINS`` (``sampling/chains.py``),
``BUILDS`` (here: raw kernel functions built, ``fn``; per-call table
builds, ``tables``; plan-cache misses, ``plans``) and ``MLP`` (here: the
served MLP forwards of the neural Gaussian CPD, ``forwards``, and the rows
they ran, ``rows``; of them the forwards that the fused kernel
``vbn_gauss_mlp`` served, ``fused``, and their rows, ``fused_rows``; a
level group that the static sweep runs under ``torch.func.vmap`` runs the
forward's Python once, so counts as one node's forward). Counters are
plain integer bumps, always on.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import time
from collections import Counter
from typing import Dict, Iterable, List, Optional

import torch

from ..core.cache import DEFAULT_DIR

_DEFAULT_TRACE_DIR = str(DEFAULT_DIR.parent / "trace")  # build/trace

MAX_SPANS = 1 << 16  # records kept; later spans still reach the profiler

_COUNTERS: Dict[str, Dict[str, int]] = {}


def counter(name: str, keys: Optional[Iterable[str]] = None):
    """A new counter registered under ``name`` for ``counters()`` and
    ``reset_counters()``: a dict of ``keys`` at 0, or a ``Counter`` when
    ``keys`` is None."""
    c = Counter() if keys is None else dict.fromkeys(keys, 0)
    _COUNTERS[name] = c
    return c


BUILDS = counter("BUILDS", ("fn", "tables", "plans"))
MLP = counter("MLP", ("forwards", "rows", "fused", "fused_rows"))

_recording = torch.autograd._profiler_enabled
_SPANS: List[Dict] = []
_OPEN: List["_Span"] = []
_call_ids = itertools.count(1)
_dropped = 0  # spans not kept since the last reset_spans()


@contextlib.contextmanager
def trace(log_dir: str = _DEFAULT_TRACE_DIR):
    """Profile a block with ``torch.profiler`` and write
    ``<log_dir>/trace.json`` (chrome://tracing, Perfetto). Yields the
    profiler, whose ``key_averages()`` gives the per-op table; the port's
    spans record inside the block."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class _Off:
    """The span while no profiler runs: it does nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("rec", "_rf", "_builds", "_mlp_rows", "_mlp_fused_rows")

    def __init__(self, name: str, attrs: Dict) -> None:
        self.rec = {"name": name, "start_ns": 0, "end_ns": 0, "parent": -1,
                    "call": 0, "attrs": attrs}

    def __enter__(self):
        global _dropped
        rec = self.rec
        self._rf = torch.profiler.record_function(rec["name"])
        self._rf.__enter__()
        if _OPEN:
            up = _OPEN[-1].rec
            rec["parent"], rec["call"] = up.get("index", -1), up["call"]
        else:
            rec["call"] = next(_call_ids)
            self._builds = dict(BUILDS)
            self._mlp_rows = MLP["rows"]
            self._mlp_fused_rows = MLP["fused_rows"]
        if len(_SPANS) < MAX_SPANS:
            rec["index"] = len(_SPANS)
            _SPANS.append(rec)
        else:
            _dropped += 1
        _OPEN.append(self)
        rec["start_ns"] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec["end_ns"] = time.perf_counter_ns()
        _OPEN.pop()
        if not _OPEN:
            rec["attrs"]["builds"] = {k: v - self._builds[k]
                                      for k, v in BUILDS.items()}
            rec["attrs"]["mlp_rows"] = MLP["rows"] - self._mlp_rows
            rec["attrs"]["mlp_fused_rows"] = (MLP["fused_rows"]
                                              - self._mlp_fused_rows)
        self._rf.__exit__(*exc)
        return False

    def set(self, **attrs) -> None:
        """Add attributes to the span (rows known only at its end)."""
        self.rec["attrs"].update(attrs)


def annotate(name: str, **attrs):
    """A span named ``name`` around a ``with`` block (see the module note);
    ``with annotate(...) as sp: sp.set(rows=n)`` adds attributes."""
    if not _recording():
        return _OFF
    return _Span(name, attrs)


def spanned(name: str):
    """Decorator: every call of the function runs inside ``annotate(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _recording():
                return fn(*args, **kwargs)
            with _Span(name, {}):
                return fn(*args, **kwargs)

        return call

    return wrap


def wait(device) -> None:
    """A blocking point of a served path (see the module note): under a
    profiler, on a CUDA device, the host waits for the stream's queued work
    inside a ``vbn.sync`` span; otherwise nothing, after the one check."""
    if _recording() and torch.device(device).type == "cuda":
        with _Span("vbn.sync", {}):
            torch.cuda.current_stream(device).synchronize()


def spans() -> List[Dict]:
    """The span records, in the order the spans opened (see the module
    note); ``index`` is a record's place in this list. The list itself,
    not a copy: read it between calls."""
    return _SPANS


def spans_dropped() -> int:
    """Spans not kept because the buffer held ``MAX_SPANS``, since the last
    ``reset_spans()``: while it is above 0, ``spans()`` lacks calls."""
    return _dropped


def reset_spans() -> None:
    """Empty the buffer; between calls, while no span is open."""
    global _dropped
    _SPANS.clear()
    _dropped = 0


def counters() -> Dict[str, Dict[str, int]]:
    """A snapshot of every counter of the port, by its name."""
    return {name: dict(c) for name, c in _COUNTERS.items()}


def reset_counters() -> None:
    """Zero every counter: a fixed-key counter keeps its keys, a
    ``Counter`` is emptied."""
    for c in _COUNTERS.values():
        if isinstance(c, Counter):
            c.clear()
        else:
            for k in c:
                c[k] = 0


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
