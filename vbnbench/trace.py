"""The traced part of a ``--trace 1`` run: the benchmark's own spans
around its calls into the VBN, and ``torch.profiler``'s device events.

``traced_calls`` runs a bounded number of calls under the profiler, each
in a ``vbnbench.call`` span holding a ``vbnbench.vbn`` span (the call
into ``VBN``, which returns the rows on the host, so the fetch is inside
it); the rest of the call span is the client choosing its next batch.
``reduce_trace`` turns the events into per-call records (span, device
busy time inside it, device events) and the window's busy and idle time,
which the readers under ``metrics/`` take their numbers from.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

CALL = "vbnbench.call"
VBN = "vbnbench.vbn"


def traced_calls(n: int, one_call: Callable[[int], None]):
    """Run ``one_call(i)`` for i < n under the profiler; the profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            with record_function(CALL):
                one_call(i)
        torch.cuda.synchronize()
    return prof


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _overlap(merged, a: float, b: float) -> float:
    return sum(max(0.0, min(b, y) - max(a, x)) for x, y in merged)


def reduce_trace(prof) -> Dict:
    """Per-call records and window totals (times in microseconds)."""
    import torch

    events = list(prof.events())
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and not e.name.startswith("vbnbench.")]
    calls = sorted((e.time_range.start, e.time_range.end)
                   for e in events if e.name == CALL)
    vbn = sorted((e.time_range.start, e.time_range.end)
                 for e in events if e.name == VBN)
    iv = [(e.time_range.start, e.time_range.end) for e in dev]
    merged = _merge(iv)
    out_calls = []
    for a, b in calls:
        inside = [e for e in dev if a <= e.time_range.start < b]
        out_calls.append({"start_us": a, "end_us": b,
                          "busy_us": _overlap(merged, a, b),
                          "events": len(inside)})
    w0 = calls[0][0] if calls else 0.0
    w1 = calls[-1][1] if calls else 0.0
    busy = _overlap(merged, w0, w1)
    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    gaps = []
    prev = w0
    for x, y in merged + [(w1, w1)]:
        x, y = max(x, w0), min(y, w1)
        if x > prev:
            mid = 0.5 * (prev + x)
            k = next((j for j, (a, b) in enumerate(vbn) if a <= mid < b), None)
            label = ("inside the VBN call" if k is not None
                     else "in the client, between VBN calls")
            gaps.append((label, (x - prev) / 1e6))
        prev = max(prev, y)
    return {"calls": out_calls, "window_us": w1 - w0, "busy_us": busy,
            "device_events": len(dev),
            "device_ops": sorted(((k, v / 1e6) for k, v in by_name.items()),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": sorted(gaps, key=lambda kv: -kv[1])[:10]}
