"""The port's own spans and counters over the traced window, as
``vectorizedbayesiannetwork_torch.utils.profiling`` keeps them: what the
readers of ``prepare_ms_per_call``, ``build_ms_per_call``,
``enqueue_ms_per_call`` and ``builds_per_call`` take their numbers from.

The port records a span only while ``torch.profiler`` runs, and the
profiler runs only over the traced calls (``trace.traced_calls``), so the
traced window's calls are the last ``len(ctx["calls"])`` ``vbn.call`` roots
of the port's buffer. A port with no spans (an older checkout, which a
comparison may run under this harness), a buffer with
fewer roots than traced calls, or one that dropped spans past its bound,
gives None.

Self time leaves out child spans, so it leaves out the port's
``vbn.sync`` (the host waiting for the card at a blocking copy) and
``vbn.fetch`` (waiting for rows and copying them back): the host-time
readers read the host's own work, not the card's.
"""

from __future__ import annotations

ROOT = "vbn.call"


def traced_roots(ctx):
    """``(records, roots)``: the port's span buffer and the roots of the
    traced calls, or None."""
    from vectorizedbayesiannetwork_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    n = len(ctx.get("calls") or [])
    if spans is None or n == 0 or profiling.spans_dropped():
        return None
    recs = spans()
    roots = [r for r in recs if r["name"] == ROOT and r["parent"] < 0]
    if len(roots) < n:
        return None
    return recs, roots[-n:]


def self_ms_per_call(ctx, match):
    """The traced calls' self time, in ms a call, of their spans whose name
    ``match`` accepts: each span's duration less the part its child spans
    cover (a thread's children do not overlap), or None."""
    got = traced_roots(ctx)
    if got is None:
        return None
    recs, roots = got
    calls = {r["call"] for r in roots}
    covered = {}
    for r in recs:
        if r["call"] in calls and r["parent"] >= 0:
            covered[r["parent"]] = (covered.get(r["parent"], 0)
                                    + r["end_ns"] - r["start_ns"])
    self_ns = sum(r["end_ns"] - r["start_ns"] - covered.get(i, 0)
                  for i, r in enumerate(recs)
                  if r["call"] in calls and match(r["name"]))
    return self_ns / 1e6 / len(roots)
