"""Device kernels, copies and fills a call launches, from the profiler,
averaged over the traced calls (dispatch)."""


def read(ctx):
    calls = ctx.get("calls") or []
    if not calls:
        return None
    return sum(c["events"] for c in calls) / len(calls)
