"""The calls' likelihood-weighting work at the H100's published peaks
(``work/<family>.py``, ``peaks.least_ms``) over the device time the calls
caused, in percent (kernels). None where no call has a work count or the
device ran nothing."""


def read(ctx):
    calls = ctx.get("calls") or []
    least = ctx.get("least_ms") or []
    if not calls or len(least) != len(calls):
        return None
    busy_ms = sum(c["busy_us"] for c in calls) / 1e3
    if busy_ms <= 0:
        return None
    return 100.0 * sum(least) / busy_ms
