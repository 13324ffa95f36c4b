"""Host time a call: the part of each call's span in which the device ran
nothing, averaged over the traced calls (entry and method on the host)."""


def read(ctx):
    calls = ctx.get("calls") or []
    if not calls:
        return None
    idle = [(c["end_us"] - c["start_us"] - c["busy_us"]) / 1e3 for c in calls]
    return sum(idle) / len(idle)
