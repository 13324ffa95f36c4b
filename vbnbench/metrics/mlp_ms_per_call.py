"""Host time a call spent in the neural CPDs' MLP forwards: the self time
of the port's ``vbn.mlp.sample`` and ``vbn.mlp.log_prob`` spans, averaged
over the traced calls (neural CPD forward). It reads the host's
enqueueing of the forward, not the card's time in it: the trace's
reduction keeps no link from a kernel to the span that launched it. None
where the traced calls opened no such span (no MLP forward, or an older
checkout)."""

from vbnbench.port_spans import self_ms_per_call, traced_roots


def _mlp(name):
    return name.startswith("vbn.mlp.")


def read(ctx):
    got = traced_roots(ctx)
    if got is None:
        return None
    recs, roots = got
    calls = {r["call"] for r in roots}
    if not any(r["call"] in calls and _mlp(r["name"]) for r in recs):
        return None
    return self_ms_per_call(ctx, _mlp)
