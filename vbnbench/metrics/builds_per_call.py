"""Builds a call of what a call could reuse: the port's ``BUILDS`` counts
(raw kernel functions ``fn``, table builds ``tables``, plan-cache misses
``plans``) that each traced call's ``vbn.call`` root recorded, averaged
over the traced calls (dispatch)."""

from vbnbench.port_spans import traced_roots


def read(ctx):
    got = traced_roots(ctx)
    if got is None:
        return None
    _recs, roots = got
    return sum(sum(r["attrs"]["builds"].values()) for r in roots) / len(roots)
