"""Rows a call ran through the neural CPDs' MLP forwards, in millions: the
``mlp_rows`` that each traced call's ``vbn.call`` root recorded (the
port's ``MLP["rows"]`` counted inside it), averaged over the traced calls
(neural CPD forward). None where the port records no ``mlp_rows`` (an
older checkout) or the traced calls ran no MLP forward. The counter is
exact on the mask-dynamic loop, which runs a node's forward at a time; a
level group that the static sweep vmaps counts once for the group."""

from vbnbench.port_spans import traced_roots


def read(ctx):
    got = traced_roots(ctx)
    if got is None:
        return None
    _recs, roots = got
    if any("mlp_rows" not in r["attrs"] for r in roots):
        return None
    rows = sum(r["attrs"]["mlp_rows"] for r in roots)
    return rows / 1e6 / len(roots) if rows else None
