"""Share of the rows of the neural CPDs' MLP forwards that the port's fused
kernel (``vbn_gauss_mlp``) ran, in percent: the ``mlp_fused_rows`` over the
``mlp_rows`` that the traced calls' ``vbn.call`` roots recorded (neural
CPD forward). None where the port records no ``mlp_fused_rows`` (an older
checkout) or the traced calls ran no MLP forward."""

from vbnbench.port_spans import traced_roots


def read(ctx):
    got = traced_roots(ctx)
    if got is None:
        return None
    _recs, roots = got
    if any("mlp_fused_rows" not in r["attrs"] or "mlp_rows" not in r["attrs"]
           for r in roots):
        return None
    rows = sum(r["attrs"]["mlp_rows"] for r in roots)
    if not rows:
        return None
    return 100.0 * sum(r["attrs"]["mlp_fused_rows"] for r in roots) / rows
