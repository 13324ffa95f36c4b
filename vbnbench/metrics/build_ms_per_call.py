"""Host time a call spent building what a call could reuse: the self time
of the port's ``vbn.build`` (raw kernel functions, their gates and plan
structures) and ``vbn.tables`` (table builds on the device) spans,
averaged over the traced calls (dispatch)."""

from vbnbench.port_spans import self_ms_per_call

NAMES = {"vbn.build", "vbn.tables"}


def read(ctx):
    return self_ms_per_call(ctx, NAMES.__contains__)
