"""Host time a call spent enqueueing device work: the self time of the
port's ``vbn.kernel.*`` (a hand kernel's wrapper), ``vbn.draw`` (row-stream
draws) and ``vbn.sweep.*`` (a torch-op sweep) spans, averaged over the
traced calls (dispatch). The waits at blocking copies inside them are
``vbn.sync`` spans, so not their self time."""

from vbnbench.port_spans import self_ms_per_call


def _enqueues(name):
    return (name == "vbn.draw" or name.startswith("vbn.kernel.")
            or name.startswith("vbn.sweep."))


def read(ctx):
    return self_ms_per_call(ctx, _enqueues)
