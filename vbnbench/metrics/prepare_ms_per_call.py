"""Host time a call spent preparing its inputs: the self time of the
port's ``vbn.normalize``, ``vbn.plan``, ``vbn.pack`` and ``vbn.upload``
spans, averaged over the traced calls (entry and method, host). An
upload's wait for the card is its child ``vbn.sync``, so not its self
time."""

from vbnbench.port_spans import self_ms_per_call

NAMES = {"vbn.normalize", "vbn.plan", "vbn.pack", "vbn.upload"}


def read(ctx):
    return self_ms_per_call(ctx, NAMES.__contains__)
