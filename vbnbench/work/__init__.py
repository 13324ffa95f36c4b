"""Counts of the work a call's likelihood weighting needs, one module per
CPD family (``work/<family>.py``, each with ``count(net, call, s)``),
found by the family's name; a module may define ``network(cell)``, what
its count reads, where the network alone is not enough (the KDE support
size from the configuration). They count the function from the network,
the configuration, the call's rows and the particle count alone, never a
kernel's design or the program's state: whatever serves the call, the
same call reads the same work.
"""
