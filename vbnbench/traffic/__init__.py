"""The one traffic generator: it reads a mix file ``traffic/<mix>.json``
and makes a cell's calls from the network and a seed.

A mix file holds parameters only:

- ``shape``: ``"fixed"`` (each call is one query of ``rows_per_call``
  rows sharing a skeleton: a target and 1-``max_evidence`` evidence
  nodes; ``skeletons`` of them, taken round robin, their evidence values
  drawn per row from on-manifold ancestral rows) or ``"mixed"`` (each
  call is ``rows_per_call`` single-row queries of the Stage II mix, each
  with its own target and 0-``max_evidence`` evidence nodes; a pool of
  ``pool_calls`` calls walked in turn);
- ``evidence_modes``: the Stage II evidence modes, taken in turn;
- ``call_kwargs`` (mixed): keyword arguments of every call
  (``dynamic_masks``; ``pad_bucket``, so that padding adds no rows).

The network supplies the rest (``networks/__init__.py``): its ancestral
rows, its Stage II queries, evidence values as served (a discrete
network's state indices; a Gaussian one's values to 4 places), and the
keyword arguments a call over it needs (a discrete network's
``n_classes``: the target's states for a fixed call, the most of any node
for a mixed one). Each call carries, per returned row, its (target,
evidence) for the check.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np


@dataclass
class Call:
    queries: List[Dict]  # the query dicts passed to the VBN
    kwargs: Dict  # the call's keyword arguments
    rows: List[Tuple[str, Dict[str, float]]]  # (target, evidence) per row


def _stage2(net, n_queries, seed, modes, max_ev):
    manifold = net.sample(max(2 * n_queries, 256), seed + 1)
    return net.stage2_queries(manifold, n_queries, seed, modes, max_ev)


def _col(values) -> np.ndarray:
    return np.asarray(values, np.float32).reshape(-1, 1)


def _fixed_calls(net, mix, seed) -> List[Call]:
    """``skeletons`` distinct (target, evidence nodes) of the Stage II mix
    with at least one evidence node, each a call of ``rows_per_call`` rows
    whose values come from on-manifold rows."""
    b = int(mix["rows_per_call"])
    qs = _stage2(net, int(mix["stage2_queries"]), seed,
                 mix["evidence_modes"], int(mix["max_evidence"]))
    skeletons, seen = [], set()
    for q in qs:
        key = (q.target, tuple(sorted(q.evidence)))
        if q.evidence and key not in seen:
            seen.add(key)
            skeletons.append(key)
    need = int(mix["skeletons"])
    if len(skeletons) < need:
        raise ValueError(f"the mix gives {len(skeletons)} skeletons < {need}")
    rows = net.sample(b * need, seed + 2)
    calls = []
    for j, (target, ev_nodes) in enumerate(skeletons[:need]):
        at = slice(j * b, (j + 1) * b)
        vals = {n: net.served_values(rows[n][at]) for n in ev_nodes}
        calls.append(Call(
            queries=[{"target": target,
                      "evidence": {n: _col(v) for n, v in vals.items()}}],
            kwargs=net.call_kwargs(target),
            rows=[(target, {n: float(vals[n][r]) for n in ev_nodes})
                  for r in range(b)]))
    return calls


def _mixed_calls(net, mix, seed) -> List[Call]:
    b = int(mix["rows_per_call"])
    n_calls = int(mix["pool_calls"])
    qs = _stage2(net, b * n_calls, seed, mix["evidence_modes"],
                 int(mix["max_evidence"]))
    kwargs = dict(mix.get("call_kwargs", {}), **net.call_kwargs(None))
    calls = []
    for c in range(n_calls):
        part = qs[c * b:(c + 1) * b]
        calls.append(Call(
            queries=[{"target": q.target,
                      "evidence": {n: _col([v]) for n, v in q.evidence.items()}}
                     for q in part],
            kwargs=dict(kwargs),
            rows=[(q.target, {n: float(v) for n, v in q.evidence.items()})
                  for q in part]))
    return calls


def make_calls(net, mix: Dict, seed: int) -> List[Call]:
    """The pool of calls a cell walks through, from its mix and a seed."""
    if mix["shape"] == "fixed":
        return _fixed_calls(net, mix, seed)
    if mix["shape"] == "mixed":
        return _mixed_calls(net, mix, seed)
    raise ValueError(f"unknown traffic shape {mix['shape']!r}")
