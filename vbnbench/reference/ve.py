"""Exact answers of discrete queries, and the likelihood-weighting
variance beside each, by variable elimination in float64.

For a skeleton (a target and its evidence nodes) one elimination gives
the table ``P(t, e)`` over the target and the evidence nodes; a second,
with each evidence node's CPT squared, gives ``M2(t, e) = E_q[w^2 1{T=t}]``
under likelihood weighting's proposal ``q`` (the network with the evidence
clamped) and weight ``w = prod_j p(e_j | pa_j)``. A row's answer is
``p = P(., e) / Z`` with ``Z = P(e)``, and the delta-method variance of
the self-normalized estimate of class c from S particles is
``sum_t (1{t=c} - p_c)^2 M2(t, e) / (S Z^2)``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def min_fill_order(nodes: Sequence[str], parents: Dict[str, List[str]],
                   cards: Dict[str, int]) -> List[str]:
    """Greedy min-fill elimination order of the moralized graph (ties by
    weight, then name), as ``benchmarking/exact.py:74-124``."""
    adj: Dict[str, set] = {n: set() for n in nodes}
    for c in nodes:
        ps = parents[c]
        for p in ps:
            adj[c].add(p)
            adj[p].add(c)
        for i in range(len(ps)):
            for j in range(i + 1, len(ps)):
                adj[ps[i]].add(ps[j])
                adj[ps[j]].add(ps[i])
    remaining = set(nodes)
    order: List[str] = []

    def cost(v):
        nb = list(adj[v] & remaining)
        fill = sum(1 for i in range(len(nb)) for j in range(i + 1, len(nb))
                   if nb[j] not in adj[nb[i]])
        w = cards[v]
        for u in nb:
            w *= cards[u]
        return fill, w, v

    while remaining:
        best = min(remaining, key=cost)
        nb = list(adj[best] & remaining)
        for i in range(len(nb)):
            for j in range(i + 1, len(nb)):
                adj[nb[i]].add(nb[j])
                adj[nb[j]].add(nb[i])
        remaining.discard(best)
        order.append(best)
    return order


class Exact:
    """Variable elimination over fixed CPTs; tables cached per skeleton."""

    def __init__(self, nodes, parents, cards, cpts) -> None:
        self.nodes = list(nodes)
        self.parents = {n: list(parents[n]) for n in nodes}
        self.cards = dict(cards)
        self.cpts = cpts
        self.index = {n: i for i, n in enumerate(self.nodes)}
        self.order = min_fill_order(self.nodes, self.parents, self.cards)
        self._tables: Dict[Tuple, Tuple[np.ndarray, np.ndarray]] = {}

    def _eliminate(self, keep: Tuple[str, ...], square: Sequence[str]):
        ix = self.index
        factors = []
        for n in self.nodes:
            t = self.cpts[n] ** 2 if n in square else self.cpts[n]
            factors.append((tuple(ix[p] for p in self.parents[n]) + (ix[n],), t))
        kept = {ix[k] for k in keep}
        for var in self.order:
            v = ix[var]
            if v in kept:
                continue
            hit = [f for f in factors if v in f[0]]
            if not hit:
                continue
            factors = [f for f in factors if v not in f[0]]
            out = sorted({u for f in hit for u in f[0]} - {v})
            args = []
            for vs, t in hit:
                args += [t, list(vs)]
            factors.append((tuple(out), np.einsum(*args, out)))
        out = [ix[k] for k in keep]
        args = []
        for vs, t in factors:
            args += [t, list(vs)]
        return np.einsum(*args, out)

    def tables(self, target: str, ev_nodes: Tuple[str, ...]):
        """(P, M2), each over (target, *ev_nodes)."""
        key = (target, ev_nodes)
        if key not in self._tables:
            keep = (target,) + tuple(ev_nodes)
            p = self._eliminate(keep, ())
            m2 = self._eliminate(keep, ev_nodes) if ev_nodes else p
            self._tables[key] = (p, m2)
        return self._tables[key]

    def answer(self, target: str, evidence: Dict[str, float]):
        """(p [card], lw_var [card]): the exact posterior of one row and the
        per-particle variance of its likelihood-weighting estimate (divide
        by S for the estimate's variance)."""
        ev_nodes = tuple(sorted(evidence))
        p_tab, m2_tab = self.tables(target, ev_nodes)
        at = (slice(None),) + tuple(int(evidence[n]) for n in ev_nodes)
        pt, m2 = p_tab[at], m2_tab[at]
        z = pt.sum()
        p = pt / z
        diff = np.eye(len(p)) - p[None, :]  # [t, c]: 1{t=c} - p_c
        var = (diff ** 2 * m2[:, None]).sum(axis=0) / z ** 2
        return p, var
