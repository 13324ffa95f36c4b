"""Discrete networks: a canonical structure with seeded Dirichlet CPTs.

The network kind ``discrete``: ``build(spec)`` reads a configuration's
``network`` entry (``structure``, ``cpt_seed``, ``dirichlet``).

Frozen, JAX-free copies of the repo's earlier benchmark pieces:

- ``from_structure``: the seeded-Dirichlet CPT draw of
  ``benchmarking/midsize.py:98-125`` (each node its own
  ``zlib.crc32(f"{name}/{node}/{seed}")`` generator, concentration 0.6);
  the structure itself is the data file ``networks/<name>.json``;
- ``DiscreteNet.topological_order``: ``benchmarking/bif.py:41-55``;
- ``ancestral_sample``: ``benchmarking/exact.py:246-263``.

The published ALARM CPT values ship only in the bnlearn files, which this
repository does not hold, so the CPTs are drawn (the configuration lists
them under ``assumed``).
"""

from __future__ import annotations

import json
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from vbnbench.traffic import stage2

HERE = Path(__file__).resolve().parent


@dataclass
class DiscreteNet:
    """Nodes in topological order, their state counts, parents and CPTs
    (``cpts[node]`` has shape ``parent cards + (card,)``)."""

    name: str
    nodes: List[str] = field(default_factory=list)
    cards: Dict[str, int] = field(default_factory=dict)
    parents: Dict[str, List[str]] = field(default_factory=dict)
    cpts: Dict[str, np.ndarray] = field(default_factory=dict)

    def card(self, node: str) -> int:
        return self.cards[node]

    # what the harness, the traffic generator and the fit ask of a network
    def sample(self, n: int, seed: int = 0) -> Dict[str, np.ndarray]:
        return ancestral_sample(self, n, seed=seed)

    def stage2_queries(self, manifold, n_queries, seed, modes, max_evidence):
        return stage2.discrete_queries(self, manifold, n_queries, seed,
                                       tuple(modes), max_evidence)

    def served_values(self, values: np.ndarray) -> np.ndarray:
        return np.asarray(values).astype(np.int64)

    def call_kwargs(self, target: Optional[str] = None) -> Dict:
        """A pmf call's classes: the target's, or the most of any node."""
        return {"n_classes": self.card(target) if target is not None
                else max(self.cards.values())}

    def cpd_params(self, node: str) -> Dict:
        """The state counts of a node and its parents."""
        out = {"n_classes": self.card(node)}
        if self.parents[node]:
            out["parent_n_classes"] = [self.card(p) for p in self.parents[node]]
        return out

    def topological_order(self) -> List[str]:
        order: List[str] = []
        seen = set()

        def visit(n):
            if n in seen:
                return
            for p in self.parents.get(n, []):
                visit(p)
            seen.add(n)
            order.append(n)

        for n in self.nodes:
            visit(n)
        return order


def load_structure(name: str) -> Dict:
    return json.loads((HERE / f"{name}.json").read_text())


def from_structure(name: str, seed: int = 0,
                   concentration: float = 0.6) -> DiscreteNet:
    """Seeded-Dirichlet CPTs over the structure file ``<name>.json``."""
    spec = load_structure(name)["nodes"]
    net = DiscreteNet(name=name)
    for node, (k, parents) in spec.items():
        net.nodes.append(node)
        net.cards[node] = int(k)
        net.parents[node] = list(parents)
    for node, (k, parents) in spec.items():
        rng = np.random.default_rng(
            zlib.crc32(f"{name}/{node}/{seed}".encode()) % (2**32)
        )
        rows = int(np.prod([spec[p][0] for p in parents])) if parents else 1
        table = rng.dirichlet(np.full(k, concentration), size=rows)
        shape = tuple(spec[p][0] for p in parents) + (k,)
        net.cpts[node] = table.astype(np.float64).reshape(shape)
    net.nodes = net.topological_order()
    return net


def build(spec: Dict) -> DiscreteNet:
    return from_structure(spec["structure"], seed=int(spec["cpt_seed"]),
                          concentration=float(spec["dirichlet"]))


def ancestral_sample(net: DiscreteNet, n: int, seed: int = 0
                     ) -> Dict[str, np.ndarray]:
    """n joint draws (state indices) by a vectorized ancestral sweep."""
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}
    for node in net.topological_order():
        parents = net.parents[node]
        cpt = net.cpts[node]
        card = net.card(node)
        if not parents:
            probs = np.broadcast_to(cpt, (n, card))
        else:
            probs = cpt[tuple(out[p] for p in parents)]
        u = rng.random((n, 1))
        out[node] = (probs.cumsum(axis=1) < u).sum(axis=1).clip(0, card - 1)
    return out
