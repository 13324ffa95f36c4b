"""Seeded linear-Gaussian networks, the data-generating class of the KDE
configurations.

Frozen, JAX-free copy of ``benchmarking/gaussian_bn.py``: ``GaussianNet``
is its ``GaussianBN`` (``:25-101``: the joint system, the marginal std and
the ancestral sampler) and ``random_gaussian`` its generator
(``:104-127``). Each node is ``x_i = b_i + sum_j W_ij x_j +
eps_i``, ``eps_i ~ N(0, sigma_i^2)``.

The network kind ``gaussian``: ``build(spec)`` reads a configuration's
``network`` entry (``n_nodes``, ``seed``, ``max_in_degree``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from vbnbench.traffic import stage2


@dataclass
class GaussianNet:
    name: str
    nodes: List[str] = field(default_factory=list)  # topological order
    parents: Dict[str, List[str]] = field(default_factory=dict)
    weights: Dict[str, List[float]] = field(default_factory=dict)
    bias: Dict[str, float] = field(default_factory=dict)
    sigma: Dict[str, float] = field(default_factory=dict)

    def system(self):
        """(mu [n], Sigma [n, n]) of the joint."""
        n = len(self.nodes)
        idx = {v: i for i, v in enumerate(self.nodes)}
        b = np.zeros((n, n))
        c = np.zeros(n)
        d = np.zeros(n)
        for v in self.nodes:
            i = idx[v]
            c[i] = self.bias[v]
            d[i] = self.sigma[v] ** 2
            for w, p in zip(self.weights[v], self.parents[v]):
                b[i, idx[p]] = w
        a = np.linalg.inv(np.eye(n) - b)
        return a @ c, a @ np.diag(d) @ a.T

    def marginal_std(self, node: str) -> float:
        _mu, cov = self.system()
        i = self.nodes.index(node)
        return float(np.sqrt(max(cov[i, i], 1e-12)))

    def sample(self, n_rows: int, seed: int = 0) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(seed)
        out: Dict[str, np.ndarray] = {}
        for v in self.nodes:
            loc = np.full(n_rows, self.bias[v])
            for w, p in zip(self.weights[v], self.parents[v]):
                loc = loc + w * out[p]
            out[v] = loc + self.sigma[v] * rng.standard_normal(n_rows)
        return out

    # what the harness, the traffic generator and the fit ask of a network
    def stage2_queries(self, manifold, n_queries, seed, modes, max_evidence):
        return stage2.gaussian_queries(self, manifold, n_queries, seed,
                                       tuple(modes), max_evidence)

    def served_values(self, values: np.ndarray) -> np.ndarray:
        return np.round(values, 4)

    def call_kwargs(self, target: Optional[str] = None) -> Dict:
        return {}

    def cpd_params(self, node: str) -> Dict:
        return {}


def build(spec: Dict) -> GaussianNet:
    return random_gaussian(int(spec["n_nodes"]), seed=int(spec["seed"]),
                           max_in_degree=int(spec["max_in_degree"]))


def random_gaussian(n_nodes: int, seed: int = 0,
                    max_in_degree: int = 3) -> GaussianNet:
    """Seeded random linear-Gaussian DAG."""
    rng = np.random.default_rng(seed)
    net = GaussianNet(name=f"gauss{n_nodes}_s{seed}")
    for i in range(n_nodes):
        v = f"x{i}"
        net.nodes.append(v)
        k = int(rng.integers(0, min(i, max_in_degree) + 1))
        ps = ([f"x{j}" for j in rng.choice(i, size=k, replace=False)]
              if k else [])
        net.parents[v] = ps
        signs = rng.choice([-1.0, 1.0], size=len(ps))
        net.weights[v] = [float(s * u) for s, u in
                          zip(signs, rng.uniform(0.3, 1.0, size=len(ps)))]
        net.bias[v] = float(rng.normal(0.0, 0.5))
        net.sigma[v] = float(rng.uniform(0.3, 1.0))
    return net
