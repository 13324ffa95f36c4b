"""The fits, worked out again from the rows the benchmark made.

- ``categorical_cpts``: smoothed counts, as the ``categorical_table`` CPD
  defines them: ``count[pa, c] + prior_mass * prior[c]``, with
  ``prior_mass = alpha`` (``total_mass``) or ``alpha * C``
  (``per_class``) and ``prior`` the target's empirical marginal
  (``global``) or uniform; rows normalized, each probability floored at
  1e-12.
- ``scott_bandwidths``: Scott's rule, ``mean sigma * n_eff^(-1/(d+4))``
  with ``n_eff = min(n, max_points)`` and ``d`` the joint dimension, floored
  at 1e-3; a root's parent bandwidth is its own.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def categorical_cpts(nodes: List[str], parents: Dict[str, List[str]],
                     cards: Dict[str, int], data: Dict[str, np.ndarray], *,
                     alpha: float = 1.0, alpha_mode: str = "total_mass",
                     prior: str = "global") -> Dict[str, np.ndarray]:
    out = {}
    for node in nodes:
        ps = parents[node]
        k = cards[node]
        x = np.asarray(data[node]).reshape(-1).astype(np.int64)
        shape = tuple(cards[p] for p in ps) + (k,)
        counts = np.zeros(shape, np.float64)
        idx = tuple(np.asarray(data[p]).reshape(-1).astype(np.int64)
                    for p in ps) + (x,)
        np.add.at(counts, idx, 1.0)
        if alpha > 0:
            if prior == "uniform":
                pri = np.full(k, 1.0 / k)
            else:
                marg = np.bincount(x, minlength=k).astype(np.float64)
                pri = marg / marg.sum() if marg.sum() > 0 else np.full(k, 1.0 / k)
            mass = alpha * k if alpha_mode == "per_class" else alpha
            counts = counts + mass * pri
        total = np.maximum(counts.sum(axis=-1, keepdims=True), 1e-12)
        out[node] = np.maximum(counts / total, 1e-12)
    return out


def scott_bandwidths(x: np.ndarray, parents: np.ndarray, max_points: int
                     ) -> Tuple[float, float]:
    """(bandwidth, parent bandwidth) of one KDE node; ``parents`` [n, dp]
    (dp may be 0)."""
    x = np.asarray(x, np.float64).reshape(x.shape[0], -1)
    n_eff = max(2, min(x.shape[0], int(max_points)))
    d = x.shape[1] + parents.shape[1]
    rate = float(n_eff) ** (-1.0 / (d + 4))
    bw = max(float(np.mean(np.std(x, axis=0))) * rate, 1e-3)
    if parents.shape[1] == 0:
        return bw, bw
    pbw = max(float(np.mean(np.std(np.asarray(parents, np.float64), axis=0)))
              * rate, 1e-3)
    return bw, pbw
