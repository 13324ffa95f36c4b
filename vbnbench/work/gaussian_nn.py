"""The work of likelihood weighting over neural Gaussian CPDs.

Counted per particle and row, one forward a node with parents (what
likelihood weighting needs; a sweep that runs a node's forward twice does
more than this count, so its share of the roofline is lower):

- a node with dp parents and hidden widths h_1 .. h_k: the forward,
  2 (dp h_1 + h_1 h_2 + ... + h_k 2) float32 operations (multiply-adds,
  TF32 off) and its biases (h_1 + ... + h_k + 2), ReLU (h_1 + ... +
  h_k), the parents' standardization (2 dp), the denormalization (3)
  and the softplus floor (2, and an exp and a log);
- a root: its (loc, scale) read;
- a free node: a normal (two random words, 56, and Box-Muller: 3 special
  functions, 3 operations) and the value (2);
- an evidence node: its log-density (the z-score, its square, the sum
  and the weight's update: 7, and a log);
- the reduction: the weight's shift and exp (2, 1) and the moments (5),
  as ``work/kde.py`` counts it.

Bytes: each input read once (every node's weights and stats, the rows'
evidence values and targets), each output written once (mean, std).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict


def network(cell):
    """What ``count`` reads: the network's nodes and parents and the
    configuration's hidden widths."""
    hidden = [int(h) for h in cell.config["cpd"]["params"]["hidden_dims"]]
    return SimpleNamespace(nodes=cell.net.nodes, parents=cell.net.parents,
                           hidden=hidden)


def forward(dp: int, hidden) -> Dict[str, float]:
    """A node's forward for one particle: operations and special
    functions."""
    dims = [dp] + list(hidden) + [2]
    macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    ops = 2 * macs + sum(dims[1:]) + sum(hidden) + 2 * dp + 3 + 2
    return {"ops": float(ops), "sfu": 2.0}


def weights(dp: int, hidden) -> int:
    if dp == 0:
        return 2
    dims = [dp] + list(hidden) + [2]
    return sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))


def count(net, call, s: int) -> Dict[str, float]:
    """``net``: an object with ``nodes``, ``parents`` and ``hidden``."""
    ops = sfu = 0.0
    normal_ops, normal_sfu = 56 + 3, 3
    for _target, evidence in call.rows:
        for node in net.nodes:
            dp = len(net.parents[node])
            if dp:
                f = forward(dp, net.hidden)
                ops += f["ops"] * s
                sfu += f["sfu"] * s
            if node in evidence:
                ops += 7 * s
                sfu += s
            else:
                ops += (normal_ops + 2) * s
                sfu += normal_sfu * s
        ops += 7 * s
        sfu += s
    params = sum(weights(len(net.parents[v]), net.hidden)
                 + 2 * len(net.parents[v]) + 2 for v in net.nodes)
    inputs = sum(len(ev) + 1 for _t, ev in call.rows) + params
    return {"ops": ops, "sfu": sfu, "tc": 0.0,
            "bytes": 4.0 * (inputs + 2 * len(call.rows))}
