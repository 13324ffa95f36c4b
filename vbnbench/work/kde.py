"""The work of likelihood weighting over KDE CPDs.

Counted per particle and row as the port's kernel table counts the KDE
functions (``chip_smoke.py::kde_cost``), for a node of n support points,
dp parent features and one value:

- a latent root: a uniform support index (28 + 1), a normal (two random
  words, 56, and Box-Muller: 3 special functions, 3 operations) and the
  value (2);
- a latent node with parents: the pick, one draw from the parent-softmax
  categorical over all n points (per point 2 dp + 6 operations and 1
  exp; a uniform, 28), the normal and the value as a root's;
- an evidence root: its log-density over the n points (per point a
  multiply-add of the value, 2 tensor-core flops, 4 operations and 1
  exp; then 1 log);
- an evidence node with parents: the conditional log-density (per point
  2 (1 + dp) tensor-core flops, 8 operations and 2 exps; then 2 logs);
- the reduction: the weight's shift and exp (2, 1) and the moments (5).

Bytes: each input read once (every node's support points, the rows'
evidence values and targets), each output written once (mean, std).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict


def network(cell):
    """What ``count`` reads: the network's nodes and parents, and the
    support points a node holds, the fit's rows up to ``max_points``."""
    n = min(int(cell.config["fit_rows"]),
            int(cell.config["cpd"]["params"]["max_points"]))
    return SimpleNamespace(nodes=cell.net.nodes, parents=cell.net.parents,
                           support={v: n for v in cell.net.nodes})


def count(net, call, s: int) -> Dict[str, float]:
    """``net``: an object with ``nodes``, ``parents`` and ``support``
    (node -> number of support points)."""
    ops = sfu = tc = 0.0
    normal_ops, normal_sfu = 56 + 3, 3
    for _target, evidence in call.rows:
        for node in net.nodes:
            n, dp = net.support[node], len(net.parents[node])
            if node in evidence:
                if dp == 0:
                    tc += 2 * n * s
                    ops += 4 * n * s
                    sfu += (n + 1) * s
                else:
                    tc += 2 * (1 + dp) * n * s
                    ops += 8 * n * s
                    sfu += (2 * n + 2) * s
            else:
                ops += (29 + normal_ops + 2) * s
                sfu += normal_sfu * s
                if dp:
                    ops += (2 * dp + 6) * n * s
                    sfu += n * s
        ops += 7 * s
        sfu += s
    points = sum(net.support[v] * (len(net.parents[v]) + 2) for v in net.nodes)
    inputs = sum(len(ev) + 1 for _t, ev in call.rows) + points
    return {"ops": ops, "sfu": sfu, "tc": tc,
            "bytes": 4.0 * (inputs + 2 * len(call.rows))}
