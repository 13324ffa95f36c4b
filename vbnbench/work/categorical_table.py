"""The work of likelihood weighting over categorical tables.

Counted per particle and row, every integer, float and special-function
instruction as one operation, as the port's kernel table counts the
function (``chip_smoke.py::cat_cost``, recounted here without its
design's terms):

- a latent node: one 32-bit random word (a quarter of a Philox-4x32-10
  call, 25, and the uniform, 3), the parent row (2 a parent), the row's
  class total (c - 1), the threshold (1) and the inverse-CDF walk
  (3 (c - 1));
- an evidence node: the parent row, the class total, the probability's
  division and floor (3, 1 more op) and its log (1 special function)
  added to the weight;
- the reduction: the weight's shift (2) and exp (1 special function) and
  one add into the target's class (2).

Dropped against ``cat_cost``: the block partials the sweep kernel writes
(a design's choice) and its packed plan metadata; a reduction into K
classes counts one add, the function's, not the kernel's K.
Bytes: each input read once (the evidence values and target of each row,
every CPT entry), each output written once (the pmf rows, 4 bytes a
class).
"""

from __future__ import annotations

from typing import Dict


def count(net, call, s: int) -> Dict[str, float]:
    ops = 0.0
    sfu = 0.0
    kmax = call.kwargs.get("n_classes", max(net.cards.values()))
    for _target, evidence in call.rows:
        per = 0
        per_sfu = 0
        for n in net.nodes:
            c, npar = net.card(n), len(net.parents[n])
            per += 2 * npar + (c - 1)
            if n in evidence:
                per += 4
                per_sfu += 1
            else:
                per += 28 + 1 + 3 * (c - 1)
        per += 4
        per_sfu += 1
        ops += per * s
        sfu += per_sfu * s
    table = sum(int(net.cpts[n].size) for n in net.nodes)
    inputs = sum(len(ev) + 1 for _t, ev in call.rows) + table
    return {"ops": ops, "sfu": sfu, "tc": 0.0,
            "bytes": 4.0 * (inputs + len(call.rows) * kmax)}
