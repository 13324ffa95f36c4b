"""The check of the ``categorical_table`` family: CPTs refitted from the
benchmark's rows (``fit.py``), each sampled row answered exactly by
variable elimination with likelihood weighting's variance beside it
(``ve.py``). The control is plain likelihood weighting (``cat_lw.py``)
at ``n_samples / n_samples_divisor`` particles in the program's place.
"""

from __future__ import annotations

from vbnbench import check
from vbnbench.reference.cat_lw import lw_pmf
from vbnbench.reference.fit import categorical_cpts
from vbnbench.reference.ve import Exact


def judge(cell, sampled, observed, device, control: bool = False):
    net = cell.net
    p = cell.config["cpd"]["params"]
    cpts = categorical_cpts(net.nodes, net.parents, net.cards, cell.data,
                            alpha=p["alpha"], alpha_mode=p["alpha_mode"],
                            prior=p["prior"])
    exact = Exact(net.nodes, net.parents, net.cards, cpts)
    out = {"numbers": check.judge_pmf(exact, net.cards, sampled, cell.s)}
    if control:
        pairs = [(t, ev) for _got, t, ev in sampled]
        rows = lw_pmf(net.nodes, net.parents, net.cards, cpts, pairs,
                      cell.s_control, cell.generator("reference"), device)
        out["control"] = check.judge_pmf(
            exact, net.cards, [(r, t, ev) for r, (t, ev) in zip(rows, pairs)],
            cell.s)
    return out
