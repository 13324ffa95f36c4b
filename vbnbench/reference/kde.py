"""The check of the ``kde`` family: plain likelihood weighting of the KDE
network fitted again from the benchmark's rows (``kde_lw.py``, Scott
bandwidths from ``fit.py``), at ``reference_factor`` times the
configuration's particles, errors scaled to its S.

The configuration fits at most ``max_points`` rows, so the fit keeps
every row and the reference needs nothing the program drew. What the
program kept is judged apart (``support_bad``): the kept points of every
node against the benchmark's rows as multisets, the count of data rows
not kept plus kept points that are not rows of the data (limit 0).
Rows where the reference keeps fewer than ``min_reference_ess`` effective
particles are left out of the gaps (``check.judge_moments``). The control
is the same likelihood weighting at ``n_samples / n_samples_divisor``
particles in the program's place.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from vbnbench import check
from vbnbench.reference.fit import scott_bandwidths
from vbnbench.reference.kde_lw import KdeNode, lw_moments


def observe(cell, vbn):
    """The program's kept points: node -> (parents [m, dp], values [m, 1],
    valid [m]), on the host."""
    return {n: tuple(vbn.params[n][k].cpu().numpy()
                     for k in ("data_p", "data_x", "valid"))
            for n in cell.net.nodes}


def _columns(cell, n):
    x = np.asarray(cell.data[n], np.float32)
    ps = cell.net.parents[n]
    p = (np.stack([np.asarray(cell.data[q], np.float32) for q in ps], 1)
         if ps else np.zeros((len(x), 0), np.float32))
    return p, x


def support_bad(cell, observed) -> int:
    """Data rows the fit did not keep plus kept points that are not rows
    of the data, over all nodes; float32 data can hold equal rows, so
    both are multisets."""
    bad = 0
    for n in cell.net.nodes:
        p, x = _columns(cell, n)
        data = Counter(map(tuple, np.concatenate([p, x[:, None]], 1).tolist()))
        dp, dx, valid = observed[n]
        kept = Counter(map(tuple, np.concatenate(
            [dp, dx.reshape(len(dx), -1)], 1)[valid > 0].tolist()))
        bad += sum(((data - kept) + (kept - data)).values())
    return bad


def nodes(cell, device):
    params = cell.config["cpd"]["params"]
    m = int(params["max_points"])
    if int(cell.config["fit_rows"]) > m:
        raise ValueError("the KDE reference refits every row: fit_rows must "
                         "not exceed max_points")
    min_scale = float(params["min_scale"])
    out = {}
    for n in cell.net.nodes:
        p, x = _columns(cell, n)
        bw, pbw = scott_bandwidths(x[:, None], p, m)
        out[n] = KdeNode(data_p=torch.as_tensor(p, device=device),
                         data_x=torch.as_tensor(x, device=device),
                         y_scale=max(bw, 1e-3) + min_scale,
                         p_scale=max(pbw, 1e-3) + min_scale)
    return out


def judge(cell, sampled, observed, device, control: bool = False):
    net = cell.net
    pairs = [(t, ev) for _got, t, ev in sampled]
    gen = cell.generator("reference")
    kde = nodes(cell, device)
    s_ref = cell.s * int(cell.limits["reference_factor"])
    ref = lw_moments(net.nodes, net.parents, kde, pairs, s_ref, gen, device)
    bad = support_bad(cell, observed)
    min_ess = float(cell.limits["min_reference_ess"])
    out = {"numbers": dict(check.judge_moments(ref, s_ref, sampled, cell.s,
                                               min_ess), support_bad=bad),
           "reference_min_ess": float(ref[:, 4].min())}
    if control:
        ctl = lw_moments(net.nodes, net.parents, kde, pairs, cell.s_control,
                         gen, device)
        out["control"] = dict(check.judge_moments(
            ref, s_ref, [(r[:2], t, ev) for r, (t, ev) in zip(ctl, pairs)],
            cell.s, min_ess), support_bad=bad)
    return out
