"""The check of the ``gaussian_nn`` family.

An SGD fit cannot be redone outside the program, as the KDE and table
references redo theirs, and no piece of the harness reaches the fitted
``VBN`` before the pool is served. So the program's fitted CPDs are read
back after the window (``observe``), and the check holds what was served
to three things:

- the moments against plain float64 likelihood weighting
  (``gnn_lw.py``) of those CPDs at ``reference_factor`` times the
  configuration's particles: ``z_rms``, ``z_max``, ``rows_bad``, rows
  where the reference keeps fewer than ``min_reference_ess`` effective
  particles left out (``check.judge_moments``). This judges the
  inference, given the fit;
- the fit against the network that made the data, which the program
  never sees: ``fit_nll_gap``, the largest over nodes of the fitted CPD's
  mean negative log-likelihood on ``fit_check_rows`` fresh rows of that
  network less the true CPD's. ``truth_rms``, the root mean square of
  the served mean's and std's gaps to that network's exact posterior, in
  posterior stds, over the judged rows, is reported and has no limit: a
  sound fit of 2048 rows puts it anywhere from 0.08 to 0.7, where an
  under-fit reads too;
- the served forward against float64 of the same parameters: while the
  program is alive, ``observe`` calls each node's ``_sample_flat`` and
  ``_log_prob_flat``, the primitives the dynamic sweep calls, on
  ``probe_rows`` parent rows of the true network (at most the rows a
  call serves a node). The draw takes its normals from a generator the
  probe seeds, so the reference draws the same normals with
  ``torch.randn`` on a copy of its state, as ``core/rng.py::normals``
  does with a generator. ``sample_gap`` is the largest gap of a draw, in
  the node's ``std_y``; ``log_prob_gap`` of a log-density, in nats.

The control is the same likelihood weighting at ``n_samples /
n_samples_divisor`` particles in the program's place; its forward and fit
numbers are the program's.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from vbnbench import check
from vbnbench.reference import gnn_lw


def _seed(cell, name: str) -> int:
    from vbnbench.run import sub_seed

    return sub_seed(cell.seed, name)


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host(v) for v in tree]
    return tree.detach().cpu().numpy()


def _parents(rows: Dict[str, np.ndarray], ps: List[str]) -> np.ndarray:
    return np.stack([np.asarray(rows[q], np.float32) for q in ps], 1)


def probe_rows(cell) -> int:
    return min(int(cell.limits["probe_rows"]),
               cell.s * int(cell.mix["rows_per_call"]))


def observe(cell, vbn):
    """Node -> its fitted ``net`` and ``stats`` on the host, and for a node
    with parents the probe of its served draw and log-density."""
    m = probe_rows(cell)
    rows = cell.net.sample(m, _seed(cell, "probe"))
    out = {}
    for n in cell.net.nodes:
        params = vbn.params[n]
        out[n] = {"net": _host(params["net"]), "stats": _host(params["stats"])}
        ps = cell.net.parents[n]
        if not ps:
            continue
        cpd = vbn.cpd_spec(n)
        pa = torch.as_tensor(_parents(rows, ps), device=cell.device)
        gen = cell.generator(f"probe.{n}")
        state = gen.get_state()
        x = cpd._sample_flat(params, gen, pa, m)
        lp = cpd._log_prob_flat(params, x, pa)
        out[n]["probe"] = {"parents": pa.cpu().numpy(), "state": state.cpu(),
                           "x": x.reshape(-1).cpu().numpy(),
                           "log_prob": lp.reshape(-1).cpu().numpy()}
    return out


def forward_gaps(observed, nodes, device) -> Tuple[float, float]:
    """(``sample_gap``, ``log_prob_gap``) over the probed nodes."""
    sample_gap = log_prob_gap = 0.0
    for n, obs in observed.items():
        probe = obs.get("probe")
        if probe is None:
            continue
        pa = torch.as_tensor(probe["parents"], device=device)
        m = pa.shape[0]
        gen = torch.Generator(device=device)
        gen.set_state(probe["state"])
        eps = torch.randn((m, 1), generator=gen, device=device,
                          dtype=torch.float32).reshape(-1)
        loc, scale = gnn_lw.loc_scale(nodes[n], pa, m)
        x = torch.as_tensor(probe["x"], device=device).double()
        want = loc + eps.double() * scale
        sample_gap = max(sample_gap, float((x - want).abs().max())
                         / nodes[n].std_y)
        lp = torch.as_tensor(probe["log_prob"], device=device).double()
        log_prob_gap = max(log_prob_gap, float(
            (lp - gnn_lw.log_normal(x, loc, scale)).abs().max()))
    return sample_gap, log_prob_gap


def fit_nll_gap(cell, nodes, device) -> float:
    """The largest over nodes of the fitted CPD's mean NLL on fresh rows
    of the data's network, less the true CPD's."""
    net = cell.net
    rows = net.sample(int(cell.limits["fit_check_rows"]),
                      _seed(cell, "fit_check"))
    worst = -np.inf
    for n in net.nodes:
        x = torch.as_tensor(rows[n], dtype=torch.float64, device=device)
        ps = net.parents[n]
        pa = (torch.as_tensor(_parents(rows, ps), device=device) if ps
              else None)
        loc, scale = gnn_lw.loc_scale(nodes[n], pa, x.shape[0])
        fitted = -gnn_lw.log_normal(x, loc, scale).mean()
        true_loc = net.bias[n] + sum(
            w * torch.as_tensor(rows[p], dtype=torch.float64, device=device)
            for w, p in zip(net.weights[n], ps))
        true = -gnn_lw.log_normal(
            x, true_loc, torch.full_like(x, net.sigma[n])).mean()
        worst = max(worst, float(fitted - true))
    return worst


def exact_posterior(net, target: str, ev: Dict[str, float]):
    """(mean, std) of the data's network's posterior of ``target``."""
    mu, cov = net.system()
    ix = {v: i for i, v in enumerate(net.nodes)}
    t = ix[target]
    if not ev:
        return float(mu[t]), float(np.sqrt(cov[t, t]))
    e = [ix[v] for v in ev]
    k = np.linalg.solve(cov[np.ix_(e, e)], cov[e, t])
    mean = mu[t] + k @ (np.array([ev[v] for v in ev], np.float64) - mu[e])
    return float(mean), float(np.sqrt(max(cov[t, t] - k @ cov[e, t], 1e-300)))


def truth_rms(net, rows, ref: np.ndarray, min_ess: float) -> float:
    """Root mean square over the rows ``check.judge_moments`` judges of
    the served mean's and std's gaps to the exact posterior, in its std."""
    gaps = []
    for (got, target, ev), r in zip(rows, ref):
        if got is None or not np.isfinite(got).all() or r[4] < min_ess:
            continue
        mean, std = exact_posterior(net, target, ev)
        gaps += [(got[0] - mean) / std, (got[1] - std) / std]
    return float(np.sqrt(np.mean(np.square(gaps)))) if gaps else float("inf")


def judge(cell, sampled, observed, device, control: bool = False):
    net = cell.net
    min_scale = float(cell.config["cpd"]["params"]["min_scale"])
    min_ess = float(cell.limits["min_reference_ess"])
    with gnn_lw.no_tf32():
        nodes = {n: gnn_lw.node(o["net"], o["stats"], min_scale, device)
                 for n, o in observed.items()}
        sample_gap, log_prob_gap = forward_gaps(observed, nodes, device)
        fit = fit_nll_gap(cell, nodes, device)
    pairs = [(t, ev) for _got, t, ev in sampled]
    gen = cell.generator("reference")
    s_ref = cell.s * int(cell.limits["reference_factor"])
    ref = gnn_lw.lw_moments(net.nodes, net.parents, nodes, pairs, s_ref, gen,
                            device)
    fixed = {"fit_nll_gap": fit, "sample_gap": sample_gap,
             "log_prob_gap": log_prob_gap}
    out = {"numbers": dict(check.judge_moments(ref, s_ref, sampled, cell.s,
                                               min_ess),
                           truth_rms=truth_rms(net, sampled, ref, min_ess),
                           **fixed),
           "reference_min_ess": float(ref[:, 4].min())}
    if control:
        ctl = gnn_lw.lw_moments(net.nodes, net.parents, nodes, pairs,
                                cell.s_control, gen, device)
        rows = [(r[:2], t, ev) for r, (t, ev) in zip(ctl, pairs)]
        out["control"] = dict(check.judge_moments(ref, s_ref, rows, cell.s,
                                                  min_ess),
                              truth_rms=truth_rms(net, rows, ref, min_ess),
                              **fixed)
    return out
