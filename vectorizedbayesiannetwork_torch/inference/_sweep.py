"""The topological sweep in torch ops over the CPDs' flat primitives.

Counterpart of ``vectorizedbayesiannetwork_tpu/inference/_sweep.py``, the
JAX package's non-Pallas route: per node in topological order, a draw from
the CPD (``_sample_flat``) or the clamped evidence/do value, and for
likelihood weighting the evidence log-likelihood (``_log_prob_flat``)
added to the particle weights. It serves what the fused kernels' gates
refuse, and Monte-Carlo marginalization's direct path. Draws come from the
call's ``torch.Generator``, node by node in topological order.

As in the JAX package, a plan of 64 nodes or more that is all
categorical (declared supports) or all linear-Gaussian takes the
stacked-table form instead (``_discrete_sweep.py``, ``_gaussian_sweep.py``:
one loop step a node on stacked tables, a few [B, S] ops each);
``VBN_DISCRETE_SCAN=always|never`` overrides the node count. The hand
kernels keep their precedence: the methods call these sweeps only for
plans the kernels' gates refuse. ``ROUTES`` counts the route each sweep
took.
"""

from __future__ import annotations

import os
from collections import Counter
from typing import List, Optional, Sequence, Tuple

import torch

from ..core.plan import InferencePlan
from ._discrete_sweep import discrete_sweep_supported, discrete_sweep_trace
from ._gaussian_sweep import gaussian_sweep_supported, gaussian_sweep_trace

_SCAN_THRESHOLD = 64  # nodes, the JAX package's threshold
ROUTES: Counter = Counter()  # "discrete" / "gaussian" / "per_node" sweeps


def _use_discrete_scan(n_nodes: int) -> bool:
    mode = os.environ.get("VBN_DISCRETE_SCAN", "auto").lower()
    if mode == "always":
        return True
    if mode == "never":
        return False
    return n_nodes >= _SCAN_THRESHOLD


def stacked_form(plan: InferencePlan, cpds: Sequence):
    """``(route, sweep)``: ``("discrete", discrete_sweep_trace)``, else
    ``("gaussian", gaussian_sweep_trace)``, when ``_use_discrete_scan``
    admits the node count and the plan's CPDs fit the form, else
    ``("per_node", None)``."""
    if _use_discrete_scan(plan.n_nodes):
        if discrete_sweep_supported(plan, cpds):
            return "discrete", discrete_sweep_trace
        if gaussian_sweep_supported(plan, cpds):
            return "gaussian", gaussian_sweep_trace
    return "per_node", None


def _parents_flat(plan, vals, idx, m) -> Optional[torch.Tensor]:
    pidx = plan.parent_idx[idx]
    if not pidx:
        return None
    return torch.cat([vals[p] for p in pidx], dim=-1).reshape(m, -1)


def sweep_trace(
    plan: InferencePlan,
    cpds: Sequence,
    params_tuple: Tuple,
    gen: torch.Generator,
    fixed: torch.Tensor,  # [B, total_dim] packed evidence/do values
    n_samples: int,
    *,
    weighted: bool = False,
    skip: frozenset = frozenset(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ancestral sweep -> (packed [B, S, total_dim], log_weights [B, S]).

    ``log_weights`` accumulates evidence log-likelihoods when ``weighted``
    (likelihood weighting); do-interventions clamp without weight.
    ``skip`` nodes stay zero and draw nothing from the generator
    (Rao-Blackwellization skips the target and its descendants, which are
    never parents of a swept node). Without ``skip``, a plan that
    ``stacked_form`` admits takes the stacked-table sweep.
    """
    route, form = ("per_node", None) if skip else stacked_form(plan, cpds)
    ROUTES[route] += 1
    if form is not None:
        return form(plan, cpds, params_tuple, gen, fixed, n_samples,
                    weighted=weighted)
    b, s = fixed.shape[0], n_samples
    m = b * s
    vals: List[Optional[torch.Tensor]] = [None] * plan.n_nodes
    log_w = torch.zeros((b, s), dtype=torch.float32, device=fixed.device)
    for idx in range(plan.n_nodes):
        d = plan.node_dims[idx]
        off = plan.node_offsets[idx]
        if idx in skip:
            vals[idx] = fixed.new_zeros((b, s, d))
            continue
        pflat = _parents_flat(plan, vals, idx, m)
        if plan.is_fixed(idx):
            vals[idx] = fixed[:, None, off : off + d].expand(b, s, d)
            if weighted and plan.evidence_mask[idx]:
                lp = cpds[idx]._log_prob_flat(
                    params_tuple[idx], vals[idx].reshape(m, d), pflat
                )
                log_w = log_w + lp.reshape(b, s)
        else:
            v = cpds[idx]._sample_flat(params_tuple[idx], gen, pflat, m)
            vals[idx] = v.reshape(b, s, d)
    return torch.cat(vals, dim=-1), log_w


def target_parents_flat(
    plan: InferencePlan, packed: torch.Tensor, idx: int
) -> Optional[torch.Tensor]:
    """Node ``idx``'s parents [B*S, Din] from the packed sweep, or None."""
    pidx = plan.parent_idx[idx]
    if not pidx:
        return None
    b, s, _ = packed.shape
    return torch.cat([node_values(plan, packed, p) for p in pidx],
                     dim=-1).reshape(b * s, -1)


def node_values(plan: InferencePlan, packed: torch.Tensor, idx: int):
    off = plan.node_offsets[idx]
    return packed[..., off : off + plan.node_dims[idx]]


def target_log_prob(
    plan: InferencePlan, cpds: Sequence, params_tuple: Tuple, packed
) -> torch.Tensor:
    """log p(target_value | parents) over the packed sweep -> [B, S]."""
    t = plan.target_idx
    b, s, _ = packed.shape
    x = node_values(plan, packed, t).reshape(b * s, plan.node_dims[t])
    pflat = target_parents_flat(plan, packed, t)
    return cpds[t]._log_prob_flat(params_tuple[t], x, pflat).reshape(b, s)
