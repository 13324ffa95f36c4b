"""The topological sweep in torch ops over the CPDs' flat primitives.

Counterpart of ``vectorizedbayesiannetwork_tpu/inference/_sweep.py``, the
JAX package's non-Pallas route: per node in topological order, a draw from
the CPD (``_sample_flat``) or the clamped evidence/do value, and for
likelihood weighting the evidence log-likelihood (``_log_prob_flat``)
added to the particle weights. It serves what the fused kernels' gates
refuse, and Monte-Carlo marginalization's direct path. Draws come from the
call's ``torch.Generator``, node by node in topological order.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..core.plan import InferencePlan


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ancestral sweep -> (packed [B, S, total_dim], log_weights [B, S]).

    ``log_weights`` accumulates evidence log-likelihoods when ``weighted``
    (likelihood weighting); do-interventions clamp without weight.
    """
    b, s = fixed.shape[0], n_samples
    m = b * s
    vals: List[Optional[torch.Tensor]] = [None] * plan.n_nodes
    log_w = torch.zeros((b, s), dtype=torch.float32, device=fixed.device)
    for idx in range(plan.n_nodes):
        d = plan.node_dims[idx]
        off = plan.node_offsets[idx]
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
    pidx = plan.parent_idx[t]
    pflat = (
        torch.cat([node_values(plan, packed, p) for p in pidx], dim=-1)
        .reshape(b * s, -1)
        if pidx
        else None
    )
    return cpds[t]._log_prob_flat(params_tuple[t], x, pflat).reshape(b, s)
