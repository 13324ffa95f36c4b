"""Mask-dynamic ancestral sweep in torch ops.

Counterpart of ``vectorizedbayesiannetwork_tpu/inference/_dynamic_sweep.py``:
the query's structure is data per row. ``ev_mask``/``do_mask`` are
``[B, n_nodes]``; every node draws its conditional sample AND evaluates its
log-density at the final (drawn-or-clamped) value, then selects by mask, so
one function serves every evidence pattern and a batch may mix query
skeletons. It serves the plans the scan kernels' gates refuse (mixed CPD
families, more than 1500 nodes). Draws come from the call's
``torch.Generator``, node by node in topological order, whatever the masks.

The JAX package takes its ``lax.scan`` forms (``_discrete_sweep.py``,
``_gaussian_sweep.py``) from 64 nodes up; those are not ported yet
(ROADMAP), and this per-node loop serves such plans meanwhile.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..core.plan import InferencePlan
from ._sweep import _parents_flat


def dynamic_sweep_trace(
    plan: InferencePlan,
    cpds: Sequence,
    params_tuple: Tuple,
    gen: torch.Generator,
    fixed: torch.Tensor,  # [B, total_dim] packed evidence/do values
    ev_mask: torch.Tensor,  # [B, n_nodes] (1 = evidence: clamp + weight)
    do_mask: torch.Tensor,  # [B, n_nodes] (1 = do: clamp, no weight)
    n_samples: int,
    *,
    tgt_mask: Optional[torch.Tensor] = None,  # [B, n_nodes] one-hot target
):
    """Returns ``(packed [B, S, total_dim], log_weights [B, S])``, and with
    ``tgt_mask`` a third output: each row's target log-density at its final
    value, [B, S] (what Monte-Carlo marginalization exponentiates)."""
    b, s = fixed.shape[0], n_samples
    m = b * s
    vals: List[Optional[torch.Tensor]] = [None] * plan.n_nodes
    log_w = torch.zeros((b, s), dtype=torch.float32, device=fixed.device)
    lp_tgt = torch.zeros((b, s), dtype=torch.float32, device=fixed.device)
    for idx in range(plan.n_nodes):
        d = plan.node_dims[idx]
        off = plan.node_offsets[idx]
        pflat = _parents_flat(plan, vals, idx, m)
        sampled = cpds[idx]._sample_flat(params_tuple[idx], gen, pflat, m)
        fixed_b = fixed[:, None, off : off + d].expand(b, s, d)
        m_fix = torch.maximum(ev_mask[:, idx], do_mask[:, idx])  # [B]
        v = torch.where(m_fix[:, None, None] > 0, fixed_b,
                        sampled.reshape(b, s, d))
        vals[idx] = v
        lp = cpds[idx]._log_prob_flat(
            params_tuple[idx], v.reshape(m, d), pflat
        ).reshape(b, s)
        # where, not multiply: 0 * (-inf) would poison the weights
        log_w = log_w + torch.where(ev_mask[:, idx][:, None] > 0, lp, 0.0)
        if tgt_mask is not None:
            lp_tgt = lp_tgt + torch.where(tgt_mask[:, idx][:, None] > 0, lp, 0.0)
    packed = torch.cat(vals, dim=-1)
    if tgt_mask is not None:
        return packed, log_w, lp_tgt
    return packed, log_w


def dynamic_target_values(
    plan: InferencePlan, packed: torch.Tensor, target_idx: torch.Tensor
) -> torch.Tensor:
    """packed [B, S, total] -> each row's target block, [B, S, max_dim];
    ``target_idx`` is per row [B]. Columns past a row's target dim are 0
    (the caller slices them off), as the JAX one-hot contraction gives."""
    dev = packed.device
    offs = torch.tensor(plan.node_offsets, dtype=torch.int64, device=dev)
    dims = torch.tensor(plan.node_dims, dtype=torch.int64, device=dev)
    ti = target_idx.long()
    max_d = int(max(plan.node_dims))
    cols = offs[ti][:, None] + torch.arange(max_d, device=dev)[None]  # [B, M]
    keep = torch.arange(max_d, device=dev)[None] < dims[ti][:, None]
    cols = torch.clamp(cols, max=plan.total_dim - 1)
    b, s = packed.shape[:2]
    got = packed.gather(2, cols[:, None, :].expand(b, s, max_d))
    return torch.where(keep[:, None, :], got, 0.0)
