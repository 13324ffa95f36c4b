"""The topological sweep in torch ops over the CPDs' flat primitives.

Counterpart of ``vectorizedbayesiannetwork_tpu/inference/_sweep.py``, the
JAX package's non-Pallas route: per node in topological order, a draw from
the CPD (``_sample_flat``) or the clamped evidence/do value, and for
likelihood weighting the evidence log-likelihood (``_log_prob_flat``)
added to the particle weights. It serves what the fused kernels' gates
refuse, and Monte-Carlo marginalization's direct path. Draws come from the
call's row stream (``core/rng.py::RowStream``): node i of particle p of
row r draws from counter (p, r, i), so a row's draws do not depend on its
batch. Under a mesh (``mesh=``) each rank sweeps its block of rows and
particles on the same counters and the blocks are gathered
(``ops/sweep.py::shard_trace``): every rank returns the unmeshed stream
bit for bit.

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
from ..core.rng import Draw, RowStream
from ..ops.sweep import shard_trace
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
    draw: Draw,
    fixed: torch.Tensor,  # [B, total_dim] packed evidence/do values
    n_samples: int,
    *,
    weighted: bool = False,
    skip: frozenset = frozenset(),
    mesh=None,
    target: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ancestral sweep -> (packed [B, S, total_dim], log_weights [B, S]);
    with ``target`` the first output is that node's values [B, S, d] alone
    (under a mesh each rank then gathers only those).

    ``log_weights`` accumulates evidence log-likelihoods when ``weighted``
    (likelihood weighting); do-interventions clamp without weight.
    ``skip`` nodes stay zero and draw nothing (Rao-Blackwellization skips
    the target and its descendants, which are never parents of a swept
    node). Without ``skip``, a plan that ``stacked_form`` admits takes the
    stacked-table sweep. The draws are ``draw``'s row stream; with
    ``mesh`` the sweep runs sharded over it (``shard_trace``).
    """
    route, form = ("per_node", None) if skip else stacked_form(plan, cpds)
    ROUTES[route] += 1

    def local(stream: RowStream, fixed_l: torch.Tensor):
        if form is not None:
            packed, log_w = form(plan, cpds, params_tuple, stream, fixed_l,
                                 stream.s, weighted=weighted)
        else:
            packed, log_w = _per_node_trace(plan, cpds, params_tuple, stream,
                                            fixed_l, weighted, skip)
        if target is not None:
            packed = node_values(plan, packed, target)
        return packed, log_w

    return shard_trace(mesh, local, draw, n_samples, (fixed,))


def _per_node_trace(plan, cpds, params_tuple, stream: RowStream,
                    fixed: torch.Tensor, weighted: bool, skip: frozenset):
    """``sweep_trace``'s per-node loop over one block of rows and
    particles."""
    b, s = fixed.shape[0], stream.s
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
            v = cpds[idx]._sample_flat(params_tuple[idx], stream.node(idx),
                                       pflat, m)
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
