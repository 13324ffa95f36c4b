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

As in the JAX package, the loop walks the plan's topological levels and
evaluates the same-signature nodes of a level as one ``torch.func.vmap``-ed
call over their stacked params (``VBN_LEVEL_GROUP=never`` turns it off;
``GROUPS`` counts the grouped calls). A group's draws are made ahead, one
``vbn_uniforms`` launch a draw for all its nodes, so a node draws the same
values grouped or not.

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
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..core.plan import InferencePlan
from ..core.rng import Draw, RowStream
from ..ops.sweep import shard_trace
from ..utils.profiling import annotate, counter
from ._discrete_sweep import discrete_sweep_supported, discrete_sweep_trace
from ._gaussian_sweep import gaussian_sweep_supported, gaussian_sweep_trace

_SCAN_THRESHOLD = 64  # nodes, the JAX package's threshold
ROUTES: Counter = counter("ROUTES")  # "discrete" / "gaussian" / "per_node" sweeps
# the level-grouped per-node sweep: "sample_calls" / "log_prob_calls"
# vmapped group calls and "sample_nodes" / "log_prob_nodes" the nodes in
# them; "per_node" nodes of a same-signature group that ran one by one
# while grouping was on (an opt-out or a failed stack)
GROUPS: Counter = counter("GROUPS")


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
    gather: bool = True,
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
    ``mesh`` the sweep runs sharded over it (``shard_trace``; with
    ``gather=False`` a sharded sweep returns this rank's blocks).
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

    with annotate(f"vbn.sweep.{route}"):
        return shard_trace(mesh, local, draw, n_samples, (fixed,), gather)


def _use_level_grouping() -> bool:
    """``VBN_LEVEL_GROUP``: ``never`` walks node by node, anything else
    (``auto`` when unset) groups, as in the JAX package."""
    return os.environ.get("VBN_LEVEL_GROUP", "auto").lower() != "never"


def _group_sig(cpd) -> tuple:
    """Nodes stack when class, dims and static config all match."""
    return (type(cpd), cpd.input_dim, cpd.output_dim, cpd._static_fields())


def _stack_eval_params(cpds, params_tuple, idxs):
    """The eval params of ``idxs`` stacked leaf by leaf on a new axis 0, or
    None when the tree structures, the leaves' shapes, dtypes or devices
    differ (KDE nodes holding different numbers of support points), or a
    leaf is not a tensor: the caller then runs the nodes one by one."""
    flat = [tree_flatten(cpds[i]._eval_params(params_tuple[i])) for i in idxs]
    spec0 = flat[0][1]
    if any(spec != spec0 for _, spec in flat[1:]):
        return None
    columns = list(zip(*[leaves for leaves, _ in flat]))
    for col in columns:
        if not all(isinstance(a, torch.Tensor) for a in col) or any(
                a.shape != col[0].shape or a.dtype != col[0].dtype
                or a.device != col[0].device for a in col[1:]):
            return None
    return tree_unflatten([torch.stack(col) for col in columns], spec0)


def _stacked_group(cpds, params_tuple, g, grouping, *, sample):
    """The stacked params of group ``g``, or None: it then runs node by
    node (grouping off, one node, a family that opts out, a stack that
    fails; ``GROUPS["per_node"]`` counts the nodes of groups that fell
    back while grouping was on)."""
    if not grouping or len(g) < 2:
        return None
    cpd0 = cpds[g[0]]
    stacked = None
    if cpd0._vmappable() and (not sample or (
            cpd0.sample_groupable and cpd0._draws() is not None)):
        stacked = _stack_eval_params(cpds, params_tuple, g)
    if stacked is None:
        GROUPS["per_node"] += len(g)
    return stacked


def level_groups(plan: InferencePlan, cpds: Sequence, weighted: bool,
                 skip: frozenset = frozenset()):
    """Per topological level ``(level, latent, evidence)``: the level's
    drawn nodes and (when ``weighted``) its evidence nodes, each split into
    groups of one ``_group_sig`` in order of first appearance, as the JAX
    package's sweep groups them. ``skip`` and do nodes join no group."""
    for level in plan.levels:
        latent: dict = {}
        evidence: dict = {}
        for idx in level:
            if idx in skip:
                continue
            if not plan.is_fixed(idx):
                latent.setdefault(_group_sig(cpds[idx]), []).append(idx)
            elif weighted and plan.evidence_mask[idx]:
                evidence.setdefault(_group_sig(cpds[idx]), []).append(idx)
        yield level, list(latent.values()), list(evidence.values())


def _per_node_trace(plan, cpds, params_tuple, stream: RowStream,
                    fixed: torch.Tensor, weighted: bool, skip: frozenset):
    """``sweep_trace``'s loop over one block of rows and particles, level
    by level (``plan.levels``). Within a level, the latent nodes of one
    signature (``_group_sig``) draw as one ``torch.func.vmap``-ed
    ``_sample_flat`` over their stacked params and ``[G, m, Din]``
    parents, their draws made ahead (``RowStream.predraw``: one
    ``vbn_uniforms`` launch a draw for the whole group, each node on its
    own counters, so a grouped node draws its ungrouped values bit for
    bit); when weighted, the evidence nodes of one signature score as one
    vmapped ``_log_prob_flat``. ``VBN_LEVEL_GROUP=never`` walks node by
    node."""
    b, s = fixed.shape[0], stream.s
    m = b * s
    vals: List[Optional[torch.Tensor]] = [None] * plan.n_nodes
    log_w = torch.zeros((b, s), dtype=torch.float32, device=fixed.device)
    grouping = _use_level_grouping()
    for level, latent, evidence in level_groups(plan, cpds, weighted, skip):
        for idx in level:
            d = plan.node_dims[idx]
            off = plan.node_offsets[idx]
            if idx in skip:
                vals[idx] = fixed.new_zeros((b, s, d))
            elif plan.is_fixed(idx):
                vals[idx] = fixed[:, None, off : off + d].expand(b, s, d)

        for g in latent:
            stacked = _stacked_group(cpds, params_tuple, g, grouping,
                                     sample=True)
            if stacked is None:
                for idx in g:
                    v = cpds[idx]._sample_flat(
                        params_tuple[idx], stream.node(idx),
                        _parents_flat(plan, vals, idx, m), m)
                    vals[idx] = v.reshape(b, s, plan.node_dims[idx])
                continue
            cpd0 = cpds[g[0]]
            drawn = stream.predraw(g, cpd0._draws())
            if cpd0.input_dim > 0:
                pstack = torch.stack([_parents_flat(plan, vals, i, m)
                                      for i in g])
                vstack = torch.func.vmap(
                    lambda p, src, pf: cpd0._sample_flat(p, src, pf, m))(
                        stacked, drawn, pstack)
            else:
                vstack = torch.func.vmap(
                    lambda p, src: cpd0._sample_flat(p, src, None, m))(
                        stacked, drawn)
            GROUPS["sample_calls"] += 1
            GROUPS["sample_nodes"] += len(g)
            for j, idx in enumerate(g):
                vals[idx] = vstack[j].reshape(b, s, plan.node_dims[idx])

        for g in evidence:
            stacked = _stacked_group(cpds, params_tuple, g, grouping,
                                     sample=False)
            if stacked is None:
                for idx in g:
                    lp = cpds[idx]._log_prob_flat(
                        params_tuple[idx],
                        vals[idx].reshape(m, plan.node_dims[idx]),
                        _parents_flat(plan, vals, idx, m))
                    log_w = log_w + lp.reshape(b, s)
                continue
            cpd0 = cpds[g[0]]
            xstack = torch.stack([vals[i].reshape(m, plan.node_dims[i])
                                  for i in g])
            if cpd0.input_dim > 0:
                pstack = torch.stack([_parents_flat(plan, vals, i, m)
                                      for i in g])
                lp = torch.func.vmap(cpd0._log_prob_flat)(stacked, xstack,
                                                          pstack)
            else:
                lp = torch.func.vmap(
                    lambda p, x: cpd0._log_prob_flat(p, x, None))(stacked,
                                                                  xstack)
            GROUPS["log_prob_calls"] += 1
            GROUPS["log_prob_nodes"] += len(g)
            log_w = log_w + lp.sum(dim=0).reshape(b, s)
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
