"""Mask-dynamic ancestral sweep in torch ops.

Counterpart of ``vectorizedbayesiannetwork_tpu/inference/_dynamic_sweep.py``:
the query's structure is data per row. ``ev_mask``/``do_mask`` are
``[B, n_nodes]``; every node draws its conditional sample AND evaluates its
log-density at the final (drawn-or-clamped) value, then selects by mask, so
one function serves every evidence pattern and a batch may mix query
skeletons; a family that ``takes_read_flag`` (KDE) skips the rows the
selection drops. It serves the plans the scan kernels' gates refuse (mixed CPD
families, more than 1500 nodes). Draws come from the call's row stream
(``core/rng.py::RowStream``, counter (particle, row, node)), whatever the
masks; under a mesh (``mesh=``) each rank sweeps its block and the blocks
are gathered (``ops/sweep.py::shard_trace``).

The loop keeps its values in one node-major store, ``planes``
[total_dim, B, S]: each node writes its final value into its own planes,
and no concatenation of the nodes' values runs. With ``targets`` the sweep
returns only each row's target block, gathered from the row's own planes
(``dynamic_target_values``); without, one copy lays the store out as
``packed`` [B, S, total_dim]. ``SWEEPS`` counts which of the two a
per-node sweep gave.

As in the JAX package, a plan of 64 nodes or more that is all categorical
or all linear-Gaussian takes the stacked-table form
(``_sweep.stacked_form``: ``_discrete_sweep.py``, ``_gaussian_sweep.py``)
with the masks as per-row inputs; every other plan takes the per-node
loop below.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import torch

from ..core.plan import InferencePlan
from ..core.rng import Draw, RowStream
from ..ops.kde_fused import ReadFlag
from ..ops.sweep import shard_trace
from ..utils.profiling import annotate, counter, wait
from ._sweep import ROUTES, _parents_flat, stacked_form

SWEEPS = counter("SWEEPS", ("target_planes", "packed"))


def dynamic_sweep_trace(
    plan: InferencePlan,
    cpds: Sequence,
    params_tuple: Tuple,
    draw: Draw,
    fixed: torch.Tensor,  # [B, total_dim] packed evidence/do values
    ev_mask: torch.Tensor,  # [B, n_nodes] (1 = evidence: clamp + weight)
    do_mask: torch.Tensor,  # [B, n_nodes] (1 = do: clamp, no weight)
    n_samples: int,
    *,
    tgt_mask: Optional[torch.Tensor] = None,  # [B, n_nodes] one-hot target
    mesh=None,
    targets: Optional[torch.Tensor] = None,  # [B] each row's target node
):
    """Returns ``(packed [B, S, total_dim], log_weights [B, S])``, and with
    ``tgt_mask`` a third output: each row's target log-density at its final
    value, [B, S] (what Monte-Carlo marginalization exponentiates). With
    ``targets`` the first output is each row's target block [B, S, max_dim]
    (``dynamic_target_values``; under a mesh each rank then gathers only
    those). The draws are ``draw``'s row stream, sharded over ``mesh`` when
    given."""
    route, form = stacked_form(plan, cpds)
    ROUTES[route] += 1

    def local(stream: RowStream, fixed_l, ev_l, do_l, ti_l=None, tgt_l=None):
        if form is None:
            return _per_node_trace(plan, cpds, params_tuple, stream, fixed_l,
                                   ev_l, do_l, tgt_l, ti_l)
        out = form(plan, cpds, params_tuple, stream, fixed_l, stream.s,
                   weighted=True, ev_mask_arr=ev_l,
                   fx_mask_arr=torch.maximum(ev_l, do_l), tgt_mask_arr=tgt_l)
        if ti_l is None:
            return out
        return (dynamic_target_values(plan, out[0].permute(2, 0, 1), ti_l),
                ) + tuple(out[1:])

    with annotate(f"vbn.sweep.{route}"):
        return shard_trace(mesh, local, draw, n_samples,
                           (fixed, ev_mask, do_mask, targets, tgt_mask))


def _per_node_trace(plan, cpds, params_tuple, stream: RowStream, fixed,
                    ev_mask, do_mask, tgt_mask, targets=None):
    """``dynamic_sweep_trace``'s per-node loop over one block of rows and
    particles. Node ``idx`` writes its final value into its planes of the
    store, ``planes[off : off + d]``, and its parents read those planes as
    [B, S, d] views. A CPD that ``takes_read_flag`` is told which rows the
    loop reads: its pick on the free rows (neither evidence nor do), its
    log-density on the evidence rows (and the target rows with
    ``tgt_mask``), each a column of a [B, n_nodes] mask read in place."""
    b, s = fixed.shape[0], stream.s
    m = b * s
    planes = torch.empty((plan.total_dim, b, s), dtype=torch.float32,
                         device=fixed.device)
    vals: List[Optional[torch.Tensor]] = [None] * plan.n_nodes
    log_w = torch.zeros((b, s), dtype=torch.float32, device=fixed.device)
    lp_tgt = torch.zeros((b, s), dtype=torch.float32, device=fixed.device)
    fix = torch.maximum(ev_mask, do_mask)  # [B, n_nodes]: clamped
    if any(c.takes_read_flag for c in cpds):
        free = 1.0 - fix
        scored = (ev_mask if tgt_mask is None
                  else torch.maximum(ev_mask, tgt_mask))
    for idx in range(plan.n_nodes):
        d = plan.node_dims[idx]
        off = plan.node_offsets[idx]
        pflat = _parents_flat(plan, vals, idx, m)
        pick_kw, lp_kw = {}, {}
        if cpds[idx].takes_read_flag:
            pick_kw = {"read": ReadFlag(free[:, idx], s)}
            lp_kw = {"read": ReadFlag(scored[:, idx], s)}
        sampled = cpds[idx]._sample_flat(params_tuple[idx], stream.node(idx),
                                         pflat, m, **pick_kw)
        fixed_b = fixed[:, None, off : off + d].expand(b, s, d)
        m_fix = fix[:, idx]  # [B]
        v = planes[off : off + d].permute(1, 2, 0)  # [B, S, d]
        torch.where(m_fix[:, None, None] > 0, fixed_b,
                    sampled.reshape(b, s, d), out=v)
        vals[idx] = v
        lp = cpds[idx]._log_prob_flat(
            params_tuple[idx], v.reshape(m, d), pflat, **lp_kw
        ).reshape(b, s)
        # where, not multiply: 0 * (-inf) would poison the weights
        log_w = log_w + torch.where(ev_mask[:, idx][:, None] > 0, lp, 0.0)
        if tgt_mask is not None:
            lp_tgt = lp_tgt + torch.where(tgt_mask[:, idx][:, None] > 0, lp, 0.0)
    if targets is None:
        SWEEPS["packed"] += 1
        first = planes.movedim(0, -1).contiguous()  # [B, S, total_dim]
    else:
        SWEEPS["target_planes"] += 1
        first = dynamic_target_values(plan, planes, targets)
    if tgt_mask is not None:
        return first, log_w, lp_tgt
    return first, log_w


@functools.lru_cache(maxsize=64)
def _plane_table(offsets, dims, device: torch.device) -> torch.Tensor:
    """[2, n_nodes] int64 on ``device``: each node's first plane and its
    dim, uploaded once a layout and device."""
    wait(device)
    return torch.tensor([offsets, dims], dtype=torch.int64, device=device)


def dynamic_target_values(
    plan: InferencePlan, planes: torch.Tensor, target_idx: torch.Tensor
) -> torch.Tensor:
    """Node-major planes [total, B, S] -> each row's target block, [B, S,
    max_dim]: row b reads planes ``offs[t_b] + j``, ``target_idx`` [B]
    giving t_b. Columns past a row's target dim are 0 (the caller slices
    them off), as the JAX one-hot contraction gives. A stacked [B, S,
    total] passes its view ``packed.permute(2, 0, 1)``."""
    dev = planes.device
    tab = _plane_table(plan.node_offsets, plan.node_dims, dev)
    start, dims = tab[:, target_idx.long()]  # [B] each
    max_d = int(max(plan.node_dims))
    j = torch.arange(max_d, device=dev)
    cols = torch.clamp(start[:, None] + j, max=plan.total_dim - 1)  # [B, M]
    rows = torch.arange(planes.shape[1], device=dev)[:, None]
    got = planes[cols, rows]  # [B, M, S]
    if min(plan.node_dims) < max_d:
        got = torch.where((j < dims[:, None])[:, :, None], got, 0.0)
    return got.transpose(1, 2).contiguous()
