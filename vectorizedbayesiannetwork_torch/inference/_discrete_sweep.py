"""Stacked-table ancestral sweep for all-categorical networks, in torch ops.

Counterpart of ``vectorizedbayesiannetwork_tpu/inference/_discrete_sweep.py``
(its ``lax.scan`` form). When every node is a ``categorical_table`` with
declared integer supports (``n_classes`` > 0, and ``parent_n_classes`` for
a node with parents), the whole DAG is one Python loop over topological
order on stacked, padded CPTs:

  * every node's conditional log-probs in one ``[total_rows, Cmax]``
    matrix, ``log(max(p, 1e-12))``, with ``-1e30`` on masked and padded
    classes, and each node's first row in ``row_offset``;
  * the parent wiring as ``[N, Pmax]`` index and mixed-radix stride tables;
  * a step gathers the parents' class indices, computes the table row,
    gathers that row's log-probs, draws a class, clamps evidence and do
    values, and adds the log-weights.

The JAX form's one-hot matmul lookup is a TPU measure (gathers were slow
there); on the card the lookup is a row gather. Values stay class indices
during the loop (the declared-support precondition makes the parents' and
children's index spaces the same) and are the float class values at the
end, so the function is a drop-in replacement for ``sweep_trace``. The
state is node-major ``[N, B, S]`` (a step writes one contiguous block)
and is returned as its ``[B, S, N]`` view.

Two draw forms, as in the JAX package: the Gumbel-argmax over the row's
``[B, S, Cmax]`` log-probs, or, past an 8 GiB ``[B, S, 128]`` projection
(``VBN_SCAN_CLASS_LOOP=always|never`` overrides), the class loop's inverse
CDF on one uniform a particle, with ``[B, S]`` operands only; the form
is chosen on the batch's whole size, so a mesh rank's block draws as the
whole batch does. Draws come from the call's row stream (node i: the
class loop's uniform in slot 0, the Gumbel's in slots 0 .. Cmax - 1),
drawn ahead a chunk of nodes a ``vbn_uniforms`` launch
(``core/rng.py::ChunkedDraws``); ``noise`` takes the JAX package's own
draws instead (Gumbel ``[N, B, S, Cmax]``, uniforms ``[N, B, S]``).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.plan import InferencePlan
from ..core.rng import ChunkedDraws

_NEG = -1e30  # log-prob of a masked or padded class


def discrete_sweep_supported(plan: InferencePlan, cpds: Sequence) -> bool:
    from ..models.categorical_table import CategoricalTableCPD

    for cpd in cpds:
        if not isinstance(cpd, CategoricalTableCPD):
            return False
        if cpd.output_dim != 1 or cpd.resolved_classes <= 0:
            return False
        if cpd.n_classes <= 0:
            return False  # inferred class support: index spaces may differ
        if cpd.input_dim > 0 and (cpd.parent_n_classes is None
                                  or cpd.parent_cards is None):
            return False
    return True


def _static_tables(plan: InferencePlan, cpds: Sequence, device=None):
    """The padded wiring tables, on ``device``."""
    n = plan.n_nodes
    cmax = max(cpd.resolved_classes for cpd in cpds)
    pmax = max(max((len(p) for p in plan.parent_idx), default=0), 1)
    parent_ids = np.zeros((n, pmax), np.int32)
    strides = np.zeros((n, pmax), np.int32)
    row_offset = np.zeros((n,), np.int32)
    cards = np.zeros((n,), np.int32)
    offset = 0
    for i, cpd in enumerate(cpds):
        pidx = plan.parent_idx[i]
        parent_ids[i, : len(pidx)] = pidx
        node_strides = cpd._strides  # mixed-radix strides, parent order
        strides[i, : len(node_strides)] = node_strides
        row_offset[i] = offset
        offset += cpd._parent_states
        cards[i] = cpd.resolved_classes

    def dev(a):
        return torch.as_tensor(a, device=device)

    return {
        "parent_ids": dev(parent_ids),
        "strides": dev(strides),
        "row_offset": dev(row_offset),
        "cards": dev(cards),
        "evidence_mask": dev(np.asarray(plan.evidence_mask, bool)),
        "fixed_mask": dev(np.asarray(
            [plan.is_fixed(i) for i in range(n)], bool)),
        "total_rows": offset,
        "cmax": cmax,
    }


def _stacked_log_cpt(cpds: Sequence, params_tuple: Tuple, cmax: int):
    """Every node's conditional log-prob table, stacked: [R, Cmax]."""
    blocks = []
    for params in params_tuple:
        probs = params["counts"][0]  # [P, C]
        probs = probs / torch.clamp(probs.sum(-1, keepdim=True), min=1e-12)
        lp = torch.log(torch.clamp(probs, min=1e-12))
        lp = torch.where(params["class_mask"][0] > 0, lp, _NEG)
        blocks.append(torch.nn.functional.pad(
            lp, (0, cmax - lp.shape[-1]), value=_NEG))
    return torch.cat(blocks, dim=0)


def class_loop_form(b: int, s: int, cmax: int) -> bool:
    """The JAX package's choice of draw form: the class loop past an
    8 GiB [B, S, 128] float32 projection, unless VBN_SCAN_CLASS_LOOP says
    ``always`` or ``never``."""
    mode = os.environ.get("VBN_SCAN_CLASS_LOOP", "auto").lower()
    return cmax < 128 and (
        mode == "always" or (mode != "never" and b * s * 128 * 4 > (8 << 30))
    )


def discrete_sweep_trace(
    plan: InferencePlan,
    cpds: Sequence,
    params_tuple: Tuple,
    stream,  # core.rng.RowStream, or None with ``noise``
    fixed: torch.Tensor,  # [B, total_dim] float class values
    n_samples: int,
    *,
    weighted: bool = False,
    ev_mask_arr=None,  # [B, N] runtime evidence mask (overrides the plan)
    fx_mask_arr=None,  # [B, N] runtime evidence|do mask
    tgt_mask_arr=None,  # [B, N] one-hot target -> extra lp_tgt output
    noise: Optional[torch.Tensor] = None,  # the draws, in JAX's layout
) -> Tuple[torch.Tensor, ...]:
    """Drop-in stacked-table replacement for ``sweep_trace`` (same
    contract): ``(packed [B, S, N], log_weights [B, S])``, and with
    ``tgt_mask_arr`` a third output, each row's target log-density at its
    final value. With ``ev_mask_arr``/``fx_mask_arr`` the masks are per
    row (mask-dynamic sweeps)."""
    dev = fixed.device
    tables = _static_tables(plan, cpds, dev)
    cmax = tables["cmax"]
    log_cpt = _stacked_log_cpt(cpds, params_tuple, cmax)
    b, s, n = fixed.shape[0], n_samples, plan.n_nodes
    class_loop = (class_loop_form(b, s, cmax) if stream is None else
                  class_loop_form(stream.n_rows, stream.n_particles, cmax))
    if noise is not None:
        want = (n, b, s) if class_loop else (n, b, s, cmax)
        if tuple(noise.shape) != want:
            raise ValueError(
                f"noise {tuple(noise.shape)} != {want} "
                f"({'class loop' if class_loop else 'Gumbel'} form)")

    # total_dim == n (every dim is 1); evidence/do values are class indices
    fixed_idx = torch.minimum(
        torch.clamp(torch.round(fixed).long(), min=0),
        tables["cards"].long()[None, :] - 1,
    )  # [B, N]
    if ev_mask_arr is None:
        ev_mask = tables["evidence_mask"][:, None]  # [N, 1]
        fx_mask = tables["fixed_mask"][:, None]
    else:
        ev_mask = (ev_mask_arr > 0).T  # [N, B]
        fx_mask = (fx_mask_arr > 0).T
    tg_mask = None if tgt_mask_arr is None else (tgt_mask_arr > 0).T
    parent_ids = tables["parent_ids"].long()
    strides = tables["strides"].long()
    row_offset = tables["row_offset"].long()
    cpt_cols = log_cpt.T.contiguous() if class_loop else None  # [Cmax, R]
    n_par = [len(p) for p in plan.parent_idx]

    ahead = (None if noise is not None else
             ChunkedDraws(stream, n, 1 if class_loop else cmax))
    states = torch.empty((n, b, s), dtype=torch.float32, device=dev)
    logw = torch.zeros((b, s), dtype=torch.float32, device=dev)
    lpt = torch.zeros((b, s), dtype=torch.float32, device=dev)
    for i in range(n):
        rows = row_offset[i].expand(b, s)
        if n_par[i]:
            k = n_par[i]  # absent slots have stride 0: they add nothing
            pvals = states.index_select(0, parent_ids[i, :k])  # [k, B, S]
            rows = rows + (pvals.long() * strides[i, :k, None, None]).sum(0)
        if class_loop:
            lps = [cpt_cols[j][rows] for j in range(cmax)]  # [B, S] each
            probs = [torch.exp(lp) for lp in lps]
            total = probs[0]
            for j in range(1, cmax):
                total = total + probs[j]
            u = noise[i] if noise is not None else ahead(i).reshape(b, s)
            thresh = u * total
            cum = probs[0]
            sampled = torch.zeros((b, s), dtype=torch.int64, device=dev)
            for j in range(1, cmax):
                sampled = sampled + (cum <= thresh).long()
                cum = cum + probs[j]
        else:
            logits = log_cpt[rows]  # [B, S, Cmax]
            if noise is not None:
                g = noise[i]
            else:
                u = ahead(i).reshape(b, s, cmax)  # in (0, 1)
                g = -torch.log(-torch.log(u))
            sampled = torch.argmax(logits + g, dim=-1)
        fx_i = fx_mask[i][:, None]  # [B, 1] or [1, 1]
        value = torch.where(fx_i, fixed_idx[:, i][:, None], sampled)
        states[i] = value
        if weighted or tg_mask is not None:
            if class_loop:
                lp_val = torch.where(value == 0, lps[0], 0.0)
                for j in range(1, cmax):
                    lp_val = lp_val + torch.where(value == j, lps[j], 0.0)
            else:
                lp_val = logits.gather(-1, value[..., None])[..., 0]
            if weighted:
                logw = logw + torch.where(ev_mask[i][:, None], lp_val, 0.0)
            if tg_mask is not None:
                lpt = lpt + torch.where(tg_mask[i][:, None], lp_val, 0.0)
    # index space == value space under the declared-support precondition
    packed = states.permute(1, 2, 0)
    if tg_mask is not None:
        return packed, logw, lpt
    return packed, logw
