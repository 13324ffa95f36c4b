"""Mask-dynamic exact enumeration over a discrete network's joint support.

Port of ``vectorizedbayesiannetwork_tpu/inference/_exact_enum.py``. For a
fully discrete network whose joint state space is small (the engine's
``max_states``, 2^16 by default), ``p(target | evidence, do)`` is exact:
enumerate the joint states once (host tables), build each node's CPT from
its params through ``categorical_probs`` on the enumerated parent values
(so a refit needs no rebuild), and reduce per query with three
matrix products over ``[B, S]``: the CPT sum ``(1 - do) @ log_joint^T``,
the clamped-state match through one-hot state codes, and the target-class
histogram. One function per network answers every query skeleton.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.plan import InferencePlan

_BIG_NEG = -1e30


def _node_cards(plan: InferencePlan, cpds: Sequence) -> Optional[Tuple[int, ...]]:
    """Per-node class counts, or None if any node is not enum-compatible."""
    cards = []
    for idx, cpd in enumerate(cpds):
        if plan.node_dims[idx] != 1:
            return None
        if not (hasattr(cpd, "categorical_probs")
                and hasattr(cpd, "support_values")):
            return None
        k = int(getattr(cpd, "resolved_classes", 0)
                or getattr(cpd, "n_classes", 0) or 0)
        if k <= 0:
            return None
        cards.append(k)
    return tuple(cards)


def exact_enum_supported(plan: InferencePlan, cpds: Sequence,
                         max_states: int) -> bool:
    cards = _node_cards(plan, cpds)
    if cards is None:
        return False
    states = 1
    for k in cards:
        states *= k
        if states > max_states:
            return False
    return True


def _mixed_radix_digits(count: int, radices: Sequence[int]) -> np.ndarray:
    """[count, len(radices)] digit matrix, last radix fastest-varying."""
    out = np.zeros((count, len(radices)), np.int32)
    rem = np.arange(count, dtype=np.int64)
    for j in range(len(radices) - 1, -1, -1):
        out[:, j] = rem % radices[j]
        rem //= radices[j]
    return out


def _combo_digits(plan: InferencePlan, cards) -> list:
    """Per node, the [n_combos, n_parents] digits of its parents' class
    combinations (CPT rows in mixed-radix order), or None for a root."""
    out = []
    for pidx in plan.parent_idx:
        rad = [cards[p] for p in pidx]
        out.append(_mixed_radix_digits(int(np.prod(rad, dtype=np.int64)), rad)
                   if pidx else None)
    return out


def _parent_values(cpds, params_tuple, cards, digits, pidx, dev):
    """[n_combos, n_parents] parent support values of the CPT rows."""
    cols = []
    for j, p in enumerate(pidx):
        sup = cpds[p].support_values(params_tuple[p])[0][: cards[p]]
        cols.append(sup[torch.as_tensor(digits[:, j], device=dev).long()])
    return torch.stack(cols, dim=-1)


def cpt_and_support(plan, cpds, params_tuple, cards, combo, i, dev):
    """Node i's CPT [n_combos (1 for a root), k_i], as ``categorical_probs``
    gives it on its parents' support values, and its support values
    [k_i]."""
    pidx = plan.parent_idx[i]
    pmat = (_parent_values(cpds, params_tuple, cards, combo[i], pidx, dev)
            if pidx else None)
    probs = cpds[i].categorical_probs(params_tuple[i], pmat)[..., : cards[i]]
    return probs, cpds[i].support_values(params_tuple[i])[0][: cards[i]]


def clamped_class(fixed_col: torch.Tensor, support: torch.Tensor):
    """[B] the support class nearest each clamped value (the first on a
    tie)."""
    return torch.argmin((fixed_col[:, None] - support[None, :]).abs(), dim=1)


def make_exact_enum_fn(plan: InferencePlan, cpds: Sequence, k_out: int):
    """``fn(params_tuple, packed_in) -> (pmf [B, k_out],)``; ``packed_in``
    the (fixed, ev_mask, do_mask, target_idx) tensors of
    ``pack_dynamic_inputs``; pmf rows unnormalized (the caller divides)."""
    cards = _node_cards(plan, cpds)
    assert cards is not None
    n = plan.n_nodes
    k_enc = max(k_out, max(cards))
    digits = _mixed_radix_digits(int(np.prod(cards)), cards)  # [S, n]
    states = digits.shape[0]
    combo = _combo_digits(plan, cards)
    # per node, each joint state's index into its flattened CPT
    flat_cpt_idx = []
    for i in range(n):
        row = np.zeros(states, np.int64)
        for p in plan.parent_idx[i]:
            row = row * cards[p] + digits[:, p]
        flat_cpt_idx.append(row * cards[i] + digits[:, i])
    # one-hot state codes [S, n * k_enc]: block i holds onehot(class_i)
    codes_np = np.zeros((states, n, k_enc), np.float32)
    for i in range(n):
        codes_np[np.arange(states), i, digits[:, i]] = 1.0
    codes_np = codes_np.reshape(states, n * k_enc)
    on_dev = {}

    def tables(dev):
        if dev not in on_dev:
            on_dev[dev] = (
                torch.as_tensor(codes_np, device=dev),
                [torch.as_tensor(ix, device=dev) for ix in flat_cpt_idx],
            )
        return on_dev[dev]

    def fn(params_tuple, packed_in):
        fixed, ev_mask, do_mask, target_idx = packed_in
        b, dev = fixed.shape[0], fixed.device
        codes, cpt_idx = tables(dev)
        log_cpts, fixed_onehot = [], []
        for i in range(n):
            probs, support = cpt_and_support(plan, cpds, params_tuple, cards,
                                             combo, i, dev)
            logp = torch.log(torch.clamp(probs, min=1e-30))
            log_cpts.append(logp.reshape(-1)[cpt_idx[i]])  # [S]
            cls = clamped_class(fixed[:, plan.node_offsets[i]], support)
            fixed_onehot.append(
                torch.nn.functional.one_hot(cls, k_enc).float())
        log_joint = torch.stack(log_cpts, dim=1)  # [S, n]
        clamped = torch.maximum(ev_mask, do_mask)  # [B, n]
        clamp_codes = (torch.stack(fixed_onehot, dim=1)
                       * clamped[:, :, None]).reshape(b, n * k_enc)
        # do() drops the intervened node's own CPT factor (graph surgery);
        # evidence keeps every factor and only masks states
        cpt_sum = (1.0 - do_mask) @ log_joint.T  # [B, S]
        mismatch = clamped.sum(1, keepdim=True) - clamp_codes @ codes.T
        total = cpt_sum + torch.where(mismatch > 0.5, _BIG_NEG, 0.0)
        weights = torch.exp(total - total.max(dim=1, keepdim=True).values)
        hist = (weights @ codes).reshape(b, n, k_enc)
        tgt = torch.nn.functional.one_hot(target_idx.long(), n).float()
        pmf = torch.einsum("bnc,bn->bc", hist, tgt)
        return (pmf[:, :k_out],)

    return fn
