"""Junction-tree calibration: exact discrete posteriors past enumeration.

Port of ``vectorizedbayesiannetwork_tpu/inference/_jtree.py``.
``_exact_enum.py`` enumerates the joint state space, which is hopeless
past ~2^16 states (insurance's joint support is ~10^13). This module runs
the clique-tree sum-product algorithm instead, batched over query rows:

- Host side, once per network (numpy and Python): moralize the DAG,
  triangulate by greedy min-weight elimination, keep the maximal cliques,
  join them into a max-spanning tree on separator sizes, give each CPT
  family and each evidence message a home clique, and order a two-pass
  (collect, distribute) message schedule.
- Device side, per batch (torch on the VBN's device): clique potentials
  are products of the CPTs (``categorical_probs`` on the enumerated parent
  values, so a refit needs no rebuild) and of per-node evidence messages
  (``onehot(class)`` where clamped, else ones); evidence and do values and
  masks are inputs, so one tree answers every query skeleton and every
  target. ``do`` replaces the intervened node's own CPT factor by ones per
  row (graph surgery), as ``_exact_enum`` does.
- Numerics: linear space, every message and belief normalized (the
  posterior is conditional, so the normalizers cancel), floors against
  zero-probability evidence.

The cost is O(sum over cliques of B x clique states), not O(B x joint
states): insurance (27 nodes) and alarm (37) calibrate in a few dozen
small tensor ops a clique.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.plan import InferencePlan
from ._exact_enum import _combo_digits, clamped_class, cpt_and_support

_EPS = 1e-30


# ---------------------------------------------------------------------------
# Host-side structure build
# ---------------------------------------------------------------------------


class JTree:
    """Static junction-tree structure for a plan (host side)."""

    def __init__(self, cards, cliques, parent, order, factor_home,
                 message_home, max_states) -> None:
        self.cards = cards
        self.cliques = cliques  # sorted var tuples
        self.parent = parent  # parent clique index (-1 = root of its tree)
        self.order = order  # upward (children-first) traversal order
        self.factor_home = factor_home  # node i's CPT lives in clique[...]
        self.message_home = message_home  # node i's evidence message clique
        self.node_home = message_home  # smallest clique containing node i
        self.max_states = max_states


def build_jtree(plan: InferencePlan, cards: Sequence[int],
                max_clique_states: int) -> Optional[JTree]:
    """Moralize, min-weight triangulate, junction tree; None when the
    largest clique exceeds ``max_clique_states``."""
    n = plan.n_nodes
    adj = [set() for _ in range(n)]

    def connect(a: int, b: int) -> None:
        if a != b:
            adj[a].add(b)
            adj[b].add(a)

    for i in range(n):
        for p in plan.parent_idx[i]:
            connect(i, p)
        for a in plan.parent_idx[i]:
            for b in plan.parent_idx[i]:
                connect(a, b)  # moralization: marry parents

    # greedy min-weight elimination over the moralized graph
    work = [set(s) for s in adj]
    alive = set(range(n))
    cliques: List[Tuple[int, ...]] = []
    max_states = 1
    while alive:
        best, best_w = None, None
        for v in alive:
            w = cards[v]
            for u in work[v]:
                w *= cards[u]
            if best_w is None or w < best_w:
                best, best_w = v, w
        if best_w > max_clique_states:
            return None
        v = best
        clique = tuple(sorted({v} | work[v]))
        max_states = max(max_states, best_w)
        nbrs = list(work[v])  # connect v's neighbours (fill-in), remove v
        for a in nbrs:
            for b in nbrs:
                if a != b:
                    work[a].add(b)
        for u in nbrs:
            work[u].discard(v)
        alive.discard(v)
        work[v] = set()
        cliques.append(clique)

    # maximal cliques only
    maximal: List[Tuple[int, ...]] = []
    for c in cliques:
        cs = set(c)
        if not any(cs <= set(m) for m in maximal):
            maximal = [m for m in maximal if not set(m) < cs]
            maximal.append(c)
    cliques = maximal
    m = len(cliques)
    csets = [set(c) for c in cliques]

    # max-spanning forest on separator sizes (Prim per component): the
    # running-intersection property holds for max-weight trees over
    # elimination cliques
    parent = [-1] * m
    in_tree = [False] * m
    for root in range(m):
        if in_tree[root]:
            continue
        in_tree[root] = True
        frontier = [root]
        while True:
            best_edge, best_w = None, 0
            for t in range(m):
                if in_tree[t]:
                    continue
                for s in frontier:
                    w = len(csets[s] & csets[t])
                    if w > best_w:
                        best_edge, best_w = (s, t), w
            if best_edge is None:
                break
            s, t = best_edge
            parent[t] = s
            in_tree[t] = True
            frontier.append(t)

    # children-first traversal order (upward pass)
    children = [[] for _ in range(m)]
    roots = []
    for c, p in enumerate(parent):
        if p >= 0:
            children[p].append(c)
        else:
            roots.append(c)
    order: List[int] = []

    def post(c: int) -> None:
        for ch in children[c]:
            post(ch)
        order.append(c)

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * m + 100))
    try:
        for r in roots:
            post(r)
    finally:
        sys.setrecursionlimit(old_limit)

    def home_for(vars_needed: set) -> int:
        best, best_states = None, None
        for ci, cs in enumerate(csets):
            if vars_needed <= cs:
                st = int(np.prod([cards[v] for v in cliques[ci]]))
                if best_states is None or st < best_states:
                    best, best_states = ci, st
        assert best is not None, "triangulation must cover every family"
        return best

    factor_home = [home_for({i} | set(plan.parent_idx[i])) for i in range(n)]
    message_home = [home_for({i}) for i in range(n)]
    return JTree(tuple(int(c) for c in cards), cliques, parent, order,
                 factor_home, message_home, max_states)


# ---------------------------------------------------------------------------
# Batched calibration on the device
# ---------------------------------------------------------------------------


def _expand(arr: torch.Tensor, vars_: Tuple[int, ...],
            clique: Tuple[int, ...], cards) -> torch.Tensor:
    """[B, *vars_ shape] -> [B, *clique shape] with size-1 axes inserted."""
    pos = {v: k for k, v in enumerate(vars_)}
    perm = [0] + [1 + pos[v] for v in clique if v in pos]
    shape = [arr.shape[0]] + [cards[v] if v in pos else 1 for v in clique]
    return arr.permute(perm).reshape(shape)


def _marginalize_to(pot: torch.Tensor, clique: Tuple[int, ...],
                    keep: Tuple[int, ...]) -> torch.Tensor:
    """Sum a [B, *clique] potential onto ``keep`` (in clique order)."""
    axes = tuple(1 + k for k, v in enumerate(clique) if v not in keep)
    return pot.sum(dim=axes) if axes else pot


def _norm(x: torch.Tensor) -> torch.Tensor:
    z = x.sum(dim=tuple(range(1, x.ndim)), keepdim=True)
    return x / torch.clamp(z, min=_EPS)


def make_jtree_fn(plan: InferencePlan, cpds: Sequence, k_out: int,
                  tree: JTree):
    """``fn(params_tuple, packed_in) -> (pmf [B, k_out],)``, the contract
    of ``make_exact_enum_fn``; rows normalized here."""
    cards = tree.cards
    n = plan.n_nodes
    k_enc = max(k_out, max(cards))
    combo = _combo_digits(plan, cards)
    m = len(tree.cliques)
    children: List[List[int]] = [[] for _ in range(m)]
    for c, p in enumerate(tree.parent):
        if p >= 0:
            children[p].append(c)
    seps = [None] * m  # clique c's separator with its parent
    for c, p in enumerate(tree.parent):
        if p >= 0:
            pset = set(tree.cliques[p])
            seps[c] = tuple(v for v in tree.cliques[c] if v in pset)

    def fn(params_tuple, packed_in):
        fixed, ev_mask, do_mask, target_idx = packed_in
        b, dev = fixed.shape[0], fixed.device
        clamped = torch.maximum(ev_mask, do_mask) > 0.5  # [B, n]

        # per-node CPTs [B, *family] (do() puts ones in place of the factor
        # per row) and evidence messages [B, k]
        cpts, msgs = [], []
        for i in range(n):
            probs, support = cpt_and_support(plan, cpds, params_tuple, cards,
                                             combo, i, dev)
            fam = tuple(cards[p] for p in plan.parent_idx[i]) + (cards[i],)
            probs = torch.clamp(probs, min=_EPS).reshape(fam)
            do_col = (do_mask[:, i] > 0.5).reshape((b,) + (1,) * len(fam))
            cpts.append(torch.where(do_col, 1.0, probs[None]))
            cls = clamped_class(fixed[:, plan.node_offsets[i]], support)
            onehot = torch.nn.functional.one_hot(cls, cards[i]).float()
            msgs.append(torch.where(clamped[:, i : i + 1], onehot, 1.0))

        # clique potentials: assigned CPTs x assigned evidence messages
        pots = []
        for ci, clique in enumerate(tree.cliques):
            pot = torch.ones((b,) + tuple(cards[v] for v in clique),
                             dtype=torch.float32, device=dev)
            for i in range(n):
                if tree.factor_home[i] == ci:
                    fam_vars = tuple(plan.parent_idx[i]) + (i,)
                    pot = pot * _expand(cpts[i], fam_vars, clique, cards)
                if tree.message_home[i] == ci:
                    pot = pot * _expand(msgs[i], (i,), clique, cards)
            pots.append(pot)

        def with_up(c, pot, skip=-1):
            for ch in children[c]:
                if ch != skip:
                    pot = pot * _expand(up[ch], seps[ch], tree.cliques[c],
                                        cards)
            return pot

        # upward (collect) pass, children first
        up = [None] * m  # message c -> parent[c], over seps[c]
        for c in tree.order:
            if tree.parent[c] >= 0:
                up[c] = _norm(_marginalize_to(with_up(c, pots[c]),
                                              tree.cliques[c], seps[c]))

        # downward (distribute) pass, parents first
        down = [None] * m  # message parent[c] -> c, over seps[c]
        for c in reversed(tree.order):
            p = tree.parent[c]
            if p < 0:
                continue
            pot = pots[p]
            if tree.parent[p] >= 0:
                pot = pot * _expand(down[p], seps[p], tree.cliques[p], cards)
            down[c] = _norm(_marginalize_to(with_up(p, pot, skip=c),
                                            tree.cliques[p], seps[c]))

        # calibrated beliefs -> per-node marginals [B, n, k_enc]
        node_marg = []
        beliefs = {}
        for i in range(n):
            ci = tree.node_home[i]
            if ci not in beliefs:
                pot = with_up(ci, pots[ci])
                if tree.parent[ci] >= 0:
                    pot = pot * _expand(down[ci], seps[ci], tree.cliques[ci],
                                        cards)
                beliefs[ci] = pot
            marg = _marginalize_to(beliefs[ci], tree.cliques[ci], (i,))
            marg = marg / torch.clamp(marg.sum(dim=1, keepdim=True), min=_EPS)
            node_marg.append(torch.nn.functional.pad(marg,
                                                     (0, k_enc - cards[i])))
        stacked = torch.stack(node_marg, dim=1)  # [B, n, k_enc]
        tgt = torch.nn.functional.one_hot(target_idx.long(), n).float()
        pmf = torch.einsum("bnc,bn->bc", stacked, tgt)
        return (pmf[:, :k_out],)

    return fn
