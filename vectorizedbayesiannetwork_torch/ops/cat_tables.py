"""Padded running-sum tables of the categorical sweep kernels.

``vbn_cat_sweep`` (``ops/sweep.py``) and ``vbn_cat_scan``
(``ops/sweep_scan.py``) walk the same tables (``csrc/cat_walk.cuh``): for
every CPT row, the running sums of its counts in class order, and each
class's log-probability, each row padded to a multiple of four floats so
that a node of at most four classes reads its row in one float4 load. The
two wrappers keep their counts in different flat layouts, so a layout names
where each node's rows start in the flat counts and how far apart they lie.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.profiling import BUILDS, spanned


@functools.lru_cache(maxsize=64)
def padded_layout(rows, cards, starts, row_strides):
    """(off [N], src [L], col [L], cols) of the padded tables for nodes
    with ``rows[i]`` CPT rows of ``cards[i]`` classes, row r of node i at
    ``starts[i] + r * row_strides[i]`` in the flat counts. Node i's rows
    start at ``off[i]`` in the tables, ``round_up(card, 4)`` floats each;
    ``src`` is each padded entry's index in the flat counts (a pad repeats
    its row's last class), ``col`` its class column and ``cols[j]`` the
    padded positions of column j >= 1. L is the padded length."""
    off, src, col = [], [], []
    at = 0
    for r, c, start, stride in zip(rows, cards, starts, row_strides):
        cp = (c + 3) & ~3
        j = np.arange(cp)
        off.append(at)
        src.append((start + np.arange(r)[:, None] * stride
                    + np.minimum(j, c - 1)[None, :]).reshape(-1))
        col.append(np.tile(j, r))
        at += r * cp
    src, col = np.concatenate(src), np.concatenate(col)
    cols = tuple(np.flatnonzero(col == j) for j in range(1, int(col.max()) + 1))
    return np.asarray(off, np.int64), src, col, cols


@functools.lru_cache(maxsize=64)
def _layout_on(layout, device: torch.device):
    """(src, live, cols, last) of ``padded_layout(*layout)`` on ``device``;
    live marks the entries that are a class of their row, not a pad, and
    last is the position of each entry's row's last padded entry."""
    rows, cards = layout[:2]
    _off, src, col, cols = padded_layout(*layout)
    cards = np.asarray(cards)
    node = np.repeat(np.arange(len(cards)),
                     [r * ((c + 3) & ~3) for r, c in zip(rows, cards)])
    live = col < cards[node]
    width = ((cards + 3) & ~3)[node]
    last = np.arange(len(col)) - col + width - 1

    def dev(a, dtype=torch.int64):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return (dev(src), dev(live, torch.bool), tuple(dev(c) for c in cols),
            dev(last))


@spanned("vbn.tables")
def cum_tables(flat_counts: torch.Tensor, layout):
    """The kernels' tables from the flat counts: (running sums,
    log-probabilities), both [L] float32 in ``padded_layout(*layout)``. The
    running sums take one float32 add per class in class order, the
    rounding of a sequential sum; a pad repeats its row's total. A class's
    log-probability is the plain versions' expression on the same floats,
    log(max(count / max(total, 1e-12), 1e-12)), so a kernel that reads it
    gives their weights bit for bit on the same device."""
    BUILDS["tables"] += 1
    src, live, cols, last = _layout_on(layout, flat_counts.device)
    cnt = torch.where(live, flat_counts[src], 0.0)
    cum = cnt.clone()
    for pos in cols:  # column j: cum_j = cum_{j-1} + cnt_j
        cum[pos] = cum[pos - 1] + cnt[pos]
    prob = cnt / torch.clamp(cum[last], min=1e-12)
    return cum, torch.log(torch.clamp(prob, min=1e-12))
