"""Plain likelihood weighting over a categorical network, in PyTorch.

The control of the discrete cells: it stands in the program's place with
fewer particles than the configuration states. Each row draws S
particles ancestrally (inverse CDF on one uniform a node), clamps its
evidence nodes and adds their log-probabilities to the weights; the
answer is the weighted histogram of the target, normalized.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def lw_pmf(nodes: Sequence[str], parents: Dict[str, List[str]],
           cards: Dict[str, int], cpts: Dict[str, np.ndarray],
           rows: Sequence[Tuple[str, Dict[str, float]]], s: int,
           gen: torch.Generator, device, block: int = 1 << 22) -> np.ndarray:
    """pmf rows [R, max card] of ``rows`` (target, evidence) from S
    particles each, float32 draws and float64 weights."""
    kmax = max(cards.values())
    ix = {n: i for i, n in enumerate(nodes)}
    tabs = {n: torch.as_tensor(cpts[n].reshape(-1, cards[n]), dtype=torch.float32,
                               device=device) for n in nodes}
    cums = {n: torch.cumsum(t, dim=1) for n, t in tabs.items()}
    out = np.zeros((len(rows), kmax))
    per = max(1, block // s)
    for r0 in range(0, len(rows), per):
        part = rows[r0:r0 + per]
        nr = len(part)
        m = nr * s
        ev_mask = torch.zeros((len(nodes), nr), dtype=torch.bool)
        ev_val = torch.zeros((len(nodes), nr), dtype=torch.int64)
        tgt = torch.zeros((len(nodes), nr), dtype=torch.bool)
        for r, (t, ev) in enumerate(part):
            tgt[ix[t], r] = True
            for n, v in ev.items():
                ev_mask[ix[n], r] = True
                ev_val[ix[n], r] = int(v)
        ev_mask = ev_mask.to(device).repeat_interleave(s, dim=1)
        ev_val = ev_val.to(device).repeat_interleave(s, dim=1)
        tgt = tgt.to(device).repeat_interleave(s, dim=1)
        x: Dict[str, torch.Tensor] = {}
        logw = torch.zeros(m, dtype=torch.float64, device=device)
        tval = torch.zeros(m, dtype=torch.int64, device=device)
        for n in nodes:
            i = ix[n]
            row = torch.zeros(m, dtype=torch.int64, device=device)
            for p in parents[n]:
                row = row * cards[p] + x[p]
            u = torch.rand(m, generator=gen, device=device)
            drawn = (cums[n][row] < u[:, None]).sum(dim=1).clamp_(max=cards[n] - 1)
            val = torch.where(ev_mask[i], ev_val[i], drawn)
            lp = torch.log(tabs[n][row, val].double())
            logw += torch.where(ev_mask[i], lp, torch.zeros_like(lp))
            tval = torch.where(tgt[i], val, tval)
            x[n] = val
        logw = logw.view(nr, s)
        w = torch.exp(logw - logw.max(dim=1, keepdim=True).values)
        hist = torch.zeros((nr, kmax), dtype=torch.float64, device=device)
        hist.scatter_add_(1, tval.view(nr, s), w)
        hist = hist / hist.sum(dim=1, keepdim=True)
        out[r0:r0 + nr] = hist.cpu().numpy()
    return out
