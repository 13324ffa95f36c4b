"""Plain likelihood weighting over a network of KDE CPDs, in PyTorch.

A KDE node holds n support points (parents p_n, value x_n), a bandwidth
h_y and a parent bandwidth h_p (``scale = max(h, 1e-3) + min_scale``).
Its density is ``p(x | pa) = sum_n softmax_n(-|pa - p_n|^2 / 2 h_p^2)
N(x; x_n, h_y^2)`` (a root: the plain mixture). A draw picks n by those
weights (inverse CDF on one uniform) and adds ``h_y`` times a normal; an
evidence node adds ``log p(e | pa)`` to the particle's weight. Kernel
matrices are float32 (differences, not a matrix product, so no TF32),
weights and sums float64.

``lw_moments`` returns, per row, the weighted (mean, std) of the target
and the delta-method standard error of each, so that a served estimate
can be judged in units of the Monte-Carlo error.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


@dataclass
class KdeNode:
    data_p: torch.Tensor  # [n, dp] float32
    data_x: torch.Tensor  # [n] float32
    y_scale: float
    p_scale: float


def _parent_logits(node: KdeNode, pa: torch.Tensor) -> torch.Tensor:
    d2 = torch.zeros((pa.shape[0], node.data_p.shape[0]), dtype=torch.float32,
                     device=pa.device)
    for j in range(pa.shape[1]):
        d2 += (pa[:, j, None] - node.data_p[None, :, j]) ** 2
    return -d2 / (2.0 * node.p_scale ** 2)


def _draw(node: KdeNode, pa, m, gen, device, chunk):
    n = node.data_x.shape[0]
    if pa is None:
        idx = torch.randint(0, n, (m,), generator=gen, device=device)
    else:
        idx = torch.empty(m, dtype=torch.int64, device=device)
        for a in range(0, m, chunk):
            b = min(m, a + chunk)
            logits = _parent_logits(node, pa[a:b])
            w = torch.softmax(logits, dim=1)
            cdf = torch.cumsum(w, dim=1)
            u = torch.rand((b - a, 1), generator=gen, device=device) * cdf[:, -1:]
            idx[a:b] = torch.searchsorted(cdf, u).view(-1).clamp_(max=n - 1)
    eps = torch.randn(m, generator=gen, device=device)
    return node.data_x[idx] + node.y_scale * eps


def _log_density(node: KdeNode, pa, value: float, m, device, chunk):
    """log p(value | pa) up to a constant of the node."""
    ky = -((value - node.data_x.double()) ** 2) / (2.0 * node.y_scale ** 2)
    if pa is None:
        return torch.logsumexp(ky, 0).expand(m)
    out = torch.empty(m, dtype=torch.float64, device=device)
    for a in range(0, m, chunk):
        b = min(m, a + chunk)
        kp = _parent_logits(node, pa[a:b]).double()
        out[a:b] = torch.logsumexp(kp + ky[None, :], 1) - torch.logsumexp(kp, 1)
    return out


def lw_moments(nodes: Sequence[str], parents: Dict[str, List[str]],
               kde: Dict[str, KdeNode],
               rows: Sequence[Tuple[str, Dict[str, float]]], s: int,
               gen: torch.Generator, device, chunk: int = 1 << 15
               ) -> np.ndarray:
    """[R, 5] rows: mean, std, se(mean), se(std), effective sample size."""
    out = np.zeros((len(rows), 5))
    for r, (target, ev) in enumerate(rows):
        x: Dict[str, torch.Tensor] = {}
        logw = torch.zeros(s, dtype=torch.float64, device=device)
        for n in nodes:
            pa = (torch.stack([x[p] for p in parents[n]], 1)
                  if parents[n] else None)
            if n in ev:
                logw += _log_density(kde[n], pa, float(ev[n]), s, device, chunk)
                x[n] = torch.full((s,), float(ev[n]), dtype=torch.float32,
                                  device=device)
            else:
                x[n] = _draw(kde[n], pa, s, gen, device, chunk)
        w = torch.exp(logw - logw.max())
        w = w / w.sum()
        t = x[target].double()
        mean = (w * t).sum()
        dev2 = (t - mean) ** 2
        var = (w * dev2).sum()
        std = torch.sqrt(var)
        se_mean = torch.sqrt((w ** 2 * dev2).sum())
        se_std = torch.sqrt((w ** 2 * (dev2 - var) ** 2).sum()) / (2 * std)
        ess = 1.0 / (w ** 2).sum()
        out[r] = [float(mean), float(std), float(se_mean), float(se_std),
                  float(ess)]
    return out
