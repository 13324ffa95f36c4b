"""Plain likelihood weighting over a network of neural Gaussian CPDs, in
PyTorch float64.

A node with parents holds an MLP in the published layout,
``{"layers": [{"w": [in, out], "b": [out]}, ...]}`` with ReLU between
layers, and its standardization ``stats``:

    h = (pa - mean_x) / std_x
    (a, r) = MLP(h)                      # two output columns
    loc = a * std_y + mean_y
    scale = (softplus(r) + min_scale) * std_y

A root takes ``a = loc`` and ``r = log_scale``. ``softplus(r) = log(1 +
exp(r))``, and ``r`` itself where ``r > 20``: the form of
``torch.nn.functional.softplus`` at its default threshold, which the
port's ``ops/gauss.py::safe_softplus`` uses. A free node is drawn once a
particle from one forward (``loc + scale * normal``); an evidence node
adds ``log N(e; loc, scale)`` to the particle's log-weight.

Every product is float64, which TF32 never touches; ``no_tf32`` turns the
TF32 switches off around the reference's work all the same and puts the
process's own setting back afterwards, so the program's setting is never
changed by the check.

``lw_moments`` returns, per row, the weighted (mean, std) of the target
and the delta-method standard error of each, the shape that
``check.judge_moments`` reads.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

F64 = torch.float64
LOG_2PI = math.log(2.0 * math.pi)


@contextmanager
def no_tf32():
    """TF32 off for matrix products and cuDNN inside, the caller's
    setting back after."""
    mm = torch.backends.cuda.matmul.allow_tf32
    dnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = dnn


@dataclass
class GnnNode:
    """One node's CPD in float64."""
    layers: Optional[List[Tuple[torch.Tensor, torch.Tensor]]]  # None: a root
    loc: Optional[torch.Tensor]  # a root's [1]
    log_scale: Optional[torch.Tensor]  # a root's [1]
    mean_x: torch.Tensor  # [dp]
    std_x: torch.Tensor  # [dp]
    mean_y: float
    std_y: float
    min_scale: float


def node(net: Dict, stats: Dict, min_scale: float, device) -> GnnNode:
    """A node's CPD from its parameter tree and stats (arrays or tensors)."""
    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=F64, device=device)

    layers = loc = log_scale = None
    if "layers" in net:
        layers = [(t(lay["w"]), t(lay["b"])) for lay in net["layers"]]
    else:
        loc, log_scale = t(net["loc"]).reshape(-1), t(net["log_scale"]).reshape(-1)
    return GnnNode(layers=layers, loc=loc, log_scale=log_scale,
                   mean_x=t(stats["mean_x"]).reshape(-1),
                   std_x=t(stats["std_x"]).reshape(-1),
                   mean_y=float(np.asarray(stats["mean_y"]).reshape(-1)[0]),
                   std_y=float(np.asarray(stats["std_y"]).reshape(-1)[0]),
                   min_scale=float(min_scale))


def softplus(r: torch.Tensor) -> torch.Tensor:
    return torch.where(r > 20.0, r,
                       torch.log1p(torch.exp(torch.clamp(r, max=20.0))))


def loc_scale(nd: GnnNode, pa: Optional[torch.Tensor], m: int):
    """(loc [m], scale [m]) in float64; ``pa`` [m, dp], None for a root."""
    if nd.layers is None:
        a, r = nd.loc.expand(m), nd.log_scale.expand(m)
    else:
        h = (pa.to(F64) - nd.mean_x) / nd.std_x
        for i, (w, b) in enumerate(nd.layers):
            h = h @ w + b
            if i < len(nd.layers) - 1:
                h = torch.relu(h)
        a, r = h[:, 0], h[:, 1]
    return (a * nd.std_y + nd.mean_y,
            (softplus(r) + nd.min_scale) * nd.std_y)


def log_normal(x: torch.Tensor, loc: torch.Tensor, scale: torch.Tensor):
    z = (x - loc) / scale
    return -0.5 * (z * z + LOG_2PI) - torch.log(scale)


def lw_moments(nodes: Sequence[str], parents: Dict[str, List[str]],
               gnn: Dict[str, GnnNode],
               rows: Sequence[Tuple[str, Dict[str, float]]], s: int,
               gen: torch.Generator, device) -> np.ndarray:
    """[R, 5] rows: mean, std, se(mean), se(std), effective sample size."""
    out = np.zeros((len(rows), 5))
    with no_tf32():
        for r, (target, ev) in enumerate(rows):
            x: Dict[str, torch.Tensor] = {}
            logw = torch.zeros(s, dtype=F64, device=device)
            for n in nodes:
                pa = (torch.stack([x[p] for p in parents[n]], 1)
                      if parents[n] else None)
                loc, scale = loc_scale(gnn[n], pa, s)
                if n in ev:
                    x[n] = torch.full((s,), float(ev[n]), dtype=F64,
                                      device=device)
                    logw += log_normal(x[n], loc, scale)
                else:
                    x[n] = loc + scale * torch.randn(s, generator=gen,
                                                     dtype=F64, device=device)
            w = torch.exp(logw - logw.max())
            w = w / w.sum()
            t = x[target]
            mean = (w * t).sum()
            dev2 = (t - mean) ** 2
            var = (w * dev2).sum()
            std = torch.sqrt(var)
            se_mean = torch.sqrt((w ** 2 * dev2).sum())
            se_std = torch.sqrt((w ** 2 * (dev2 - var) ** 2).sum()) / (2 * std)
            out[r] = [float(mean), float(std), float(se_mean), float(se_std),
                      float(1.0 / (w ** 2).sum())]
    return out
