"""Linear-Gaussian CPD: ``Y | X ~ N(X W + b, diag(var))``.

Port of ``vectorizedbayesiannetwork_tpu/models/linear_gaussian.py``:
closed-form ridge fit by augmented least squares, ``min_scale`` floor at
evaluation time, reparameterized sampling and the diagonal Gaussian
log-density. The solve runs in float64 on the params' device and the
params are stored in float32, as the JAX package keeps them.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..core.base import BaseCPD, Params
from ..core.registry import register_cpd

LOG_2PI = math.log(2.0 * math.pi)


def _ridge_solve(parents: torch.Tensor, x: torch.Tensor, ridge: float):
    """(weight [Din, Dout], bias [Dout], var [Dout]) by ridge least squares:
    ``[X, 1; sqrt(r) I, 0] theta = [y; 0]``."""
    n, din = parents.shape
    dout = x.shape[1]
    kw = dict(dtype=x.dtype, device=x.device)
    x_aug = torch.cat([parents, torch.ones((n, 1), **kw)], dim=1)
    reg = torch.cat(
        [math.sqrt(ridge) * torch.eye(din, **kw), torch.zeros((din, 1), **kw)],
        dim=1,
    )
    a = torch.cat([x_aug, reg], dim=0)
    b = torch.cat([x, torch.zeros((din, dout), **kw)], dim=0)
    theta = torch.linalg.lstsq(a, b).solution
    residual = x - x_aug @ theta
    var = torch.clamp(residual.var(dim=0, unbiased=False), min=1e-6)
    return theta[:-1], theta[-1], var


@register_cpd("linear_gaussian")
class LinearGaussianCPD(BaseCPD):
    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        *,
        seed: Optional[int] = None,
        ridge: float = 1e-6,
        min_scale: float = 1e-3,
        **_ignored,
    ) -> None:
        super().__init__(input_dim, output_dim, seed=seed)
        self.ridge = float(ridge)
        self.min_scale = float(min_scale)

    def get_init_kwargs(self):
        return {"ridge": self.ridge, "min_scale": self.min_scale}

    def _static_fields(self) -> tuple:
        return (self.ridge, self.min_scale)

    def init(self, device) -> Params:
        f32 = dict(dtype=torch.float32, device=device)
        return {
            "weight": torch.zeros((self.input_dim, self.output_dim), **f32),
            "bias": torch.zeros((self.output_dim,), **f32),
            "var": torch.ones((self.output_dim,), **f32),
        }

    def fit(self, params, parents, x, *, device, ridge=None, **_training):
        """Closed form; epochs/lr/batch_size are accepted and unused."""
        f64 = dict(dtype=torch.float64, device=device)
        x = torch.as_tensor(np.asarray(x, np.float32), **f64).reshape(
            -1, self.output_dim
        )
        r = self.ridge if ridge is None else float(ridge)
        if r < 0:
            raise ValueError("ridge must be >= 0")
        if self.input_dim == 0:
            weight = torch.zeros((0, self.output_dim), **f64)
            bias = x.mean(dim=0)
            var = torch.clamp(x.var(dim=0, unbiased=False), min=1e-12)
        else:
            p = torch.as_tensor(np.asarray(parents, np.float32), **f64)
            p = p.reshape(-1, self.input_dim)
            if p.shape[0] != x.shape[0]:
                raise ValueError(
                    f"parents rows {p.shape[0]} != x rows {x.shape[0]}"
                )
            weight, bias, var = _ridge_solve(p, x, r)
        return {
            "weight": weight.float(),
            "bias": bias.float(),
            "var": var.float(),
        }

    def _scale(self, params: Params) -> torch.Tensor:
        return torch.sqrt(torch.clamp(params["var"], min=self.min_scale**2))

    def _loc(self, params: Params, parents, m: int) -> torch.Tensor:
        if self.input_dim == 0:
            return params["bias"].expand(m, self.output_dim)
        return parents @ params["weight"] + params["bias"]

    def _sample_flat(self, params, gen, parents, m):
        loc = self._loc(params, parents, m)
        eps = torch.randn(
            (m, self.output_dim), generator=gen, device=loc.device,
            dtype=loc.dtype,
        )
        return loc + eps * self._scale(params)

    def _log_prob_flat(self, params, x, parents):
        loc = self._loc(params, parents, x.shape[0])
        scale = self._scale(params).expand_as(loc)
        z = (x - loc) / scale
        return -0.5 * torch.sum(
            z * z + 2.0 * torch.log(scale) + LOG_2PI, dim=-1
        )
