"""Random-Fourier-Features Gaussian CPD (a GP regression approximation).

Port of ``vectorizedbayesiannetwork_tpu/models/rff_gaussian.py``: features
``sqrt(2/F) cos(x W^T + b)`` of the standardized parents with frozen
random ``rff_w`` ~ N(0, 1/lengthscale^2) and ``rff_b`` ~ U(0, 2 pi), drawn
from the fit's generator at ``init``; a closed-form ridge solve
``(Phi^T Phi + r I)^{-1} Phi^T y`` in standardized target units (with a
bias column when ``use_bias``); the residual variance floored at 1e-6 and
kept in the target's units. The params are float32, as the JAX package
keeps them. The features, the Gram matrix, the solve and the conditional
mean run in float64 on the params' device, where the JAX package computes
in float32: the same function, computed more accurately. At the default
ridge (1e-6) the Gram matrix is ill-conditioned and the coefficients reach
hundreds, so float32 features would carry their rounding, multiplied by
the coefficients, into the mean: ~1e-3 on the gauss8 network, and not the
same on the card as on the CPU. ``conditional_params`` is the protocol
``gaussian_exact``'s grid path and ``core/handle.py`` read.

``update`` refits on the new rows (the base class's default, as in the
JAX package), and so does ``update_program``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.base import BaseCPD, Params
from ..core.registry import register_cpd
from ..core.rng import normals
from ..ops.gauss import diag_gaussian_log_prob, standardize_stats
from ._train import as_rows

_ROWS = 1 << 20  # rows of float64 features at a time (2 GiB at 256)


@register_cpd("rff_gaussian")
class RFFGaussianCPD(BaseCPD):
    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        *,
        seed: Optional[int] = None,
        n_features: int = 256,
        lengthscale: float = 1.0,
        ridge: float = 1e-6,
        min_scale: float = 1e-3,
        use_bias: bool = True,
        **_ignored,
    ) -> None:
        super().__init__(input_dim, output_dim, seed=seed)
        if int(n_features) <= 0:
            raise ValueError("n_features must be >= 1")
        if float(lengthscale) <= 0:
            raise ValueError("lengthscale must be > 0")
        self.n_features = int(n_features)
        self.lengthscale = float(lengthscale)
        self.ridge = float(ridge)
        self.min_scale = float(min_scale)
        self.use_bias = bool(use_bias)

    def get_init_kwargs(self):
        return {
            "n_features": self.n_features,
            "lengthscale": self.lengthscale,
            "ridge": self.ridge,
            "min_scale": self.min_scale,
            "use_bias": self.use_bias,
        }

    def _static_fields(self) -> tuple:
        return (self.n_features, self.lengthscale, self.ridge,
                self.min_scale, self.use_bias)

    # -- lifecycle ----------------------------------------------------------
    def init(self, device, gen: Optional[torch.Generator] = None) -> Params:
        f, din, dout = self.n_features, self.input_dim, self.output_dim
        f32 = dict(dtype=torch.float32, device=device)
        if din == 0:
            rff_w = torch.zeros((f, 0), **f32)
            rff_b = torch.zeros((f,), **f32)
        else:
            rff_w = torch.randn((f, din), generator=gen, **f32) / max(
                self.lengthscale, 1e-6)
            rff_b = 2.0 * math.pi * torch.rand((f,), generator=gen, **f32)
        return {
            "rff_w": rff_w,
            "rff_b": rff_b,
            "coef": torch.zeros((f, dout), **f32),
            "bias": torch.zeros((dout,), **f32),
            "var": torch.ones((dout,), **f32),
            "stats": {
                "mean_x": torch.zeros((din,), **f32),
                "std_x": torch.ones((din,), **f32),
                "mean_y": torch.zeros((dout,), **f32),
                "std_y": torch.ones((dout,), **f32),
            },
        }

    def _features(self, params: Params, parents) -> torch.Tensor:
        """float64 features of raw parents [M, Din] (standardized here)."""
        stats = params["stats"]
        pn = ((parents - stats["mean_x"]) / stats["std_x"]).double()
        proj = pn @ params["rff_w"].double().T + params["rff_b"].double()
        return math.sqrt(2.0 / float(self.n_features)) * torch.cos(proj)

    def fit(self, params, parents, x, *, device, ridge=None, **_training):
        """Closed form; epochs/lr/batch_size are accepted and unused."""
        x = as_rows(x, self.output_dim, device)
        r = self.ridge if ridge is None else float(ridge)
        if r < 0:
            raise ValueError("ridge must be >= 0")
        mean_y, std_y = standardize_stats(x)
        if self.input_dim == 0:
            f32 = dict(dtype=torch.float32, device=x.device)
            return {
                **params,
                "coef": torch.zeros_like(params["coef"]),
                "bias": torch.zeros_like(params["bias"]),
                "var": torch.clamp(std_y**2, min=1e-6),
                "stats": {"mean_x": torch.zeros((0,), **f32),
                          "std_x": torch.ones((0,), **f32),
                          "mean_y": mean_y, "std_y": std_y},
            }
        p = as_rows(parents, self.input_dim, device)
        mean_x, std_x = standardize_stats(p)
        stats = {"mean_x": mean_x, "std_x": std_x,
                 "mean_y": mean_y, "std_y": std_y}
        xn = ((x - mean_y) / std_y).double()
        phi = self._features({**params, "stats": stats}, p)
        cols = [phi]
        if self.use_bias:
            cols.append(torch.ones((phi.shape[0], 1), dtype=phi.dtype,
                                   device=phi.device))
        phi_aug = torch.cat(cols, dim=1)
        gram = phi_aug.T @ phi_aug + r * torch.eye(
            phi_aug.shape[1], dtype=phi.dtype, device=phi.device)
        theta = torch.linalg.solve(gram, phi_aug.T @ xn)
        if self.use_bias:
            coef, bias = theta[:-1], theta[-1]
        else:
            coef = theta
            bias = torch.zeros((self.output_dim,), dtype=theta.dtype,
                               device=theta.device)
        residual = xn - (phi @ coef + bias)
        var_norm = torch.clamp(residual.var(dim=0, unbiased=False), min=1e-6)
        return {
            **params,
            "coef": coef.float(),
            "bias": bias.float(),
            "var": (var_norm * std_y.double() ** 2).float(),
            "stats": stats,
        }

    def update_program(self, conf):
        """The refit is a function of fixed-shape inputs."""
        conf = dict(conf)

        def fn(params, gen, parents, x, *, device):
            return self.fit(params, parents, x, device=device, **conf)

        return fn

    # -- flat primitives -----------------------------------------------------
    def _scale(self, params: Params) -> torch.Tensor:
        return torch.sqrt(torch.clamp(params["var"], min=self.min_scale**2))

    def conditional_params(self, params: Params, parents):
        """(loc, scale), each [M, Dout], given flat parents [M, Din] (None
        for a root: M = 1)."""
        stats = params["stats"]
        if self.input_dim == 0:
            m = 1 if parents is None else parents.shape[0]
            loc = stats["mean_y"].expand(m, self.output_dim)
        else:
            coef, bias = params["coef"].double(), params["bias"].double()
            sy, my = stats["std_y"].double(), stats["mean_y"].double()
            loc = torch.cat([
                ((self._features(params, parents[i : i + _ROWS]) @ coef + bias)
                 * sy + my).float()
                for i in range(0, parents.shape[0], _ROWS)
            ])
        return loc, self._scale(params).expand_as(loc)

    def _sample_flat(self, params, gen, parents, m):
        loc, scale = self.conditional_params(params, parents)
        loc = loc.expand(m, self.output_dim)
        eps = normals(gen, m, self.output_dim, loc.device, dtype=loc.dtype)
        return loc + eps * scale.expand(m, self.output_dim)

    def _draws(self):
        return ((self.output_dim, 0, True),)

    def _log_prob_flat(self, params, x, parents):
        loc, scale = self.conditional_params(params, parents)
        return diag_gaussian_log_prob(x, loc.expand_as(x), scale.expand_as(x))
