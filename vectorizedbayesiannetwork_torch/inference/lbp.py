"""Damped weight smoothing over an importance-sampling run ("lbp").

Port of ``vectorizedbayesiannetwork_tpu/inference/lbp.py``: the base method
(importance sampling, or Monte-Carlo marginalization with its pdf
normalized to weights), then at most ``n_iters`` damped renormalizations of
the particle weights while the largest change over the whole batch is at
least ``tol``; when the smoothing stops short of ``tol``, the answer is a
fresh importance-sampling run. The base run draws from ``fold(draw, 0)``
and the fallback from ``fold(draw, 1)``. As in the JAX package this
smooths particle weights; it passes no messages.

The JAX package runs the loop as a ``lax.while_loop`` and the fallback as
a ``lax.cond`` inside one program. Here the loop is eager and reads the
device once a step, for that step's ``delta`` (``smooth_weights``); the
last read also decides the fallback. Normalized base weights change by
float rounding only, so the first step converges and the call reads once.
``_last_iters`` and ``_last_fallback`` record the last call.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..core.base import Query
from ..core.registry import register_inference
from ..core.rng import fold
from ._base import Method, Program
from .importance_sampling import ImportanceSampling
from .monte_carlo_marginalization import MonteCarloMarginalization

_EPS = 1e-12


def smooth_weights(
    weights: torch.Tensor, n_iters: int, damping: float, tol: float
) -> Tuple[torch.Tensor, bool, int]:
    """The damped smoothing of weights [B, S]: (weights, whether the last
    step's max |change| over the batch fell below ``tol``, steps run). The
    change starts at inf, so ``n_iters = 0`` never converges."""
    tol32 = float(np.float32(tol))  # JAX compares in float32
    w, delta, steps = weights, math.inf, 0
    while steps < n_iters and delta >= tol32:
        w_new = torch.clamp(w, min=_EPS)
        w_new = w_new / (w_new.sum(dim=-1, keepdim=True) + _EPS)
        msg = damping * w_new + (1.0 - damping) * w
        msg = msg / (msg.sum(dim=-1, keepdim=True) + _EPS)
        delta = float(torch.max(torch.abs(msg - w)))  # the step's one read
        w, steps = msg, steps + 1
    return w, delta < tol32, steps


@register_inference("lbp")
class LoopyBeliefPropagation(Method):
    def __init__(
        self,
        n_samples: int = 200,
        n_iters: int = 10,
        damping: float = 0.5,
        fallback: str = "importance_sampling",
        **_kwargs,
    ) -> None:
        self.n_samples = int(n_samples)
        self.n_iters = int(n_iters)
        self.damping = float(damping)
        self.fallback = str(fallback)
        if not (0.0 <= self.damping <= 1.0):
            raise ValueError("damping must be in [0,1]")
        if self.fallback not in {
            "importance_sampling",
            "monte_carlo_marginalization",
        }:
            raise ValueError(
                "fallback must be 'importance_sampling' or "
                "'monte_carlo_marginalization'"
            )
        self._is = ImportanceSampling(n_samples=self.n_samples)
        self._mcm = MonteCarloMarginalization(n_samples=self.n_samples)
        self._last_iters = 0
        self._last_fallback = False

    def make_program(self, vbn, query: Query, **kwargs):
        n_samples = int(kwargs.get("n_samples", self.n_samples))
        n_iters = int(kwargs.get("n_iters", self.n_iters))
        damping = float(kwargs.get("damping", self.damping))
        tol = float(kwargs.get("tol", 1e-4))
        use_mcm = self.fallback == "monte_carlo_marginalization"
        base_prog = (self._mcm if use_mcm else self._is).make_program(
            vbn, query, n_samples=n_samples
        )
        # the fallback is a fresh IS run on the same plan, params and rows
        is_prog = (
            self._is.make_program(vbn, query, n_samples=n_samples)
            if use_mcm
            else base_prog
        )
        base_fn, is_fn = base_prog.fn, is_prog.fn

        def fn(params_tuple, draw, fixed):
            outs = base_fn(params_tuple, fold(draw, 0), fixed)
            if use_mcm:
                pdf, samples = outs
                weights = pdf / (pdf.sum(dim=-1, keepdim=True) + _EPS)
            else:  # IS's raw (weights, target values, ESS, collapse)
                weights, samples = outs[0], outs[1]
            w, converged, steps = smooth_weights(weights, n_iters, damping,
                                                 tol)
            if converged:
                return w, samples, steps, False
            o = is_fn(params_tuple, fold(draw, 1), fixed)
            return o[0], o[1], steps, True

        def post(outs):
            self._last_iters, self._last_fallback = outs[2], outs[3]
            return outs[0], outs[1]

        return Program(base_prog.plan, fn, base_prog.params, base_prog.fixed,
                       post)

    def infer_posterior(self, vbn, query: Query, **kwargs):
        return self._run_program(vbn, self.make_program(vbn, query, **kwargs))
