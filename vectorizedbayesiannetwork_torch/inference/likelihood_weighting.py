"""Likelihood weighting: prior-proposal sweep with evidence log-weights.

Port of ``vectorizedbayesiannetwork_tpu/inference/likelihood_weighting.py``
(static plans): evidence nodes are clamped (NaN/inf sanitized at pack
time) and add ``log p(value | parents)`` to the particle weights;
``normalize=False`` returns max-shifted unnormalized weights.
All-categorical and all-linear-Gaussian plans take the fused sweep kernel;
others take the torch-op sweep.
"""

from __future__ import annotations

import torch

from ..core.base import Query
from ..core.plan import pack_fixed_values
from ..core.registry import register_inference
from ..ops.sweep import make_fused_sweep_fn
from ._base import Program
from ._dynamic_base import DynamicMaskMethod
from ._sweep import node_values, sweep_trace


@register_inference("likelihood_weighting")
class LikelihoodWeighting(DynamicMaskMethod):
    pack_clamp_obs = True
    _static_red_src = "logw"

    def __init__(
        self,
        n_samples: int = 200,
        eps: float = 1e-12,
        normalize: bool = True,
        dynamic_masks: bool = False,
        **_kwargs,
    ) -> None:
        super().__init__(dynamic_masks)
        self.n_samples = int(n_samples)
        self.eps = float(eps)
        self.normalize = bool(normalize)
        self._last_ess = None

    def _weights_from_logw(self, log_w, normalize):
        weights = torch.exp(log_w - log_w.max(dim=1, keepdim=True).values)
        total = torch.clamp(weights.sum(dim=1, keepdim=True), min=self.eps)
        ess = 1.0 / torch.clamp(
            ((weights / total) ** 2).sum(dim=1), min=self.eps
        )
        if normalize:
            weights = weights / total
        return weights, ess

    def make_program(self, vbn, query: Query, **kwargs):
        self._check_static(kwargs)
        s = int(kwargs.get("n_samples", self.n_samples))
        normalize = bool(kwargs.get("normalize", self.normalize))
        plan, b = self._plan_and_batch(vbn, query)
        fixed = pack_fixed_values(query, plan, b, clamp_obs=True)
        cpds = self._cpds(vbn, plan)
        t = plan.target_idx
        raw = make_fused_sweep_fn(plan, cpds, s, want=("logw",))
        if raw is not None:
            def fn(params_tuple, draw, fixed_vals):
                log_w, tgt, _lpt, _red = raw(params_tuple, draw.seed, fixed_vals)
                weights, ess = self._weights_from_logw(log_w, normalize)
                return weights, tgt[:, :, None], ess
        else:
            def fn(params_tuple, draw, fixed_vals):
                packed, log_w = sweep_trace(
                    plan, cpds, params_tuple, draw.generator, fixed_vals, s,
                    weighted=True,
                )
                weights, ess = self._weights_from_logw(log_w, normalize)
                return weights, node_values(plan, packed, t), ess

        def post(outs):
            weights, samples, ess = outs
            self._last_ess = ess
            return weights, samples

        return Program(plan, fn, self._params_tuple(vbn, plan), fixed, post)

    def infer_posterior(self, vbn, query: Query, **kwargs):
        return self._run_program(vbn, self.make_program(vbn, query, **kwargs))
