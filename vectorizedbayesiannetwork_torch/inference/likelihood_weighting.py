"""Likelihood weighting: prior-proposal sweep with evidence log-weights.

Port of ``vectorizedbayesiannetwork_tpu/inference/likelihood_weighting.py``:
evidence nodes are clamped (NaN/inf sanitized at pack time) and add
``log p(value | parents)`` to the particle weights; ``normalize=False``
returns max-shifted unnormalized weights. All-categorical and
all-linear-Gaussian static plans take the unrolled sweep kernel
(``ops/sweep.py``) up to 80 nodes and the scan kernel
(``ops/sweep_scan.py``) beyond; ``dynamic_masks=True`` serves every query
shape through the scan kernel. Other plans take the torch-op sweeps.
"""

from __future__ import annotations

import torch

from ..core.base import Query
from ..core.plan import pack_fixed_values
from ..core.registry import register_inference
from ..ops.sweep import make_fused_sweep_fn
from ..ops.sweep_scan import make_scan_sweep_fn, scan_sweep_reason
from ._base import Program
from ._dynamic_base import DynamicMaskMethod
from ._dynamic_sweep import dynamic_sweep_trace, dynamic_target_values
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

    @staticmethod
    def _fused_raw_fn(plan, cpds, s, want=("logw",)):
        """``raw(params_tuple, seed, fixed) -> (logw, tgt, lpt, red)`` for a
        static plan: the unrolled kernel within its node budget, beyond it
        the scan kernel with the plan's masks tiled as runtime rows; None
        when neither applies."""
        raw = make_fused_sweep_fn(plan, cpds, s, want=want)
        if raw is not None:
            return raw
        scan_raw = make_scan_sweep_fn(plan, cpds, s, want=want)
        if scan_raw is None:
            return None
        ev = torch.tensor(plan.evidence_mask, dtype=torch.float32)
        do = torch.tensor(plan.do_mask, dtype=torch.float32)

        def raw_static(params_tuple, seed, fixed_vals):
            b, dev = fixed_vals.shape[0], fixed_vals.device
            tib = torch.full((b,), plan.target_idx, dtype=torch.int32,
                             device=dev)
            return scan_raw(
                params_tuple, seed, fixed_vals,
                ev.to(dev).expand(b, -1), do.to(dev).expand(b, -1), tib,
            )

        return raw_static

    def _dynamic_opts(self, kwargs):
        return (bool(kwargs.get("normalize", self.normalize)),)

    def _dyn_red_raw(self, plan, cpds, s, opts, kind):
        """LW's weights are a function of the evidence log-weights alone,
        so the scan kernel's ``pmf_logw`` / ``mom_logw`` reductions serve
        the pmf and moments rows directly (the normalized histogram of
        exp(logw - max) is the softmax-weighted one; the moments' shift
        cancels). pmf needs the categorical kernel."""
        if kind == "pmf" and scan_sweep_reason(plan, cpds, s) is not None:
            return None
        return self._fused_dyn_raw(plan, cpds, s, (f"{kind}_logw",))

    def _dynamic_fn(self, plan, cpds, s, opts):
        """The mask-dynamic program body (single and row-fused paths): the
        scan kernel where its gates admit the plan, else the torch-op
        dynamic sweep."""
        (normalize,) = opts
        raw = self._fused_dyn_raw(plan, cpds, s, ("logw", "tgt"))

        def fn(params_tuple, draw, tensors):
            fixed_vals, evm, dom, ti = tensors
            if raw is not None:
                log_w, tgt, _, _ = raw(
                    params_tuple, draw.seed, fixed_vals, evm, dom, ti
                )
                weights, ess = self._weights_from_logw(log_w, normalize)
                return weights, tgt[:, :, None], ess
            packed, log_w = dynamic_sweep_trace(
                plan, cpds, params_tuple, draw.generator, fixed_vals, evm,
                dom, s,
            )
            weights, ess = self._weights_from_logw(log_w, normalize)
            return weights, dynamic_target_values(plan, packed, ti), ess

        return fn

    def _note_dynamic_aux(self, aux, sl):
        self._last_ess = aux[0][sl]

    def make_program(self, vbn, query: Query, **kwargs):
        s = int(kwargs.get("n_samples", self.n_samples))
        if self._dynamic_enabled(kwargs):
            return self._make_dynamic_program(
                vbn, query, s, self._dynamic_opts(kwargs)
            )
        normalize = bool(kwargs.get("normalize", self.normalize))
        plan, b = self._plan_and_batch(vbn, query)
        fixed = pack_fixed_values(query, plan, b, clamp_obs=True)
        cpds = self._cpds(vbn, plan)
        t = plan.target_idx
        raw = self._fused_raw_fn(plan, cpds, s, want=("logw",))
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
