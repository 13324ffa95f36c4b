"""Monte-Carlo marginalization posterior inference.

Port of
``vectorizedbayesiannetwork_tpu/inference/monte_carlo_marginalization.py``:
a do(target) delta fast path, a direct-CPD fast path when all of the
target's parents are fixed, otherwise a full ancestral sweep (the unrolled
or scan kernel where the gates allow, else torch ops);
pdf = exp(target log-density). Evidence and do both clamp, unweighted.
With ``dynamic_masks=True`` every query rides the mask-dynamic sweep; the
do(target) delta holds per row (pdf 1 at the intervened value) and the
direct path runs as the general sweep (same distribution: the clamped
ancestors make it exact).
"""

from __future__ import annotations

import torch

from ..core.base import Query
from ..core.plan import pack_fixed_values
from ..core.registry import register_inference
from ..core.rng import RowStream
from ._base import Program
from ._dynamic_base import DynamicMaskMethod
from ._dynamic_sweep import dynamic_sweep_trace
from ._sweep import node_values, sweep_trace, target_log_prob
from .likelihood_weighting import LikelihoodWeighting


@register_inference("monte_carlo_marginalization")
class MonteCarloMarginalization(DynamicMaskMethod):
    pack_clamp_obs = False
    _static_red_src = "lpt"

    def __init__(
        self, n_samples: int = 200, dynamic_masks: bool = False, **_kwargs
    ) -> None:
        super().__init__(dynamic_masks)
        self.n_samples = int(n_samples)

    def _dynamic_fn(self, plan, cpds, s, opts, mesh=None):
        raw = self._fused_dyn_raw(plan, cpds, s, ("lpt", "tgt"), mesh)

        def fn(params_tuple, draw, tensors):
            fixed_vals, evm, dom, ti = tensors
            # evidence AND do both clamp, through the do bit; nothing weights
            fx = torch.maximum(evm, dom)
            no_weight = torch.zeros_like(evm)
            do_t = dom.gather(1, ti.long()[:, None])[:, 0]  # [B]
            if raw is not None:
                _, tv, lp_t, _ = raw(
                    params_tuple, draw.seed, fixed_vals, no_weight, fx, ti
                )
                samples = tv[:, :, None]
            else:
                tgt = torch.nn.functional.one_hot(
                    ti.long(), plan.n_nodes
                ).to(torch.float32)
                samples, _, lp_t = dynamic_sweep_trace(
                    plan, cpds, params_tuple, draw, fixed_vals,
                    no_weight, fx, s, tgt_mask=tgt, mesh=mesh, targets=ti,
                )
            # do(target) rows: a delta at the intervened value (the sweep
            # already clamped the samples; pdf := 1)
            pdf = torch.where(do_t[:, None] > 0, 1.0, torch.exp(lp_t))
            return pdf, samples

        return fn

    def make_program(self, vbn, query: Query, **kwargs):
        s = int(kwargs.get("n_samples", self.n_samples))
        if self._dynamic_enabled(kwargs):
            return self._make_dynamic_program(vbn, query, s, ())
        plan, b = self._plan_and_batch(vbn, query)
        fixed = pack_fixed_values(query, plan, b)
        t = plan.target_idx
        t_off, t_dim = plan.node_offsets[t], plan.node_dims[t]
        cpds = self._cpds(vbn, plan)
        params = self._params_tuple(vbn, plan)
        post = lambda outs: outs  # noqa: E731

        if plan.do_mask[t]:
            # do(target) => degenerate delta at the intervened value.
            def fn_delta(params_tuple, draw, fixed_vals):
                bb = fixed_vals.shape[0]
                value = fixed_vals[:, None, t_off : t_off + t_dim].expand(
                    bb, s, t_dim
                )
                return torch.ones((bb, s), device=fixed_vals.device), value

            return Program(plan, fn_delta, params, fixed, post)

        if all(plan.is_fixed(p) for p in plan.parent_idx[t]):
            # Direct CPD evaluation: no ancestor sampling needed.
            def fn_direct(params_tuple, draw, fixed_vals):
                bb = fixed_vals.shape[0]
                pidx = plan.parent_idx[t]
                pflat = None
                if pidx:
                    cols = [
                        fixed_vals[
                            :,
                            plan.node_offsets[p] : plan.node_offsets[p]
                            + plan.node_dims[p],
                        ]
                        for p in pidx
                    ]
                    pflat = torch.repeat_interleave(
                        torch.cat(cols, dim=-1), s, dim=0
                    )
                if plan.evidence_mask[t]:
                    x = fixed_vals[:, None, t_off : t_off + t_dim].expand(
                        bb, s, t_dim
                    )
                else:
                    # the target's own node word past the sweep's, so the
                    # draw never repeats a sweep's draw of t
                    src = RowStream(draw, bb, s).node(plan.n_nodes + t)
                    x = cpds[t]._sample_flat(
                        params_tuple[t], src, pflat, bb * s
                    ).reshape(bb, s, t_dim)
                lp = cpds[t]._log_prob_flat(
                    params_tuple[t], x.reshape(bb * s, t_dim), pflat
                ).reshape(bb, s)
                return torch.exp(lp), x

            return Program(plan, fn_direct, params, fixed, post)

        raw = LikelihoodWeighting._fused_raw_fn(plan, cpds, s, want=("lpt",),
                                                mesh=vbn._mesh)
        if raw is not None:
            def fn(params_tuple, draw, fixed_vals):
                _logw, tgt, lpt, _red = raw(params_tuple, draw.seed, fixed_vals)
                return torch.exp(lpt), tgt[:, :, None]
        else:
            def fn(params_tuple, draw, fixed_vals):
                packed, _ = sweep_trace(
                    plan, cpds, params_tuple, draw, fixed_vals, s,
                    mesh=vbn._mesh,
                )
                lp = target_log_prob(plan, cpds, params_tuple, packed)
                return torch.exp(lp), node_values(plan, packed, t)

        return Program(plan, fn, params, fixed, post)

    def infer_posterior(self, vbn, query: Query, **kwargs):
        return self._run_program(vbn, self.make_program(vbn, query, **kwargs))
