"""Amortized posterior inference: one feed-forward pass per query batch.

Port of ``vectorizedbayesiannetwork_tpu/inference/amortized.py``, the
serving side of ``learning/amortized.py``: when the model was fitted with
the ``amortized`` learning method, ``p(target | evidence)`` is one batched
MLP forward, with no sweep and no particles. A query the net cannot serve
goes to the fallback method, with the JAX package's reasons: no trained
net, a do-intervention on a net trained observationally, a fixed target.

A continuous target returns ``n_samples`` draws from the predicted
Gaussian with their pdf, ``(pdf [B, S], samples [B, S, D])``; a
categorical target the exact predicted pmf, ``(probs [B, K], support
[B, K, 1])``. ``infer_posterior_many`` answers its queries one after the
other (``_base.Method``).
"""

from __future__ import annotations

import torch

from ..core.base import Query
from ..core.plan import pack_fixed_values
from ..core.registry import register_inference
from ..core.rng import RowStream
from ..learning.amortized import amortized_forward, node_distribution
from ..ops.gauss import LOG_2PI
from ._base import Method, Program
from .gaussian_exact import make_fallback


def _float64(tree):
    """A params tree with every tensor in float64."""
    if isinstance(tree, dict):
        return {k: _float64(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_float64(v) for v in tree)
    return tree.double() if isinstance(tree, torch.Tensor) else tree


@register_inference("amortized")
class AmortizedInference(Method):
    def __init__(
        self,
        n_samples: int = 200,
        fallback: str = "likelihood_weighting",
        **kwargs,
    ) -> None:
        self.n_samples = int(n_samples)
        fb_kwargs = dict(kwargs)
        fb_kwargs.setdefault("n_samples", self.n_samples)
        self._fallback = make_fallback(fallback, "amortized", fb_kwargs)
        self._last_fallback = False
        self._last_reason = None

    def _fall_back(self, vbn, query: Query, s: int, reason: str):
        self._last_fallback = True
        self._last_reason = reason
        if self._fallback is None:
            raise RuntimeError(f"amortized inference unavailable: {reason}")
        return self._fallback.make_program(vbn, query, n_samples=s)

    def make_program(self, vbn, query: Query, **kwargs):
        s = int(kwargs.get("n_samples", self.n_samples))
        plan, b = self._plan_and_batch(vbn, query)
        am = getattr(vbn, "amortized", None)
        if am is None:
            return self._fall_back(
                vbn, query, s,
                "model has no amortized net (fit with the 'amortized' "
                "learning method)",
            )
        spec = am["spec"]
        if query.do and not spec.interventional:
            return self._fall_back(
                vbn, query, s,
                "do-interventions change the joint and this amortizer "
                "was trained observationally (fit with "
                "interventional=True to amortize do-queries)",
            )
        t = plan.target_idx
        if plan.evidence_mask[t] or plan.do_mask[t]:
            return self._fall_back(vbn, query, s, "target is fixed")
        self._last_fallback = False
        self._last_reason = None

        fixed = pack_fixed_values(query, plan, b, clamp_obs=True)
        # the visible-value mask covers evidence and do'd nodes; the do
        # channel tells an interventional net which of them not to explain
        mask_row = [1.0 if plan.is_fixed(i) else 0.0
                    for i in range(plan.n_nodes)]
        do_row = [1.0 if plan.do_mask[i] else 0.0 for i in range(plan.n_nodes)]
        d = plan.node_dims[t]
        categorical = spec.kinds[t] == "categorical"

        def fn(net, draw, fixed_vals):
            bb, dev = fixed_vals.shape[0], fixed_vals.device
            mask = torch.tensor(mask_row, device=dev).expand(bb, -1)
            do_mask = torch.tensor(do_row, device=dev).expand(bb, -1)
            # the trunk in float64, rounded once: a float32 GEMM of one
            # row rounds apart from one of several, and a row's answer
            # must not depend on its batch
            heads = amortized_forward(
                spec, _float64(net), fixed_vals.double(), mask.double(),
                do_mask.double()).float()
            if categorical:
                probs, values = node_distribution(spec, net, heads, t)
                k = spec.n_classes[t]
                return probs, values[None, :, None].expand(bb, k, 1)
            loc, scale = node_distribution(spec, net, heads, t)
            eps = RowStream(draw, bb, s).normal(t, d).reshape(bb, s, d)
            x = loc[:, None, :] + eps * scale[:, None, :]
            z = (x - loc[:, None, :]) / scale[:, None, :]
            lp = -0.5 * torch.sum(
                z * z + 2.0 * torch.log(scale)[:, None, :] + LOG_2PI, dim=-1)
            return torch.exp(lp), x

        return Program(plan, fn, am["net"], fixed, lambda outs: outs)

    def infer_posterior(self, vbn, query: Query, **kwargs):
        prog = self.make_program(vbn, query, **kwargs)
        if prog is None:
            # the fallback has no program (an exact engine): call it
            s = int(kwargs.get("n_samples", self.n_samples))
            return self._fallback.infer_posterior(vbn, query, n_samples=s)
        return self._run_program(vbn, prog)
