"""Exact Gaussian posteriors.

Port of ``vectorizedbayesiannetwork_tpu/inference/gaussian_exact.py``.
Per query (``infer_posterior``): when the target is a scalar Gaussian-
family CPD (it exposes ``conditional_params`` and neither a mixture nor a
categorical head) with every parent observed, the exact pdf on the grid
``loc +- stddevs * scale`` (``n_samples`` points); a clamped target is its
value with weight 1; anything else goes to the fallback method from the
registry. Fused moments (``infer_posterior_moments``): when every node is a
scalar linear-Gaussian CPD, one closed-form conditioning function
(``_lg_exact.py``) answers every evidence / do / target skeleton exactly,
latent parents included; otherwise None (the caller reduces the per-query
stream).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.base import Query
from ..core.plan import pack_fixed_values
from ..core.registry import INFERENCE_REGISTRY, register_inference
from ..ops.gauss import LOG_2PI
from ._base import Method


def make_fallback(name: str, self_name: str, kwargs):
    name = str(name).strip().lower() if name is not None else "none"
    if name == "none":
        return None
    if name not in INFERENCE_REGISTRY:
        raise ValueError(
            f"Unknown fallback inference {name!r}. "
            f"Available: {sorted(INFERENCE_REGISTRY)}"
        )
    if name == self_name:
        raise ValueError(f"fallback cannot be {self_name!r}")
    return INFERENCE_REGISTRY[name](**kwargs)


def is_gaussian_family(cpd) -> bool:
    return (
        hasattr(cpd, "conditional_params")
        and not hasattr(cpd, "mixture_params")
        and not hasattr(cpd, "categorical_probs")
    )


def parent_columns(plan, t: int, fixed: torch.Tensor) -> Optional[torch.Tensor]:
    """Node t's parents' clamped values [B, Din] from packed rows, or None."""
    cols = [fixed[:, plan.node_offsets[p] : plan.node_offsets[p]
                  + plan.node_dims[p]] for p in plan.parent_idx[t]]
    return torch.cat(cols, dim=-1) if cols else None


class ExactMethod(Method):
    """Shared by the exact engines: the fallback method and its flag."""

    _name = "?"

    def _fallback_infer(self, vbn, query, **kwargs):
        self._last_fallback = True
        if self._fallback is None:
            raise RuntimeError(
                f"{self._name} cannot handle this query and has no fallback"
            )
        return self._fallback.infer_posterior(vbn, query, **kwargs)

    def _canonical(self, vbn):
        """The network-wide plan (masks and target are inputs) and CPDs."""
        topo = tuple(vbn.dag.topological_order())
        plan, _ = self._plan_and_batch(
            vbn, Query(target=topo[0], evidence={}, do={}))
        return plan, self._cpds(vbn, plan)

    @staticmethod
    def _tensors(vbn, inputs):
        return tuple(torch.as_tensor(a, device=vbn.device) for a in inputs)


@register_inference("gaussian_exact")
class GaussianExact(ExactMethod):
    _name = "gaussian_exact"

    def __init__(
        self,
        n_samples: int = 200,
        stddevs: float = 4.0,
        min_scale: float = 1e-6,
        fallback: str = "likelihood_weighting",
        **kwargs,
    ) -> None:
        self.n_samples = int(n_samples)
        self.stddevs = float(stddevs)
        self.min_scale = float(min_scale)
        fb_kwargs = dict(kwargs)
        fb_kwargs.setdefault("n_samples", self.n_samples)
        self._fallback = make_fallback(fallback, "gaussian_exact", fb_kwargs)
        self._last_fallback = False

    def infer_posterior_moments(
        self, vbn, queries, *, pad_bucket: int = 1, **kwargs
    ) -> Optional[Tuple[np.ndarray, List[Tuple[int, int, int]]]]:
        """Exact (mean, std) rows for any mix of Gaussian queries in one
        dispatch, or None when some CPD is not linear-Gaussian."""
        from ._dynamic_base import pack_dynamic_inputs
        from ._lg_exact import lg_exact_supported, make_lg_exact_fn

        plan, cpds = self._canonical(vbn)
        if not lg_exact_supported(plan, cpds):
            return None
        inputs, spans, b_tot, _ = pack_dynamic_inputs(
            plan, queries, clamp_obs=True, pad_to=pad_bucket)
        fn = self._built(vbn, plan, ("lg_exact",),
                         lambda: make_lg_exact_fn(plan, cpds))
        (rows,) = fn(self._params_tuple(vbn, plan), self._tensors(vbn, inputs))
        self._last_fallback = False
        return rows.cpu().numpy()[:b_tot], spans

    def infer_posterior(self, vbn, query: Query, **kwargs):
        self._last_fallback = False
        s = max(1, int(kwargs.get("n_samples", self.n_samples)))
        plan, b = self._plan_and_batch(vbn, query)
        t = plan.target_idx
        cpd = self._cpds(vbn, plan)[t]
        if plan.node_dims[t] != 1:
            return self._fallback_infer(vbn, query, **kwargs)
        fixed = torch.as_tensor(
            pack_fixed_values(query, plan, b, clamp_obs=True),
            device=vbn.device)
        t_off = plan.node_offsets[t]
        if plan.is_fixed(t):
            return (torch.ones((b, 1), device=vbn.device),
                    fixed[:, None, t_off : t_off + 1])
        if not all(plan.is_fixed(p) for p in plan.parent_idx[t]):
            return self._fallback_infer(vbn, query, **kwargs)
        if not is_gaussian_family(cpd):
            return self._fallback_infer(vbn, query, **kwargs)
        loc, scale = cpd.conditional_params(vbn.params[plan.topo_order[t]],
                                            parent_columns(plan, t, fixed))
        loc = loc.reshape(-1, 1)[:b].expand(b, 1)
        scale = torch.nan_to_num(
            scale.reshape(-1, 1)[:b].expand(b, 1), nan=self.min_scale,
            posinf=self.min_scale, neginf=self.min_scale)
        scale = torch.clamp(scale.abs(), min=self.min_scale)
        z = torch.linspace(-self.stddevs, self.stddevs, s,
                           device=vbn.device)[None, :, None]
        samples = loc[:, None, :] + scale[:, None, :] * z
        log_pdf = -0.5 * (z[..., 0] ** 2 + 2.0 * torch.log(scale) + LOG_2PI)
        return torch.exp(log_pdf), samples
