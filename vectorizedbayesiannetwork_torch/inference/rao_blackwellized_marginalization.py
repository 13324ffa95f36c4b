"""Rao-Blackwellized marginalization: sample the ancestors, marginalize the
target analytically.

Port of
``vectorizedbayesiannetwork_tpu/inference/rao_blackwellized_marginalization.py``:

- a target with an observed or intervened descendant is refused and goes
  to the fallback method, recording ``_last_fallback`` / ``_last_reason``;
- every other node except the target and its descendants is swept as
  evidence-weighted particles (``_sweep.sweep_trace(skip=...)``);
- a categorical target (``categorical_probs``) gets the weighted mixture
  of its conditional pmfs over the class support;
- a scalar Gaussian-family target (``conditional_params``) gets the
  moment-matched mixture evaluated on the grid ``mean +- stddevs * std``
  (``n_samples`` points);
- any other target (KDE, ``mdn``) goes to the fallback.

The JAX package compiles each branch once; here they run eagerly on the
VBN's device with no read of the device, the Gaussian grid a block of
particles at a time (a [B, S_part, S_out] intermediate of the JAX program is
4.3 GB at B=8, 2^18 particles and 512 grid points).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.base import Query
from ..core.plan import pack_fixed_values
from ..core.registry import register_inference
from ..ops.gauss import LOG_2PI
from ._base import Method
from ._sweep import sweep_trace, target_parents_flat
from .gaussian_exact import is_gaussian_family, make_fallback

_BLOCK = 1 << 26


def _normalized_weights(log_w: torch.Tensor, eps: float = 1e-12):
    """Softmax of log weights [B, S] over particles, uniform where a row's
    weights vanish."""
    log_w = torch.nan_to_num(log_w, nan=-1e30, posinf=1e30, neginf=-1e30)
    w = torch.exp(log_w - log_w.max(dim=1, keepdim=True).values)
    denom = w.sum(dim=1, keepdim=True)
    uniform = torch.full_like(w, 1.0 / max(1, w.shape[1]))
    return torch.where(denom > eps, w / torch.clamp(denom, min=eps), uniform)


def _per_particle(v: torch.Tensor, b: int, s: int, c: int = 1):
    """[B*S, c] (or [1, c] for a root) -> [B, S, c]."""
    v = v.reshape(-1, c)
    if v.shape[0] == 1:
        return v[None].expand(b, s, c)
    return v.reshape(b, s, c)


@register_inference("rao_blackwellized_marginalization")
class RaoBlackwellizedMarginalization(Method):
    def __init__(
        self,
        n_samples: int = 200,
        n_particles: Optional[int] = None,
        stddevs: float = 4.0,
        min_scale: float = 1e-6,
        fallback: str = "likelihood_weighting",
        **kwargs,
    ) -> None:
        self.n_samples = int(n_samples)
        self.n_particles = (
            int(n_particles) if n_particles is not None else self.n_samples
        )
        self.stddevs = float(stddevs)
        self.min_scale = float(min_scale)
        fb_kwargs = dict(kwargs)
        fb_kwargs.setdefault("n_samples", self.n_samples)
        self._fallback = make_fallback(
            fallback, "rao_blackwellized_marginalization", fb_kwargs
        )
        self._last_fallback = False
        self._last_reason: Optional[str] = None

    def _fallback_infer(self, vbn, query, *, reason: str, **kwargs):
        self._last_fallback = True
        self._last_reason = reason
        if self._fallback is None:
            raise RuntimeError(
                "rao_blackwellized_marginalization cannot handle this query "
                "and has no fallback"
            )
        return self._fallback.infer_posterior(vbn, query, **kwargs)

    def infer_posterior(self, vbn, query: Query, **kwargs):
        self._last_fallback = False
        self._last_reason = None
        s_out = max(1, int(kwargs.get("n_samples", self.n_samples)))
        s_part = max(1, int(kwargs.get("n_particles", self.n_particles)))
        plan, b = self._plan_and_batch(vbn, query)
        t = plan.target_idx
        node_to_idx = plan.node_to_idx()
        descendants = {
            node_to_idx[n] for n in vbn.dag.descendants(plan.topo_order[t])
        }
        if any(plan.is_fixed(i) for i in descendants):
            return self._fallback_infer(
                vbn, query,
                reason="target has observed/intervened descendants", **kwargs,
            )
        fixed = torch.as_tensor(
            pack_fixed_values(query, plan, b, clamp_obs=True),
            device=vbn.device)
        t_off = plan.node_offsets[t]
        if plan.is_fixed(t):
            value = fixed[:, None, t_off : t_off + plan.node_dims[t]]
            return torch.ones((b, 1), device=vbn.device), value

        cpds = self._cpds(vbn, plan)
        target_cpd = cpds[t]
        is_cat = hasattr(target_cpd, "categorical_probs")
        is_gauss = is_gaussian_family(target_cpd) and plan.node_dims[t] == 1
        if not (is_cat or is_gauss):
            return self._fallback_infer(
                vbn, query,
                reason="unsupported target CPD for RB marginalization",
                **kwargs,
            )
        params_tuple = self._params_tuple(vbn, plan)
        packed, log_w = sweep_trace(
            plan, cpds, params_tuple, vbn.next_key(), fixed, s_part,
            weighted=True, skip=frozenset(descendants | {t}), mesh=vbn._mesh,
        )
        weights = _normalized_weights(log_w)  # [B, S_part]
        pflat = target_parents_flat(plan, packed, t)
        if is_cat:
            probs = target_cpd.categorical_probs(params_tuple[t], pflat)
            c = probs.shape[-1]
            probs = _per_particle(probs, b, s_part, c)
            marginal = torch.sum(weights[..., None] * probs, dim=1)
            if hasattr(target_cpd, "support_values"):
                support = target_cpd.support_values(params_tuple[t])[0]
            else:
                support = torch.arange(c, dtype=torch.float32,
                                       device=vbn.device)
            return marginal, support[None, :, None].expand(b, c, 1)

        loc, scale = target_cpd.conditional_params(params_tuple[t], pflat)
        loc = _per_particle(loc, b, s_part)[..., 0]
        scale = _per_particle(scale, b, s_part)[..., 0]
        scale = torch.clamp(torch.abs(torch.nan_to_num(
            scale, nan=self.min_scale, posinf=self.min_scale,
            neginf=self.min_scale)), min=self.min_scale)
        mix_mean = torch.sum(weights * loc, dim=1)
        second = torch.sum(weights * (scale**2 + loc**2), dim=1)
        mix_std = torch.sqrt(torch.clamp(second - mix_mean**2,
                                         min=self.min_scale**2))
        z = torch.linspace(0.0, 1.0, s_out, device=vbn.device)[None, :]
        lo = (mix_mean - self.stddevs * mix_std)[:, None]
        hi = (mix_mean + self.stddevs * mix_std)[:, None]
        grid = lo + (hi - lo) * z  # [B, S_out]
        # the mixture on the grid, a block of particles at a time: at most
        # _BLOCK elements of [B, block, S_out] live at once
        pdf = torch.zeros_like(grid)
        step = max(1, _BLOCK // (b * s_out))
        for j in range(0, s_part, step):
            ls, ss = loc[:, j : j + step, None], scale[:, j : j + step, None]
            zn = (grid[:, None, :] - ls) / ss
            log_comp = -0.5 * (zn**2 + LOG_2PI) - torch.log(ss)
            pdf = pdf + torch.sum(
                weights[:, j : j + step, None] * torch.exp(log_comp), dim=1)
        return pdf, grid[..., None]
