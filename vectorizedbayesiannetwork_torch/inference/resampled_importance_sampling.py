"""Sequential importance resampling (SIR).

Port of
``vectorizedbayesiannetwork_tpu/inference/resampled_importance_sampling.py``:
a per-node prior-proposal sweep in torch ops over the CPDs' flat
primitives; after each evidence node's weight update the ESS is computed
and, on the rows where it fell below the threshold, the particles that are
still read later are resampled and their weights reset. The "resample or
not" decision is a per-row ``where`` select between resampled and original
particles, so nothing waits on the host mid-sweep.

Each resampling event runs the merge path of ``ops/resample_merge.py``
(one ``vbn_cumsum`` and one ``vbn_srg`` launch on the card; multinomial:
two cumsums and ``vbn_spg``) where
``srg_supported`` admits the shape, else the index form of
``ops/resample.py``. Node draws come from the call's ``torch.Generator``;
each resampling event draws from its own sub-stream,
``fold(draw, 10_000 + node)``.

Not ported: the mesh branch (``distributed_resample_gather`` over a
sharded particle axis) waits for ROADMAP queue 1 item 14.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..core.base import Query
from ..core.plan import InferencePlan, pack_fixed_values
from ..core.registry import register_inference
from ..core.rng import fold
from ..ops.resample import (
    gather_particles,
    multinomial_resample_indices,
    systematic_resample_indices,
)
from ..ops.resample_merge import (
    multinomial_resample_gather,
    srg_supported,
    systematic_resample_gather,
)
from ._base import Method, Program
from ._sweep import _parents_flat


def live_after(plan: InferencePlan, idx: int) -> List[int]:
    """Nodes whose particle values are still read after node ``idx``'s
    resampling event: the target, and parents of a later node. Fixed nodes
    are broadcast over the particle axis, so resampling leaves them as they
    are; every other node is dead and is not gathered."""
    out = []
    for j in range(idx + 1):
        if plan.is_fixed(j):
            continue
        if j == plan.target_idx or any(
            j in plan.parent_idx[k] for k in range(idx + 1, plan.n_nodes)
        ):
            out.append(j)
    return out


@register_inference("resampled_importance_sampling")
class ResampledImportanceSampling(Method):
    """``resample_method``: 'systematic' (default, the standard SMC choice,
    lower variance) or 'multinomial' (``torch.multinomial`` semantics)."""

    def __init__(
        self,
        n_samples: int = 512,
        ess_threshold: float = 0.5,
        resample: bool = True,
        clamp_obs: bool = True,
        resample_method: str = "systematic",
        **_kwargs,
    ) -> None:
        self.n_samples = int(n_samples)
        self.ess_threshold = float(ess_threshold)
        self.resample = bool(resample)
        self.clamp_obs = bool(clamp_obs)
        if resample_method not in {"systematic", "multinomial"}:
            raise ValueError(
                "resample_method must be 'systematic' or 'multinomial'"
            )
        self.resample_method = resample_method
        self._last_ess: Optional[torch.Tensor] = None
        self._resampled_dev: Optional[torch.Tensor] = None  # from the last call

    @property
    def _last_resampled(self) -> bool:
        """Whether the last call resampled any row (read from the device
        on first use)."""
        if self._resampled_dev is None:
            return False
        return bool(self._resampled_dev)

    def make_program(self, vbn, query: Query, **kwargs):
        s = int(kwargs.get("n_samples", self.n_samples))
        ess_threshold = float(kwargs.get("ess_threshold", self.ess_threshold))
        resample = bool(kwargs.get("resample", self.resample))
        clamp_obs = bool(kwargs.get("clamp_obs", self.clamp_obs))
        method = str(kwargs.get("resample_method", self.resample_method))
        if method == "systematic":
            fused, indices = systematic_resample_gather, systematic_resample_indices
        else:
            fused, indices = multinomial_resample_gather, multinomial_resample_indices
        plan, b = self._plan_and_batch(vbn, query)
        fixed = pack_fixed_values(query, plan, b, clamp_obs=clamp_obs)
        cpds = self._cpds(vbn, plan)
        t = plan.target_idx
        threshold = (
            max(1.0, ess_threshold * float(s))
            if ess_threshold <= 1.0
            else float(ess_threshold)
        )

        def resample_rows(weights, cat, need, gen):
            """Resample ``cat`` [B, S, D] by ``weights`` on the rows where
            ``need``; the other rows keep their particles."""
            if srg_supported(s, cat.shape[-1]):
                res = fused(weights, cat, generator=gen)
            else:
                res = gather_particles(cat, indices(weights, generator=gen))
            return torch.where(need[:, None, None], res, cat)

        def fn(params_tuple, draw, fixed_vals):
            bb = fixed_vals.shape[0]
            m = bb * s
            dev = fixed_vals.device
            vals: List[Optional[torch.Tensor]] = [None] * plan.n_nodes
            log_w = torch.zeros((bb, s), dtype=torch.float32, device=dev)
            any_resampled = torch.zeros((), dtype=torch.bool, device=dev)
            last_ess = torch.full((bb,), float(s), device=dev)
            for idx in range(plan.n_nodes):
                d = plan.node_dims[idx]
                off = plan.node_offsets[idx]
                pflat = _parents_flat(plan, vals, idx, m)
                if not plan.is_fixed(idx):
                    v = cpds[idx]._sample_flat(
                        params_tuple[idx], draw.generator, pflat, m
                    )
                    vals[idx] = v.reshape(bb, s, d)
                    continue
                vals[idx] = fixed_vals[:, None, off : off + d].expand(bb, s, d)
                if not plan.evidence_mask[idx]:
                    continue
                lp = cpds[idx]._log_prob_flat(
                    params_tuple[idx], vals[idx].reshape(m, d), pflat
                )
                log_w = log_w + lp.reshape(bb, s)
                if not resample:
                    continue
                weights = torch.softmax(log_w, dim=1)
                last_ess = 1.0 / torch.sum(weights * weights, dim=1)
                need = last_ess < threshold  # [B]
                live = live_after(plan, idx)
                if live:
                    # one gather over the concatenated live columns
                    cat = torch.cat([vals[j] for j in live], dim=-1)
                    cat = resample_rows(
                        weights, cat, need, fold(draw, 10_000 + idx).generator
                    )
                    o = 0
                    for j in live:
                        dj = plan.node_dims[j]
                        vals[j] = cat[..., o : o + dj]
                        o += dj
                log_w = torch.where(need[:, None], 0.0, log_w)
                any_resampled = any_resampled | need.any()
            weights = torch.softmax(log_w, dim=1)
            return weights, vals[t], last_ess, any_resampled

        def post(outs):
            weights, samples, ess, resampled = outs
            self._last_ess = ess
            self._resampled_dev = resampled
            return weights, samples

        return Program(plan, fn, self._params_tuple(vbn, plan), fixed, post)

    def infer_posterior(self, vbn, query: Query, **kwargs):
        return self._run_program(vbn, self.make_program(vbn, query, **kwargs))
