"""Posterior summaries served by the fused sweep kernels (static plans).

Port of the static route of
``vectorizedbayesiannetwork_tpu/inference/_dynamic_base.py``: the sweep AND
the posterior summary (class histogram or weighted moments) run inside the
kernel, and only ``[B, k]`` rows reach the host. The mask-dynamic route
(``dynamic_masks=True``) is not ported yet; it is ROADMAP queue 1, item 6.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.plan import pack_fixed_values
from ..ops.sweep import make_fused_sweep_fn
from ._base import Method

DYNAMIC_TODO = (
    "dynamic_masks=True (mask-dynamic serving) is not ported yet: "
    "ROADMAP.md queue 1, item 6"
)


class DynamicMaskMethod(Method):
    pack_clamp_obs = False  # whether evidence values sanitize at pack time
    # Weight source of the fused-kernel posterior reductions ("logw" =
    # evidence weights / LW, "lpt" = target density / MCM).
    _static_red_src: Optional[str] = None

    def __init__(self, dynamic_masks: bool = False) -> None:
        if dynamic_masks:
            raise NotImplementedError(DYNAMIC_TODO)

    @staticmethod
    def _check_static(kwargs) -> None:
        if kwargs.get("dynamic_masks"):
            raise NotImplementedError(DYNAMIC_TODO)

    def _static_fused_reduce(self, vbn, queries, kind, n_classes, kwargs):
        """Per-query fused-kernel posterior reductions on static plans.

        Returns ``(rows, spans)`` or None when the fused kernel does not
        apply to some query (the caller then takes the stream path). All
        queries are launched before the first fetch. pmf rows come back
        unnormalized, scaled by ``exp(-m)``; moments rows are (mean, std).
        """
        self._check_static(kwargs)
        src = self._static_red_src
        if src is None:
            return None
        s = int(kwargs.get("n_samples", self.n_samples))
        want = (f"{kind}_{src}",)
        pending = []
        for q in queries:
            plan, b = self._plan_and_batch(vbn, q)
            raw = make_fused_sweep_fn(plan, self._cpds(vbn, plan), s, want)
            if raw is None:
                return None
            fixed = pack_fixed_values(q, plan, b, clamp_obs=self.pack_clamp_obs)
            _lw, _tg, _lp, red = raw(
                self._params_tuple(vbn, plan),
                vbn.next_key().seed,
                torch.as_tensor(fixed, device=vbn.device),
            )
            pending.append((red[0], plan, b))
        rows, spans, at = [], [], 0
        for sums, plan, b in pending:
            sums = sums.cpu().numpy().astype(np.float64)
            if kind == "pmf":
                k = int(n_classes)
                pmf = np.zeros((b, k))
                c = min(k, sums.shape[1])
                pmf[:, :c] = sums[:, :c]
                rows.append(pmf)
            else:
                s0 = np.maximum(sums[:, 0], 1e-30)
                mean = sums[:, 1] / s0
                var = np.maximum(sums[:, 2] / s0 - mean**2, 0.0)
                rows.append(np.stack([mean, np.sqrt(var)], axis=1))
            spans.append((at, at + b, plan.target_idx))
            at += b
        return np.concatenate(rows, axis=0), spans

    def infer_posterior_pmf(
        self, vbn, queries, *, n_classes: int, **kwargs
    ) -> Optional[Tuple[np.ndarray, List[Tuple[int, int, int]]]]:
        """Fused dispatch whose output is the discrete posterior pmf rows
        (unnormalized), or None when the kernel does not apply."""
        return self._static_fused_reduce(
            vbn, queries, "pmf", n_classes, kwargs
        )

    def infer_posterior_moments(
        self, vbn, queries, **kwargs
    ) -> Optional[Tuple[np.ndarray, List[Tuple[int, int, int]]]]:
        """Fused dispatch whose output is per-query (mean, std) rows, or
        None when the kernel does not apply."""
        return self._static_fused_reduce(vbn, queries, "mom", None, kwargs)
