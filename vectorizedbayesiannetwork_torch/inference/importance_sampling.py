"""Importance sampling with the prior proposal and an ESS-guarded fallback.

Port of ``vectorizedbayesiannetwork_tpu/inference/importance_sampling.py``:
a topological prior-proposal sweep where evidence nodes add log-weights,
softmax normalization, and a guard: when the ESS falls below 0.1 S, the
answer is a likelihood-weighting rerun on sanitized evidence (NaN -> 0,
+-inf -> +-1e6) with a fresh sub-stream.

- Static plans: the torch-op sweep (``_sweep.sweep_trace``), then the rerun
  once per call when any row collapsed. JAX decides inside one compiled
  program with ``lax.cond``; PyTorch runs eagerly, so the port reads the
  decision on the host, one sync per call.
- ``dynamic_masks=True``: both sweeps always run, on the scan kernels
  (``ops/sweep_scan.py``) where their gates admit the network, and each row
  takes the fallback on its own collapse, so a query's answer never
  depends on its batchmates.

``_last_fallback`` (read from the device on first use) and ``_last_ess``
record the last call.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.base import Query
from ..core.plan import clamp_evidence, pack_fixed_values
from ..core.registry import register_inference
from ..core.rng import fold
from ._base import Program
from ._dynamic_base import DynamicMaskMethod
from ._dynamic_sweep import dynamic_sweep_trace
from ._sweep import sweep_trace


def _weights_and_ess(log_w):
    weights = torch.softmax(log_w, dim=1)
    return weights, 1.0 / torch.sum(weights * weights, dim=1)


@register_inference("importance_sampling")
class ImportanceSampling(DynamicMaskMethod):
    pack_clamp_obs = False  # the fallback sanitizes on the device

    def __init__(
        self, n_samples: int = 200, dynamic_masks: bool = False, **_kwargs
    ) -> None:
        super().__init__(dynamic_masks)
        self.n_samples = int(n_samples)
        self.ess_threshold = 0.1
        self._fallback_dev: Optional[torch.Tensor] = None  # from the last call
        self._last_ess: Optional[torch.Tensor] = None

    @property
    def _last_fallback(self) -> bool:
        """Whether the last call took the LW fallback on any row."""
        if self._fallback_dev is None:
            return False
        return bool(self._fallback_dev)

    def _dynamic_fn(self, plan, cpds, s, opts, mesh=None):
        # Under a mesh the torch-op sweeps run sharded over it (each rank
        # its block of rows and particles on the unmeshed counters, then
        # gathered); the scan kernels' route runs whole on every rank.
        threshold = max(1.0, self.ess_threshold * float(s))
        # column -> node: the fallback's per-row evidence-column mask
        node_of_col = np.zeros((plan.total_dim,), np.int64)
        for idx in range(plan.n_nodes):
            off = plan.node_offsets[idx]
            node_of_col[off : off + plan.node_dims[idx]] = idx
        # On the scan route (``raw``) the kernel's ``pack_rows`` sanitizes
        # fixed values on entry (clip(rint(nan_to_num(v)), 0, card - 1)) for
        # both sweeps, the transform JAX applies to its XLA pass when its
        # kernel cannot take a batch; one card's kernel takes every batch.
        raw = self._fused_dyn_raw(plan, cpds, s, ("logw", "tgt"))

        def fn(params_tuple, draw, tensors):
            fixed_vals, evm, dom, ti = tensors
            d_is, d_lw = fold(draw, 0), fold(draw, 1)
            if raw is not None:
                log_w, tv1, _, _ = raw(
                    params_tuple, d_is.seed, fixed_vals, evm, dom, ti
                )
            else:
                tv1, log_w = dynamic_sweep_trace(
                    plan, cpds, params_tuple, d_is, fixed_vals, evm, dom, s,
                    mesh=mesh, targets=ti,
                )
            weights, ess = _weights_and_ess(log_w)
            # padded rows carry no evidence: uniform weights, ESS == S
            collapse = ess < threshold  # [B]
            col = torch.as_tensor(node_of_col, device=evm.device)
            f_lw = torch.where(evm[:, col] > 0, clamp_evidence(fixed_vals),
                               fixed_vals)
            if raw is not None:
                lw2, tv2, _, _ = raw(params_tuple, d_lw.seed, f_lw, evm, dom, ti)
                tv1, tv2 = tv1[:, :, None], tv2[:, :, None]
            else:
                tv2, lw2 = dynamic_sweep_trace(
                    plan, cpds, params_tuple, d_lw, f_lw, evm, dom, s,
                    mesh=mesh, targets=ti,
                )
            w_out = torch.where(collapse[:, None], torch.softmax(lw2, dim=1),
                                weights)
            s_out = torch.where(collapse[:, None, None], tv2, tv1)
            return w_out, s_out, ess, collapse.any()

        return fn

    def _note_dynamic_aux(self, aux, sl):
        self._last_ess = aux[0][sl]
        self._fallback_dev = aux[1]

    def make_program(self, vbn, query: Query, **kwargs):
        s = int(kwargs.get("n_samples", self.n_samples))
        if self._dynamic_enabled(kwargs):
            return self._make_dynamic_program(vbn, query, s, ())
        plan, b = self._plan_and_batch(vbn, query)
        fixed = pack_fixed_values(query, plan, b)
        cpds = self._cpds(vbn, plan)
        t = plan.target_idx
        threshold = max(1.0, self.ess_threshold * float(s))
        mesh = vbn._mesh
        ev_cols = np.zeros((plan.total_dim,), dtype=bool)
        for idx in range(plan.n_nodes):
            if plan.evidence_mask[idx]:
                off = plan.node_offsets[idx]
                ev_cols[off : off + plan.node_dims[idx]] = True

        def fn(params_tuple, draw, f_is):
            tv, log_w = sweep_trace(
                plan, cpds, params_tuple, fold(draw, 0), f_is, s,
                weighted=True, mesh=mesh, target=t,
            )
            weights, ess = _weights_and_ess(log_w)
            collapse = bool((ess < threshold).any())  # one sync per call
            if collapse:
                # the LW rerun on sanitized evidence, fresh sub-stream
                cols = torch.as_tensor(ev_cols, device=f_is.device)
                f_lw = torch.where(cols, clamp_evidence(f_is), f_is)
                tv, lw2 = sweep_trace(
                    plan, cpds, params_tuple, fold(draw, 1), f_lw,
                    s, weighted=True, mesh=mesh, target=t,
                )
                weights = torch.softmax(lw2, dim=1)
            return weights, tv, ess, collapse

        def post(outs):
            weights, samples, ess, collapse = outs
            self._last_ess = ess
            self._fallback_dev = collapse
            return weights, samples

        return Program(plan, fn, self._params_tuple(vbn, plan), fixed, post)

    def infer_posterior(self, vbn, query: Query, **kwargs):
        return self._run_program(vbn, self.make_program(vbn, query, **kwargs))
