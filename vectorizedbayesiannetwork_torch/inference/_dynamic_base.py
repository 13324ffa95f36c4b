"""Posterior serving shared by likelihood weighting and Monte-Carlo
marginalization: the static fused-summary route and mask-dynamic serving.

Port of ``vectorizedbayesiannetwork_tpu/inference/_dynamic_base.py``.

- Static plans: the sweep AND the posterior summary (class histogram or
  weighted moments) run inside a kernel, and only ``[B, k]`` rows reach
  the host (``_static_fused_reduce``).
- ``dynamic_masks=True``: the query's structure (evidence/do masks, their
  values, the target) is data per row, so one sweep serves any mix of
  queries on the network's one canonical plan. Queries' rows are
  concatenated (``pack_dynamic_inputs``), run as one dispatch on the scan
  kernels (``ops/sweep_scan.py``) or, where their gates refuse the plan,
  the torch-op sweep (``_dynamic_sweep.py``), and split back per query.
  PyTorch compiles nothing, so there is no program cache to key; padding to
  ``pad_bucket`` is kept for the JAX contract (padded rows carry target 0
  and no masks, and are dropped).
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.base import Query
from ..core.plan import get_plan, pack_fixed_values, pack_values
from ..core.utils import infer_batch_size
from ..utils.profiling import annotate, spanned, wait
from ._base import Method, Program


@spanned("vbn.pack")
def pack_dynamic_inputs(
    plan, queries: Sequence[Query], *, clamp_obs: bool, pad_to: int = 1
):
    """Concat queries' rows + per-row masks/targets, padded.

    Returns ``(inputs, spans, b_tot, b_pad)``: ``inputs`` is the numpy
    tuple (rows [b_pad, total_dim], ev [b_pad, N], do [b_pad, N],
    tgt [b_pad] int32) and ``spans`` is ``[(lo, hi, target_idx)]`` per
    query. ``pad_to`` >= the row count is honoured exactly; a smaller one
    pads to the next power of two (at least ``pad_to``).
    """
    node_to_idx = plan.node_to_idx()
    bs = [infer_batch_size(q.evidence, q.do) for q in queries]
    b_tot = sum(bs)
    pad_to = int(pad_to)
    b_pad = (
        pad_to
        if pad_to >= b_tot
        else max(1 << max(0, (b_tot - 1)).bit_length(), pad_to)
    )
    rows = np.zeros((b_pad, plan.total_dim), np.float32)
    evs = np.zeros((b_pad, plan.n_nodes), np.float32)
    dos = np.zeros((b_pad, plan.n_nodes), np.float32)
    tgts = np.zeros((b_pad,), np.int32)
    spans = []
    at = 0
    for q, b in zip(queries, bs):
        pack_values(q, plan, b, clamp_obs, rows[at : at + b])
        for n in q.evidence:
            evs[at : at + b, node_to_idx[n]] = 1.0
        for n in q.do:
            dos[at : at + b, node_to_idx[n]] = 1.0
        ti = node_to_idx[q.target]
        tgts[at : at + b] = ti
        spans.append((at, at + b, ti))
        at += b
    return (rows, evs, dos, tgts), spans, b_tot, b_pad


class DynamicMaskMethod(Method):
    """Base for methods with a mask-dynamic variant.

    Subclasses implement ``_dynamic_fn(plan, cpds, s, opts, mesh)``
    returning ``fn(params_tuple, draw, inputs) -> (pdf [B, S], samples
    [B, S, maxd], *aux)`` (``mesh``: the VBN's, for a kernel that runs
    sharded) and may override ``_dynamic_opts`` (options read from the
    call's kwargs), ``_dyn_red_raw`` (an in-kernel posterior reduction)
    and ``_note_dynamic_aux`` (host bookkeeping of the aux outputs).
    """

    pack_clamp_obs = False  # whether evidence values sanitize at pack time
    # Weight source of the fused-kernel posterior reductions ("logw" =
    # evidence weights / LW, "lpt" = target density / MCM).
    _static_red_src: Optional[str] = None

    def __init__(self, dynamic_masks: bool = False) -> None:
        self.dynamic_masks = bool(dynamic_masks)

    # ----------------- static plans -----------------
    def _static_fused_reduce(self, vbn, queries, kind, n_classes, kwargs):
        """Per-query fused-kernel posterior reductions on static plans.

        Returns ``(rows, spans)`` or None when no kernel applies to some
        query (the caller then takes the stream path). All queries are
        launched before the first fetch. pmf rows come back unnormalized,
        scaled by ``exp(-m)``; moments rows are (mean, std). The
        ``vbn.reduce.fused`` span opens at the first query's launch.
        """
        from .likelihood_weighting import LikelihoodWeighting

        src = self._static_red_src
        if src is None:
            return None
        s = int(kwargs.get("n_samples", self.n_samples))
        want = (f"{kind}_{src}",)
        pending = []
        with contextlib.ExitStack() as span:
            for q in queries:
                plan, b = self._plan_and_batch(vbn, q)
                raw = LikelihoodWeighting._fused_raw_fn(
                    plan, self._cpds(vbn, plan), s, want, mesh=vbn._mesh
                )
                if raw is None:
                    return None
                if not pending:
                    span.enter_context(annotate("vbn.reduce.fused"))
                fixed = pack_fixed_values(q, plan, b,
                                          clamp_obs=self.pack_clamp_obs)
                with annotate("vbn.upload"):
                    wait(vbn.device)
                    fixed = torch.as_tensor(fixed, device=vbn.device)
                _lw, _tg, _lp, red = raw(
                    self._params_tuple(vbn, plan), vbn.next_key().seed, fixed
                )
                pending.append((red[0], plan, b))
            with annotate("vbn.fetch"):
                fetched = [sums.cpu().numpy() for sums, _plan, _b in pending]
        rows, spans, at = [], [], 0
        for sums, (_, plan, b) in zip(fetched, pending):
            sums = sums.astype(np.float64)
            if kind == "pmf":
                rows.append(_pmf_columns(sums, int(n_classes)))
            else:
                rows.append(_moments_rows(sums))
            spans.append((at, at + b, plan.target_idx))
            at += b
        return np.concatenate(rows, axis=0), spans

    # ----------------- mask-dynamic -----------------
    def _dynamic_enabled(self, kwargs) -> bool:
        return bool(kwargs.get("dynamic_masks", self.dynamic_masks))

    def _dynamic_opts(self, kwargs) -> Tuple:
        return ()

    def _dynamic_fn(self, plan, cpds, s: int, opts: Tuple, mesh=None):
        raise NotImplementedError

    def _dyn_red_raw(self, plan, cpds, s: int, opts, kind: str, mesh=None):
        """Mask-dynamic raw whose OUTPUT is the in-kernel posterior
        reduction, or None when the method cannot express its weighting
        as one kernel reduction. When available, ``infer_posterior_pmf`` /
        ``_moments`` never hold a ``[B, S]`` stream."""
        return None

    @staticmethod
    def _fused_dyn_raw(plan, cpds, s: int, want, mesh=None):
        """The scan kernel's raw for this plan (one launch serves every
        evidence pattern), sharded over ``mesh`` when one is given, or None
        when its gates refuse the plan."""
        from ..ops.sweep_scan import make_scan_sweep_fn

        return make_scan_sweep_fn(plan, cpds, s, want=want, mesh=mesh)

    def _note_dynamic_aux(self, aux: List, sl: slice) -> None:
        pass

    def _canonical_plan(self, vbn):
        """The one network-wide plan every dynamic dispatch shares (masks
        and target are runtime inputs, so any query's plan would do)."""
        topo = tuple(vbn.dag.topological_order())
        return get_plan(vbn, Query(target=topo[0], evidence={}, do={}))

    def _dynamic_inputs(self, vbn, queries, pad_bucket: int = 1):
        plan = self._canonical_plan(vbn)
        inputs, spans, b_tot, b_pad = pack_dynamic_inputs(
            plan, queries, clamp_obs=self.pack_clamp_obs, pad_to=pad_bucket
        )
        return plan, self._cpds(vbn, plan), inputs, spans, b_tot

    def _make_dynamic_program(self, vbn, query: Query, s: int, opts: Tuple):
        """One query through the mask-dynamic sweep, as a ``Program``."""
        plan, cpds, inputs, spans, b = self._dynamic_inputs(vbn, [query])
        t_dim = plan.node_dims[spans[0][2]]

        def post(outs):
            pdf, samples, *aux = outs
            self._note_dynamic_aux(aux, slice(0, b))
            return pdf[:b], samples[:b, :, :t_dim]

        return Program(
            plan, self._dynamic_fn(plan, cpds, s, opts, vbn._mesh),
            self._params_tuple(vbn, plan), inputs, post,
        )

    def infer_posterior_many(self, vbn, queries, **kwargs):
        """Dynamic mode: ANY mix of targets and evidence patterns rides ONE
        sweep; rows are split back per query. Otherwise the queries run
        one after the other."""
        if not self._dynamic_enabled(kwargs):
            kwargs.pop("pad_bucket", None)
            return super().infer_posterior_many(vbn, queries, **kwargs)
        pad_bucket = int(kwargs.pop("pad_bucket", 1))
        s = int(kwargs.get("n_samples", self.n_samples))
        plan, cpds, inputs, spans, b_tot = self._dynamic_inputs(
            vbn, queries, pad_bucket
        )
        pdf, samples, *aux = self._run_dynamic(
            vbn, plan,
            self._dynamic_fn(plan, cpds, s, self._dynamic_opts(kwargs),
                             vbn._mesh),
            inputs,
        )
        self._note_dynamic_aux(aux, slice(0, b_tot))
        return [
            (pdf[lo:hi], samples[lo:hi, :, : plan.node_dims[t_idx]])
            for lo, hi, t_idx in spans
        ]

    def _run_dynamic(self, vbn, plan, fn, inputs):
        with annotate("vbn.upload"):
            wait(vbn.device)
            tensors = tuple(torch.as_tensor(a, device=vbn.device)
                            for a in inputs)
        return fn(self._params_tuple(vbn, plan), vbn.next_key(), tensors)

    @spanned("vbn.reduce.dynamic")
    def _dynamic_reduce(self, vbn, queries, kind, n_classes, pad_bucket, kwargs):
        """``(rows [b_tot, k or 2], spans)`` of one dynamic dispatch: the
        in-kernel reduction where the method has one (pmf rows normalized,
        ``_last_ess`` None), else a reduction of the streams on the device
        (pmf: raw-weight histogram; moments: normalized weights with the
        uniform fallback)."""
        s = int(kwargs.get("n_samples", self.n_samples))
        opts = self._dynamic_opts(kwargs)
        plan, cpds, inputs, spans, b_tot = self._dynamic_inputs(
            vbn, queries, pad_bucket
        )
        red_raw = self._dyn_red_raw(plan, cpds, s, opts, kind, vbn._mesh)
        if red_raw is not None:

            def fn(params_tuple, draw, tensors):
                fixed_vals, evm, dom, ti = tensors
                return red_raw(params_tuple, draw.seed, fixed_vals, evm, dom, ti)

            _lw, _tg, _lp, (sums, _m) = self._run_dynamic(vbn, plan, fn, inputs)
            with annotate("vbn.fetch"):
                sums = sums.double().cpu().numpy()[:b_tot]
            if hasattr(self, "_last_ess"):
                self._last_ess = None  # not computed on the reduced path
            if kind == "pmf":
                pmf = _pmf_columns(sums, int(n_classes))
                return pmf / np.maximum(pmf.sum(axis=1, keepdims=True), 1e-30), spans
            return _moments_rows(sums), spans

        inner = self._dynamic_fn(plan, cpds, s, opts, vbn._mesh)
        pdf, samples, *aux = self._run_dynamic(vbn, plan, inner, inputs)
        self._note_dynamic_aux(aux, slice(0, b_tot))
        w = torch.clamp(
            torch.nan_to_num(pdf.double(), nan=0.0, posinf=0.0, neginf=0.0),
            min=0.0,
        )
        x = samples[..., 0].double()
        if kind == "pmf":
            k = int(n_classes)
            cls = torch.clamp(torch.round(x), 0, k - 1).long()
            rows = torch.zeros((w.shape[0], k), dtype=torch.float64,
                               device=w.device).scatter_add_(1, cls, w)
        else:
            denom = w.sum(dim=1, keepdim=True)
            wn = torch.where(denom > 1e-12, w / torch.clamp(denom, min=1e-12),
                             1.0 / w.shape[1])
            mean = (wn * x).sum(dim=1)
            var = (wn * (x - mean[:, None]) ** 2).sum(dim=1)
            rows = torch.stack([mean, torch.sqrt(torch.clamp(var, min=0.0))], 1)
        with annotate("vbn.fetch"):
            rows = rows.cpu().numpy()[:b_tot]
        return rows, spans

    # ----------------- serving entry points -----------------
    def infer_posterior_pmf(
        self, vbn, queries, *, n_classes: int, pad_bucket: int = 1, **kwargs
    ) -> Optional[Tuple[np.ndarray, List[Tuple[int, int, int]]]]:
        """Discrete posterior pmf rows, or None when neither a dynamic nor
        a static fused path serves (the caller then takes the stream
        path). Static rows come back unnormalized (scaled by exp(-m));
        dynamic reduced rows normalized; dynamic stream rows raw."""
        if not self._dynamic_enabled(kwargs):
            return self._static_fused_reduce(vbn, queries, "pmf", n_classes,
                                             kwargs)
        return self._dynamic_reduce(vbn, queries, "pmf", n_classes,
                                    pad_bucket, kwargs)

    def infer_posterior_moments(
        self, vbn, queries, *, pad_bucket: int = 1, **kwargs
    ) -> Optional[Tuple[np.ndarray, List[Tuple[int, int, int]]]]:
        """Per-query posterior (mean, std) rows, or None when neither a
        dynamic nor a static fused path serves."""
        if not self._dynamic_enabled(kwargs):
            return self._static_fused_reduce(vbn, queries, "mom", None, kwargs)
        return self._dynamic_reduce(vbn, queries, "mom", None, pad_bucket,
                                    kwargs)


def _pmf_columns(sums: np.ndarray, k: int) -> np.ndarray:
    """The first k histogram columns, zero-padded past the kernel's K."""
    pmf = np.zeros((sums.shape[0], k))
    c = min(k, sums.shape[1])
    pmf[:, :c] = sums[:, :c]
    return pmf


def _moments_rows(sums: np.ndarray) -> np.ndarray:
    """(sum w, sum w x, sum w x^2) -> (mean, std) rows."""
    s0 = np.maximum(sums[:, 0], 1e-30)
    mean = sums[:, 1] / s0
    var = np.maximum(sums[:, 2] / s0 - mean**2, 0.0)
    return np.stack([mean, np.sqrt(var)], axis=1)
