"""Exact categorical posteriors.

Port of ``vectorizedbayesiannetwork_tpu/inference/categorical_exact.py``.
Fused pmf rows (``infer_posterior_pmf``) for any mix of discrete queries
in one dispatch: joint-state enumeration (``_exact_enum.py``) while the
joint support fits ``max_states``, else the junction tree (``_jtree.py``)
while its largest clique fits ``max_clique_states`` (trees cached per
plan and node class counts, so a refit that changes a count builds anew),
else the whole dispatch goes to the fallback method's mask-dynamic
program (``dynamic_masks=True``) with ``_last_fallback`` set. Per query
(``infer_posterior``): a clamped target is its value; a categorical
target with every parent observed is its CPT row over its support; with
latent parents, enumeration or the junction tree for the one query; else
the fallback.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.base import Query
from ..core.plan import pack_fixed_values
from ..core.registry import register_inference
from ._dynamic_base import pack_dynamic_inputs
from ._exact_enum import _node_cards, exact_enum_supported, make_exact_enum_fn
from ._jtree import build_jtree, make_jtree_fn
from .gaussian_exact import ExactMethod, make_fallback, parent_columns


@register_inference("categorical_exact")
class CategoricalExact(ExactMethod):
    _name = "categorical_exact"

    def __init__(
        self,
        fallback: str = "likelihood_weighting",
        max_states: int = 1 << 16,
        max_clique_states: int = 1 << 16,
        **kwargs,
    ) -> None:
        self._fallback = make_fallback(fallback, "categorical_exact", kwargs)
        self._last_fallback = False
        # joint-state budget of enumeration: its [S, n*k] state codes and
        # [B, S] weights must fit the card comfortably
        self.max_states = int(max_states)
        # clique-state budget of the junction tree
        self.max_clique_states = int(max_clique_states)
        self._jtree_cache = {}

    def _jtree_for(self, plan, cpds):
        """The junction tree of this network, cached per (plan, node class
        counts); None past ``max_clique_states``."""
        cards = _node_cards(plan, cpds)
        if cards is None:
            return None
        key = (plan, cards)
        if key not in self._jtree_cache:
            self._jtree_cache[key] = build_jtree(plan, cards,
                                                 self.max_clique_states)
        return self._jtree_cache[key]

    def _exact_fn(self, vbn, plan, cpds, k: int):
        """Enumeration or the junction tree for k output classes, or None
        when the network is outside both budgets."""
        if exact_enum_supported(plan, cpds, self.max_states):
            return self._built(vbn, plan, ("cat_enum", k),
                               lambda: make_exact_enum_fn(plan, cpds, k))
        tree = self._jtree_for(plan, cpds)
        if tree is None:
            return None
        return self._built(vbn, plan, ("cat_jtree", k, id(tree)),
                           lambda: make_jtree_fn(plan, cpds, k, tree))

    def infer_posterior_pmf(
        self, vbn, queries, *, n_classes: int, pad_bucket: int = 1, **kwargs
    ) -> Optional[Tuple[np.ndarray, List[Tuple[int, int, int]]]]:
        """Exact pmf rows [sum B, n_classes] and spans, unnormalized from
        enumeration and normalized from the junction tree; past both
        budgets the fallback's mask-dynamic rows; None when the network is
        not fully discrete (the caller reduces the per-query stream)."""
        plan, cpds = self._canonical(vbn)
        k = int(n_classes)
        fn = self._exact_fn(vbn, plan, cpds, k) if _node_cards(
            plan, cpds) is not None else None
        if fn is None:
            fb_pmf = getattr(self._fallback, "infer_posterior_pmf", None)
            fully_discrete = all(
                hasattr(c, "categorical_probs") and c.output_dim == 1
                for c in cpds
            )
            if fb_pmf is None or not fully_discrete:
                return None
            self._last_fallback = True
            return fb_pmf(vbn, queries, n_classes=n_classes,
                          pad_bucket=pad_bucket, dynamic_masks=True, **kwargs)
        inputs, spans, b_tot, _ = pack_dynamic_inputs(
            plan, queries, clamp_obs=True, pad_to=pad_bucket)
        (pmf,) = fn(self._params_tuple(vbn, plan), self._tensors(vbn, inputs))
        self._last_fallback = False
        return pmf.cpu().numpy()[:b_tot], spans

    def _exact_pmf_single(self, vbn, query: Query):
        """(probs [B, K], support [B, K, 1]) of a latent-parent query by
        enumeration or the junction tree, or None outside both budgets."""
        plan, cpds = self._canonical(vbn)
        cards = _node_cards(plan, cpds)
        if cards is None:
            return None
        t_idx = plan.node_to_idx()[query.target]
        k = cards[t_idx]
        fn = self._exact_fn(vbn, plan, cpds, k)
        if fn is None:
            return None
        inputs, _, b_tot, _ = pack_dynamic_inputs(plan, [query],
                                                  clamp_obs=True)
        (pmf,) = fn(self._params_tuple(vbn, plan), self._tensors(vbn, inputs))
        pmf = pmf[:b_tot].double()
        probs = (pmf / torch.clamp(pmf.sum(dim=1, keepdim=True), min=1e-30)
                 ).float()
        support = cpds[t_idx].support_values(
            vbn.params[plan.topo_order[t_idx]])[0][:k]
        return probs, support.float()[None, :, None].expand(b_tot, k, 1)

    def infer_posterior(self, vbn, query: Query, **kwargs):
        self._last_fallback = False
        plan, b = self._plan_and_batch(vbn, query)
        t = plan.target_idx
        cpd = self._cpds(vbn, plan)[t]
        fixed = torch.as_tensor(
            pack_fixed_values(query, plan, b, clamp_obs=True),
            device=vbn.device)
        t_off = plan.node_offsets[t]
        if plan.is_fixed(t):
            return (torch.ones((b, 1), device=vbn.device),
                    fixed[:, None, t_off : t_off + plan.node_dims[t]])
        if not hasattr(cpd, "categorical_probs") or plan.node_dims[t] != 1:
            return self._fallback_infer(vbn, query, **kwargs)
        if not all(plan.is_fixed(p) for p in plan.parent_idx[t]):
            # latent parents: exact where the network allows it
            out = self._exact_pmf_single(vbn, query)
            if out is not None:
                return out
            return self._fallback_infer(vbn, query, **kwargs)
        params = vbn.params[plan.topo_order[t]]
        probs = cpd.categorical_probs(params, parent_columns(plan, t, fixed))
        probs = probs.reshape(-1, probs.shape[-1])[: max(b, 1)].expand(
            b, probs.shape[-1])
        support = (cpd.support_values(params)[0] if hasattr(
            cpd, "support_values") else torch.arange(
            probs.shape[-1], dtype=torch.float32, device=vbn.device))
        return probs, support[None, :, None].expand(b, probs.shape[-1], 1)
