"""Ancestral (forward) sampling.

Port of ``vectorizedbayesiannetwork_tpu/sampling/ancestral.py``: one
topological sweep (``inference/_sweep.py::sweep_trace``) with evidence and
do values clamped, returning the target's draws ``[B, S, D]`` or, from
``sample_joint``, every node's. The sweep draws from the row stream of
the call's key (``vbn.next_key()``), sharded over the VBN's mesh; a KDE
node's draw launches ``vbn_kde_pick`` on the card.
"""

from __future__ import annotations

import torch

from ..core.base import Query
from ..core.plan import pack_fixed_values
from ..core.registry import register_sampling
from ..inference._base import Method
from ..inference._sweep import node_values, sweep_trace


def fixed_rows(vbn, query: Query, plan, b: int) -> torch.Tensor:
    """The packed evidence/do rows [B, total_dim] on the VBN's device."""
    return torch.as_tensor(pack_fixed_values(query, plan, b),
                           device=vbn.device)


@register_sampling("ancestral")
class AncestralSampler(Method):
    def __init__(self, n_samples: int = 512, **_kwargs) -> None:
        self.n_samples = int(n_samples)

    def _packed(self, vbn, query: Query, s: int):
        plan, b = self._plan_and_batch(vbn, query)
        packed, _ = sweep_trace(
            plan, self._cpds(vbn, plan), self._params_tuple(vbn, plan),
            vbn.next_key(), fixed_rows(vbn, query, plan, b), s,
            mesh=vbn._mesh)
        return plan, packed

    def sample(self, vbn, query: Query, n_samples: int = None, **kwargs):
        s = int(n_samples or kwargs.get("n_samples", self.n_samples))
        plan, packed = self._packed(vbn, query, s)
        return node_values(plan, packed, plan.target_idx)

    def sample_joint(self, vbn, query: Query, n_samples: int = None,
                     **kwargs):
        s = int(n_samples or kwargs.get("n_samples", self.n_samples))
        plan, packed = self._packed(vbn, query, s)
        return {node: node_values(plan, packed, idx)
                for idx, node in enumerate(plan.topo_order)}
