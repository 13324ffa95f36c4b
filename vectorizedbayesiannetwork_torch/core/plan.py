"""Static inference plan: the host-side description of a query program.

Counterpart of ``vectorizedbayesiannetwork_tpu/core/plan.py``: topo order,
packed-tensor slices, parent indices and evidence/do masks, built once per
(DAG, CPD specs, target, evidence keys, do keys) and cached on the VBN.
All fields are hashable Python ints/tuples; packed query rows are numpy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .base import Query
from .utils import ensure_2d_np


@dataclass(frozen=True)
class InferencePlan:
    topo_order: Tuple[str, ...]
    node_dims: Tuple[int, ...]
    node_offsets: Tuple[int, ...]  # start offset of each node in packed rows
    total_dim: int
    parent_idx: Tuple[Tuple[int, ...], ...]
    evidence_mask: Tuple[bool, ...]
    do_mask: Tuple[bool, ...]
    target_idx: int

    @property
    def n_nodes(self) -> int:
        return len(self.topo_order)

    def node_to_idx(self) -> Dict[str, int]:
        return {n: i for i, n in enumerate(self.topo_order)}

    def is_fixed(self, idx: int) -> bool:
        return self.evidence_mask[idx] or self.do_mask[idx]


def plan_signature(vbn, query: Query) -> tuple:
    return (
        vbn.structure_fingerprint(),
        query.target,
        tuple(sorted(query.evidence.keys())),
        tuple(sorted(query.do.keys())),
    )


def build_plan(vbn, query: Query) -> InferencePlan:
    dag = vbn.dag
    topo = tuple(dag.topological_order())
    node_to_idx = {n: i for i, n in enumerate(topo)}
    dims = tuple(int(vbn.cpd_spec(n).output_dim) for n in topo)
    offsets: List[int] = []
    total = 0
    for d in dims:
        offsets.append(total)
        total += d
    ev = set(query.evidence.keys())
    do = set(query.do.keys())
    return InferencePlan(
        topo_order=topo,
        node_dims=dims,
        node_offsets=tuple(offsets),
        total_dim=total,
        parent_idx=tuple(
            tuple(node_to_idx[p] for p in dag.parents(n)) for n in topo
        ),
        evidence_mask=tuple(n in ev for n in topo),
        do_mask=tuple(n in do for n in topo),
        target_idx=node_to_idx[query.target],
    )


def get_plan(vbn, query: Query) -> InferencePlan:
    """Build-or-fetch the plan from the vbn-level cache."""
    sig = plan_signature(vbn, query)
    cache = vbn._plan_cache
    if sig not in cache:
        cache[sig] = build_plan(vbn, query)
    return cache[sig]


_CLAMP = 1e6


def pack_fixed_values(
    query: Query,
    plan: InferencePlan,
    batch_size: int,
    *,
    clamp_obs: bool = False,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Pack evidence/do values into one [B, total_dim] array (zeros elsewhere).

    ``clamp_obs`` sanitizes evidence (NaN -> 0, +-inf -> +-1e6, clip to
    +-1e6); do values pass through as given.
    """
    node_to_idx = plan.node_to_idx()
    if out is None:
        out = np.zeros((batch_size, plan.total_dim), dtype=np.float32)
    for mapping, do_clamp in ((query.do, False), (query.evidence, clamp_obs)):
        for node, value in mapping.items():
            idx = node_to_idx[node]
            v = ensure_2d_np(value)
            if v.shape[0] == 1 and batch_size > 1:
                v = np.broadcast_to(v, (batch_size, v.shape[1]))
            if v.shape != (batch_size, plan.node_dims[idx]):
                raise ValueError(
                    f"Evidence/do for {node!r} has shape {v.shape}; expected "
                    f"({batch_size}, {plan.node_dims[idx]})"
                )
            if do_clamp:
                v = np.clip(
                    np.nan_to_num(v, nan=0.0, posinf=_CLAMP, neginf=-_CLAMP),
                    -_CLAMP,
                    _CLAMP,
                )
            off = plan.node_offsets[idx]
            out[:, off : off + v.shape[1]] = v
    return out
