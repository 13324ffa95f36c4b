"""Do-calculus query helpers.

Counterpart of ``vectorizedbayesiannetwork_tpu/utils/interventions.py``
(pure Python): an intervened node is clamped without likelihood and loses
its parents (graph surgery); inference plans and user code use these
predicates.
"""

from __future__ import annotations

from typing import Tuple

from ..core.base import Query


def is_intervened(node: str, query: Query) -> bool:
    return node in (query.do or {})


def is_observed(node: str, query: Query) -> bool:
    return node in (query.evidence or {})


def get_fixed_value(node: str, query: Query):
    if is_intervened(node, query):
        return query.do[node]
    if is_observed(node, query):
        return query.evidence[node]
    return None


def effective_parents(node: str, parents: Tuple[str, ...], query: Query):
    """Graph surgery: an intervened node's incoming edges are removed."""
    if is_intervened(node, query):
        return ()
    return tuple(parents)
