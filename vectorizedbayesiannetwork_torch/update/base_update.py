"""Update-policy base: per-node update-hyperparameter resolution.

Port of ``vectorizedbayesiannetwork_tpu/update/base_update.py``: every
node a policy updates needs an ``update`` dict in its ``nodes_cpds``
config holding at least ``lr``, ``n_steps`` and ``batch_size`` and no key
outside ``UPDATE_SCHEMA``, whose values are schema-coerced; a policy's
``get_state`` / ``set_state`` carry its state through checkpoints (a
JSON-able dict and named numpy arrays).
"""

from __future__ import annotations

from typing import Dict, Tuple

from ..config_cast import UPDATE_SCHEMA, coerce_numbers
from ..core.utils import concat_parents

UPDATE_REQUIRED_KEYS = frozenset({"lr", "n_steps", "batch_size"})
UPDATE_ALLOWED_KEYS = frozenset(UPDATE_SCHEMA)


def resolve_node_update(vbn, node: str) -> Dict:
    """One node's ``update`` config, validated and type-coerced."""
    catalog = (getattr(vbn, "_learning_config", None) or {}).get("nodes_cpds")
    if not isinstance(catalog, dict) or node not in catalog:
        raise ValueError(
            f"Missing CPD config for node {node!r}. "
            "Provide an 'update' dict per node."
        )
    entry = catalog[node] or {}
    if not isinstance(entry, dict):
        raise ValueError(f"CPD config for node {node!r} must be a dict.")
    try:
        spec = entry["update"]
    except KeyError:
        raise ValueError(
            f"CPD config for node {node!r} must include an 'update' dict."
        ) from None
    if not isinstance(spec, dict):
        raise ValueError(
            f"CPD 'update' config for node {node!r} must be a dict."
        )
    given = frozenset(spec)
    if not UPDATE_REQUIRED_KEYS <= given:
        raise ValueError(
            f"CPD 'update' config for node {node!r} is missing required "
            f"keys: {sorted(UPDATE_REQUIRED_KEYS - given)}."
        )
    if not given <= UPDATE_ALLOWED_KEYS:
        raise ValueError(
            f"Unknown keys in CPD 'update' config for node {node!r}: "
            f"{sorted(given - UPDATE_ALLOWED_KEYS)}. "
            f"Allowed keys: {sorted(UPDATE_ALLOWED_KEYS)}."
        )
    return coerce_numbers(spec, UPDATE_SCHEMA)


class BaseUpdatePolicy:
    def update(self, vbn, data, **kwargs):
        raise NotImplementedError

    def get_state(self) -> Tuple[Dict, Dict]:
        """(JSON-able meta, {name: array}) for checkpointing."""
        return {}, {}

    def set_state(self, meta: Dict, arrays: Dict) -> None:
        return None


def node_update_inputs(vbn, data, node):
    """(parents array or None, x array) of one node, host numpy."""
    return concat_parents(data, vbn.dag.parents(node)), data[node]
