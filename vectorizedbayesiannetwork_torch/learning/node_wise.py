"""Node-wise learning: fit each CPD in topological order.

Port of ``vectorizedbayesiannetwork_tpu/learning/node_wise.py``: per-node
config validation (``cpd`` required, training keys banned at the top
level, ``fit``/``update`` must be dicts), parent-column concatenation,
registry-based CPD construction with schema-coerced kwargs, then
``cpd.fit`` on the VBN's device. The JAX package's opt-in grouped fit
(``VBN_FIT_GROUP``) serves only neural CPDs, which this port does not
have yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..config_cast import CPD_SCHEMAS, FIT_SCHEMA, coerce_numbers
from ..core.registry import CPD_REGISTRY, register_learning
from ..core.utils import concat_parents, resolve_verbosity
from ..defaults import TRAINING_KEYS

_RESERVED = {"cpd", "fit", "update"}


def validate_node_conf(node: str, conf: Dict) -> None:
    if not isinstance(conf, dict):
        raise TypeError(f"nodes_cpds[{node!r}] must be a dict config")
    if "cpd" not in conf:
        raise ValueError(f"nodes_cpds[{node!r}] must declare a 'cpd' key")
    bad = sorted((set(conf) - _RESERVED) & TRAINING_KEYS)
    if bad:
        raise ValueError(
            f"nodes_cpds[{node!r}] has training keys at top level ({bad}); "
            "move them under 'fit'/'update'."
        )
    for sub in ("fit", "update"):
        if conf.get(sub) is not None and not isinstance(conf[sub], dict):
            raise TypeError(f"nodes_cpds[{node!r}][{sub!r}] must be a dict")


def build_cpd(node: str, conf: Dict, input_dim: int, output_dim: int, seed: int):
    """Construct a CPD spec from a node config via the registry."""
    name = conf["cpd"]
    if name not in CPD_REGISTRY:
        raise ValueError(
            f"Unknown CPD {name!r} for node {node!r}. "
            f"Available: {sorted(CPD_REGISTRY)}"
        )
    hyper = {k: v for k, v in conf.items() if k not in _RESERVED}
    hyper = coerce_numbers(hyper, CPD_SCHEMAS.get(name, {}))
    return CPD_REGISTRY[name](input_dim, output_dim, seed=seed, **hyper)


@register_learning("node_wise")
class NodeWiseLearner:
    def __init__(self, default_cpd: str = "gaussian_nn", **kwargs) -> None:
        bad = sorted(set(kwargs) & TRAINING_KEYS)
        if bad:
            raise ValueError(
                "node_wise learning config cannot include training "
                f"hyperparameters ({bad}); move them into each node's CPD "
                "config under 'fit'/'update'."
            )
        unknown = sorted(set(kwargs) - {"show_progress", "verbosity"})
        if unknown:
            raise ValueError(
                "node_wise learning config only supports orchestration keys "
                f"['show_progress', 'verbosity']; unknown: {unknown}. Move "
                "CPD init/training parameters into each node's CPD config."
            )
        self.default_cpd = default_cpd

    def fit(self, vbn, data: Dict[str, np.ndarray], verbose: Optional[int] = None,
            **_kwargs):
        from ..defaults import defaults as _defaults

        verbosity = resolve_verbosity(verbose)
        nodes_cpds = vbn._learning_config.get("nodes_cpds", {})
        topo = vbn.dag.topological_order()
        for node in topo:
            if nodes_cpds.get(node) is None:
                nodes_cpds[node] = _defaults.cpd(self.default_cpd)
            validate_node_conf(node, nodes_cpds[node])

        for node in topo:
            conf = nodes_cpds[node]
            parent_arr = concat_parents(data, vbn.dag.parents(node))
            x = np.asarray(data[node])
            input_dim = 0 if parent_arr is None else parent_arr.shape[-1]
            cpd = build_cpd(node, conf, input_dim, x.shape[-1], vbn.seed)
            fit_kwargs = coerce_numbers(dict(conf.get("fit") or {}), FIT_SCHEMA)
            params = cpd.init(vbn.device)
            vbn.params[node] = cpd.fit(
                params, parent_arr, x, device=vbn.device, **fit_kwargs
            )
            vbn.nodes[node] = cpd
            if verbosity >= 2:
                print(f"[node_wise] fitted {node} ({conf['cpd']})")
        return vbn.nodes
