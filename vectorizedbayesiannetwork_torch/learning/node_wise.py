"""Node-wise learning: fit each CPD in topological order.

Port of ``vectorizedbayesiannetwork_tpu/learning/node_wise.py``: per-node
config validation (``cpd`` required, training keys banned at the top
level, ``fit``/``update`` must be dicts), parent-column concatenation,
registry-based CPD construction with schema-coerced kwargs, then
``cpd.init`` and ``cpd.fit`` on the VBN's device with a ``torch.Generator``
of the node's own, folded from the VBN seed and ``1000 + node_idx`` as the
JAX package folds its fit keys (the neural CPDs draw their initial
weights and minibatch orders from it, the KDE CPD its subsample). A node
left out of ``nodes_cpds`` gets ``default_cpd``, ``gaussian_nn`` unless
the learner is told otherwise.

``VBN_FIT_GROUP=always`` (the JAX package's switch, off by default there
and here) fits same-signature neural nodes together: nodes whose CPD class,
static fields, dims and fit keys all match go to the class's ``fit_many``
(a group of one stays sequential). Each node keeps its own generator, so a
grouped fit equals the sequential one up to float rounding.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ..config_cast import CPD_SCHEMAS, FIT_SCHEMA, coerce_numbers
from ..core.registry import CPD_REGISTRY, register_learning
from ..core.rng import Draw, fold
from ..core.utils import concat_parents, resolve_verbosity
from ..defaults import TRAINING_KEYS

_RESERVED = {"cpd", "fit", "update"}


def _use_fit_grouping() -> bool:
    return os.environ.get("VBN_FIT_GROUP", "never").lower() == "always"


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

        root = Draw(vbn.seed, vbn.device)
        entries = []
        for node_idx, node in enumerate(topo):
            conf = nodes_cpds[node]
            parent_arr = concat_parents(data, vbn.dag.parents(node))
            x = np.asarray(data[node])
            input_dim = 0 if parent_arr is None else parent_arr.shape[-1]
            cpd = build_cpd(node, conf, input_dim, x.shape[-1], vbn.seed)
            fit_kwargs = coerce_numbers(dict(conf.get("fit") or {}), FIT_SCHEMA)
            gen = fold(root, 1000 + node_idx).generator
            entries.append((node, conf, cpd, gen, parent_arr, x, fit_kwargs))

        grouped = set()
        if _use_fit_grouping():
            groups: Dict[tuple, list] = {}
            for e in entries:
                cpd = e[2]
                if hasattr(cpd, "fit_many"):
                    sig = (type(cpd), cpd._static_fields(), cpd.input_dim,
                           cpd.output_dim,
                           tuple(sorted((k, repr(v)) for k, v in e[6].items())))
                    groups.setdefault(sig, []).append(e)
            for g in groups.values():
                if len(g) < 2:
                    continue
                fitted = g[0][2].fit_many(
                    [e[2].init(vbn.device, gen=e[3]) for e in g],
                    [e[4] for e in g], [e[5] for e in g], device=vbn.device,
                    gens=[e[3] for e in g], **g[0][6])
                if fitted is None:
                    continue
                for e, params in zip(g, fitted):
                    vbn.nodes[e[0]], vbn.params[e[0]] = e[2], params
                    grouped.add(e[0])
                if verbosity >= 2:
                    print(f"[node_wise] fitted {len(g)} {g[0][1]['cpd']} "
                          "nodes in one grouped loop")

        for node, conf, cpd, gen, parent_arr, x, fit_kwargs in entries:
            if node in grouped:
                continue
            params = cpd.init(vbn.device, gen=gen)
            vbn.params[node] = cpd.fit(
                params, parent_arr, x, device=vbn.device, gen=gen,
                **fit_kwargs
            )
            vbn.nodes[node] = cpd
            if verbosity >= 2:
                print(f"[node_wise] fitted {node} ({conf['cpd']})")
        return vbn.nodes
