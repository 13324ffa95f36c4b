"""Main user-facing API: the VBN class, on PyTorch.

Port of ``vectorizedbayesiannetwork_tpu/vbn.py``: method setters (str /
dict / callable), ``fit``, ``update`` (the online update policies),
``sample`` (ancestral, Gibbs, HMC, NUTS), ``infer_posterior``,
``infer_posterior_many`` (one fused sweep in ``dynamic_masks`` mode, else
sequential), the fused ``infer_posterior_pmf`` / ``_moments`` with
their stream fallback, ``_posterior_stats``, the per-node CPD handles
(``cpd`` / ``get_cpd`` / ``get_cpds``), and ``save`` / ``load`` in the
JAX package's checkpoint format (an ``.npz`` of flattened params with a
``__structure__`` JSON entry; the amortized net of an ``amortized`` fit as
``amortized_spec`` and ``__amortized__`` arrays), so a model fitted by
either package serves in the other. Model state is a dict of params per node on one device;
``device=None`` means the CUDA card, and the CPU is used only when asked
for (``device="cpu"``). Queries are served under ``torch.no_grad()``, and a
fit stores its params detached, so no autograd graph reaches serving;
``sample`` runs with autograd on (HMC and NUTS differentiate the joint
log-density in the latent values) and returns detached draws, and
``update`` trains with autograd where a policy trains.
"""

from __future__ import annotations

import copy
import io
import json
import os
import warnings
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .core.base import Query
from .core.dag import StaticDAG
from .core.handle import CPDHandle
from .core.registry import (
    CPD_REGISTRY,
    INFERENCE_REGISTRY,
    LEARNING_REGISTRY,
    SAMPLING_REGISTRY,
    UPDATE_REGISTRY,
)
from .core.rng import Draw, KeyStream
from .core.utils import (
    df_to_array_dict,
    ensure_2d_np,
    infer_batch_size,
    resolve_device,
    resolve_verbosity,
    to_plain_dict,
)
from .utils.profiling import annotate, spanned

__version__ = "0.1.0"

_UPDATE_TRAINING_KEYS = {"lr", "n_steps", "batch_size", "weight_decay"}
_UPDATE_POLICY_INIT_KEYS = {"max_size", "replay_ratio"}


@dataclass(frozen=True)
class ConfigItem:
    """One packaged default config, browsable as ``vbn.config.cpds.mdn``.

    Accepted wherever a method or CPD config is: the setters and
    ``nodes_cpds`` read ``.name`` and ``.params``; ``to_dict()`` renders
    the flat dict form the learning config stores.
    """

    name: str
    params: Dict
    kind: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        if self.kind == "cpd":
            head = {"cpd": self.name}
        elif self.kind in ("learning", "inference", "sampling", "update"):
            head = {"name": self.name}
        else:
            head = {}
        return {**head, **copy.deepcopy(self.params)}

    as_dict = to_dict


class ConfigNamespace(dict):
    """Attribute-addressable view over a level of the config catalog."""

    __getattr__ = dict.__getitem__


def _load_configs() -> ConfigNamespace:
    """The packaged defaults as a tree of ``ConfigItem``s, one per entry
    of ``defaults``' catalog (the JAX package reads one YAML file each)."""
    from .defaults import _CATALOG

    tree = ConfigNamespace()
    for category, level in _CATALOG.items():
        kind = "cpd" if category == "cpds" else category
        tree[category] = ConfigNamespace({
            stem: ConfigItem(name=stem, params=copy.deepcopy(params),
                             kind=kind)
            for stem, params in sorted(level.items())
        })
    return tree


def _serialize_nodes_cpds(nodes_cpds: Optional[Dict]) -> Dict[str, Dict]:
    out: Dict[str, Dict] = {}
    for node, conf in (nodes_cpds or {}).items():
        if isinstance(conf, ConfigItem):
            out[node] = conf.to_dict()
        elif isinstance(conf, dict):
            out[node] = to_plain_dict(conf)
        elif isinstance(conf, str):
            from .defaults import defaults as _defaults

            out[node] = _defaults.cpd(conf)
        else:
            raise TypeError(
                f"nodes_cpds[{node!r}] must be dict/ConfigItem/str")
    return out


def _resolve_method_arg(method, registry: Dict[str, type], label: str):
    """Resolve a str/dict/ConfigItem method argument to (name,
    base_params)."""
    if isinstance(method, dict):
        conf = to_plain_dict(method)
        name = conf.get("name") or conf.get("method")
        if not isinstance(name, str):
            raise TypeError(f"{label} dict must include a string 'name' field")
        params = {k: v for k, v in conf.items() if k not in {"name", "method"}}
    elif isinstance(method, ConfigItem):
        name, params = method.name, copy.deepcopy(dict(method.params))
    elif isinstance(method, str):
        name, params = method, {}
    else:
        raise TypeError(
            f"{label} must be a string, dict, ConfigItem, or callable")
    key = name.lower().strip()
    if key not in registry:
        raise ValueError(
            f"Unknown {label} {name!r}. Available: {sorted(registry)}"
        )
    return key, params


def _refuse_training_keys(params: Dict) -> None:
    bad = sorted(set(params) & _UPDATE_TRAINING_KEYS)
    if bad:
        raise ValueError(
            "Update training hyperparameters are defined per-CPD under "
            f"nodes_cpds[node]['update']. Remove from update(): {bad}."
        )


class VBN:
    """Vectorized Bayesian Network on PyTorch (CUDA unless asked otherwise)."""

    def __init__(self, dag, seed: Optional[int] = None, device=None) -> None:
        self.seed = 0 if seed is None else int(seed)
        self.device = resolve_device(device)
        self.dag = StaticDAG(dag)
        self.nodes: Dict[str, Any] = {}  # node -> CPD spec
        self.params: Dict[str, Dict[str, torch.Tensor]] = {}
        self._keys = KeyStream(self.seed, self.device)
        self._plan_cache: Dict = {}
        self._learning = None
        self._inference = None
        self._sampling = None
        self._update_policy = None
        self._learning_config: Optional[Dict[str, Any]] = None
        self._inference_config: Optional[Dict[str, Any]] = None
        self._sampling_config: Optional[Dict[str, Any]] = None
        self._update_config: Optional[Dict[str, Any]] = None
        self._last_summary_path: Optional[str] = None
        self._mesh = None  # a ('data', 'particle') DeviceMesh (set_mesh)
        # {"net", "spec"} of the amortized posterior net ('amortized' fit)
        self.amortized: Optional[Dict[str, Any]] = None
        self.config = _load_configs()

    # ----------------- internal plumbing -----------------
    @property
    def root_key(self) -> Draw:
        """The seed's root draw (the JAX package's root PRNG key)."""
        return self._keys.root

    def next_key(self) -> Draw:
        return self._keys.next()

    def next_key_spec(self):
        """``(root, counter)``: ``fold(root, counter)`` is the draw that
        ``next_key()`` would give; the stream advances as it does."""
        return self._keys.next_spec()

    def cpd_spec(self, node: str):
        if node not in self.nodes:
            raise RuntimeError(f"No fitted CPD for node {node!r}; call fit().")
        return self.nodes[node]

    def structure_fingerprint(self) -> tuple:
        topo = tuple(self.dag.topological_order())
        return (
            topo,
            tuple(sorted(self.dag.edges())),
            tuple(
                self.nodes[n].static_signature() if n in self.nodes else None
                for n in topo
            ),
        )

    # ----------------- configuration -----------------
    def _install_method(self, slot: str, registry, label: str, method, kwargs):
        if callable(method) and not isinstance(method, (str, dict)):
            impl = method
            config = {
                "callable": True,
                "name": getattr(method, "__qualname__", str(method)),
            }
        else:
            name, base_params = _resolve_method_arg(method, registry, label)
            params = {**base_params, **kwargs}
            impl = registry[name](**params)
            config = {"name": name, "params": params}
        setattr(self, f"_{slot}", impl)
        setattr(self, f"_{slot}_config", config)
        return config

    def set_learning_method(
        self, method, nodes_cpds: Optional[Dict[str, Dict]] = None, **kwargs
    ):
        config = self._install_method(
            "learning", LEARNING_REGISTRY, "learning method", method, kwargs
        )
        config["nodes_cpds"] = _serialize_nodes_cpds(nodes_cpds)

    def set_inference_method(self, method, **kwargs):
        self._install_method(
            "inference", INFERENCE_REGISTRY, "inference method", method, kwargs
        )

    def set_sampling_method(self, method, **kwargs):
        self._install_method(
            "sampling", SAMPLING_REGISTRY, "sampling method", method, kwargs
        )

    # ----------------- fit -----------------
    def _prepare_data(self, data) -> Dict[str, np.ndarray]:
        """Dict of arrays, or a DataFrame-like object (``.columns``)."""
        if not isinstance(data, dict) and hasattr(data, "columns"):
            data = df_to_array_dict(data)
        if not isinstance(data, dict):
            raise TypeError("data must be a DataFrame or a dict of arrays")
        out = {}
        for k, v in data.items():
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
            arr = np.asarray(v, dtype=np.float32)
            out[k] = arr.reshape(-1, 1) if arr.ndim == 1 else arr
        missing = [n for n in self.dag.nodes() if n not in out]
        if missing:
            raise ValueError(f"Missing data for DAG nodes: {missing}")
        return out

    def fit(self, data, *, verbosity: Optional[int] = None, **kwargs) -> None:
        if self._learning is None:
            raise RuntimeError("Call set_learning_method(...) before fit().")
        verbosity = resolve_verbosity(
            verbosity if verbosity is not None else kwargs.pop("verbose", None)
        )
        arrays = self._prepare_data(data)
        self._plan_cache.clear()
        self._learning.fit(self, arrays, verbose=verbosity, **kwargs)

    @torch.enable_grad()
    def update(self, data, update_method=None, *,
               verbosity: Optional[int] = None, **kwargs):
        """Online update of every node from new rows by an update policy
        (``streaming_stats``, ``online_sgd``, ``ema``, ``replay_buffer``);
        the first call names the policy, later calls may reuse it. The
        training hyperparameters are per node, under
        ``nodes_cpds[node]['update']``."""
        if not self.nodes:
            raise RuntimeError("Call fit(...) before update(...).")
        verbosity = resolve_verbosity(
            verbosity if verbosity is not None else kwargs.pop("verbose", None)
        )
        arrays = self._prepare_data(data)
        if update_method is not None:
            name, base_params = _resolve_method_arg(
                update_method, UPDATE_REGISTRY, "update method"
            )
            params = {**base_params, **kwargs}
            _refuse_training_keys(params)
            update_cls = UPDATE_REGISTRY[name]
            init_kwargs = {k: v for k, v in params.items()
                           if k in _UPDATE_POLICY_INIT_KEYS}
            if not isinstance(self._update_policy, update_cls):
                self._update_policy = update_cls(**init_kwargs)
            else:
                for k, v in init_kwargs.items():
                    setattr(self._update_policy, k, v)
            policy_kwargs = {k: v for k, v in params.items()
                             if k not in _UPDATE_POLICY_INIT_KEYS}
            self._update_config = {
                "name": name,
                "params": params,
                "init_kwargs": init_kwargs,
                "policy_kwargs": policy_kwargs,
            }
        else:
            if self._update_policy is None:
                raise RuntimeError(
                    "update_method must be provided for the first update call"
                )
            _refuse_training_keys(kwargs)
            policy_kwargs = kwargs
        policy_kwargs["verbosity"] = verbosity
        self._update_policy.update(self, arrays, **policy_kwargs)

    # ----------------- inference -----------------
    def _require_inference(self, what: str) -> None:
        if self._inference is None:
            raise RuntimeError(
                f"Call set_inference_method(...) before {what}()."
            )

    def _normalize_queries(self, queries) -> list:
        with annotate("vbn.normalize"):
            return [self._normalize_query(q) for q in queries]

    @torch.no_grad()
    def infer_posterior(self, query, **kwargs) -> Tuple[torch.Tensor, torch.Tensor]:
        """(pdf [B, S], samples [B, S, D]) tensors on the VBN's device."""
        with annotate("vbn.call", entry="infer_posterior") as sp:
            self._require_inference("infer_posterior")
            (q,) = self._normalize_queries([query])
            pdf, samples = self._inference.infer_posterior(self, q, **kwargs)
            sp.set(queries=1, rows=pdf.shape[0])
        return pdf, samples

    @torch.no_grad()
    def infer_posterior_many(self, queries, **kwargs):
        """Answer several queries; a list of (pdf, samples) pairs in input
        order. A method in ``dynamic_masks`` mode runs them as one sweep;
        otherwise they run one after the other."""
        with annotate("vbn.call", entry="infer_posterior_many") as sp:
            self._require_inference("infer_posterior_many")
            results = self._infer_many(self._normalize_queries(queries),
                                       **kwargs)
            sp.set(queries=len(results),
                   rows=sum(pdf.shape[0] for pdf, _ in results))
        return results

    def _infer_many(self, qs, **kwargs):
        many = getattr(self._inference, "infer_posterior_many", None)
        results = many(self, qs, **kwargs) if many is not None else None
        if results is None:
            results = [
                self._inference.infer_posterior(self, q, **kwargs) for q in qs
            ]
        return results

    @torch.no_grad()
    def infer_posterior_pmf(self, queries, *, n_classes, **kwargs):
        """Discrete posterior pmf rows ``(rows [sum B, n_classes], spans)``.

        The static fused path reduces in the sweep kernel and returns rows
        scaled by ``exp(-max log-weight)``; the mask-dynamic reduced path
        returns normalized rows; the stream paths return raw weighted
        histograms. Rows are UNNORMALIZED in general.
        ``_last_summary_path`` records which path served ("fused" or
        "stream").
        """
        with annotate("vbn.call", entry="infer_posterior_pmf") as sp:
            self._require_inference("infer_posterior_pmf")
            fused = getattr(self._inference, "infer_posterior_pmf", None)
            qs = self._normalize_queries(queries)
            out = (fused(self, qs, n_classes=n_classes, **kwargs)
                   if fused else None)
            self._last_summary_path = "fused" if out is not None else "stream"
            if out is None:
                out = self._reduce_from_stream(qs, "pmf", int(n_classes),
                                               kwargs)
            sp.set(queries=len(qs), rows=len(out[0]))
        return out

    @torch.no_grad()
    def infer_posterior_moments(self, queries, **kwargs):
        """Posterior (mean, std) rows ``(rows [sum B, 2], spans)``."""
        with annotate("vbn.call", entry="infer_posterior_moments") as sp:
            self._require_inference("infer_posterior_moments")
            fused = getattr(self._inference, "infer_posterior_moments", None)
            qs = self._normalize_queries(queries)
            out = fused(self, qs, **kwargs) if fused else None
            self._last_summary_path = "fused" if out is not None else "stream"
            if out is None:
                out = self._reduce_from_stream(qs, "mom", None, kwargs)
            sp.set(queries=len(qs), rows=len(out[0]))
        return out

    @spanned("vbn.reduce.stream")
    def _reduce_from_stream(self, qs, kind: str, n_classes, kwargs):
        """Host-side posterior reduction over the stream path, with the
        fused paths' semantics (pmf: raw-weight class histogram on
        rounded/clipped draws; moments: normalized weights with a uniform
        fallback). Lists of up to 16 queries go through
        ``infer_posterior_many``, longer ones query by query."""
        many = getattr(self._inference, "infer_posterior_many", None)
        results = many(self, qs, **kwargs) if many and len(qs) <= 16 else None
        if results is None:
            call_kw = dict(kwargs)
            call_kw.pop("pad_bucket", None)
            results = [
                self._inference.infer_posterior(self, q, **call_kw) for q in qs
            ]
        node_to_idx = {
            n: i for i, n in enumerate(self.dag.topological_order())
        }
        rows, spans, at = [], [], 0
        for q, (pdf, samples) in zip(qs, results):
            with annotate("vbn.fetch"):
                w = pdf.double().cpu().numpy()
                x = samples.double().cpu().numpy()[..., 0]
            w = np.maximum(np.nan_to_num(w, posinf=0.0, neginf=0.0), 0.0)
            b = w.shape[0]
            if kind == "pmf":
                k = int(n_classes)
                cls = np.clip(np.rint(x).astype(np.int64), 0, k - 1)
                pmf = np.zeros((b, k))
                np.add.at(
                    pmf,
                    (np.repeat(np.arange(b), w.shape[1]), cls.reshape(-1)),
                    w.reshape(-1),
                )
                rows.append(pmf)
            else:
                denom = w.sum(axis=1, keepdims=True)
                wn = np.where(
                    denom > 1e-12,
                    w / np.maximum(denom, 1e-12),
                    np.full_like(w, 1.0 / max(1, w.shape[1])),
                )
                mean = (wn * x).sum(axis=1)
                var = (wn * (x - mean[:, None]) ** 2).sum(axis=1)
                rows.append(
                    np.stack([mean, np.sqrt(np.maximum(var, 0.0))], axis=1)
                )
            spans.append((at, at + b, node_to_idx[q.target]))
            at += b
        return np.concatenate(rows, axis=0), spans

    def sample(self, query, n_samples: int = 200, **kwargs):
        """Draws [B, n_samples, D] of the query's target from the sampling
        method (a dict of every node's for ``sample_joint``-style
        methods), detached, on the VBN's device."""
        if self._sampling is None:
            raise RuntimeError("Call set_sampling_method(...) before sample().")
        q = self._normalize_query(query)
        samples = self._sampling.sample(self, q, n_samples=n_samples, **kwargs)
        if isinstance(samples, dict):
            return {k: v.detach() for k, v in samples.items()}
        return samples.detach()

    def _posterior_stats(
        self, pdf: torch.Tensor, samples: torch.Tensor, *, eps: float = 1e-12
    ) -> Dict[str, torch.Tensor]:
        if pdf.ndim != 2:
            raise ValueError(f"Expected pdf [B,S], got {tuple(pdf.shape)}")
        if samples.ndim != 3:
            raise ValueError(
                f"Expected samples [B,S,D], got {tuple(samples.shape)}"
            )
        if pdf.shape[:2] != samples.shape[:2]:
            raise ValueError("pdf and samples shapes are incompatible.")
        w = torch.clamp(
            torch.nan_to_num(pdf, nan=0.0, posinf=0.0, neginf=0.0), min=0.0
        )
        denom = w.sum(dim=1, keepdim=True)
        uniform = torch.full_like(w, 1.0 / max(1, w.shape[1]))
        w = torch.where(denom > eps, w / torch.clamp(denom, min=eps), uniform)
        mean = (w[..., None] * samples).sum(dim=1)
        var = (w[..., None] * (samples - mean[:, None, :]) ** 2).sum(dim=1)
        std = torch.sqrt(torch.clamp(var, min=0.0))
        ess = 1.0 / torch.clamp((w**2).sum(dim=1), min=eps)
        return {"mean": mean, "std": std, "ess": ess}

    @staticmethod
    def _broadcast_batch(a: torch.Tensor, b: torch.Tensor):
        if a.shape[0] == b.shape[0]:
            return a, b
        if a.shape[0] == 1:
            return a.expand((b.shape[0],) + tuple(a.shape[1:])), b
        if b.shape[0] == 1:
            return a, b.expand((a.shape[0],) + tuple(b.shape[1:]))
        raise ValueError(
            "Query and reference batch sizes must match, unless one is 1."
        )

    @torch.no_grad()
    def infer_relative(
        self, query, reference_query=None, *, eps: float = 1e-12, **kwargs
    ) -> Dict[str, Any]:
        """The query's posterior against a reference query's on the same
        target (by default the target with no evidence): each side's mean,
        std and effective sample size, and the deltas. Both run as one
        ``infer_posterior_many`` call (one sweep in ``dynamic_masks``
        mode)."""
        with annotate("vbn.call", entry="infer_relative") as sp:
            self._require_inference("infer_relative")
            (q,) = self._normalize_queries([query])
            if reference_query is None:
                reference_query = Query(target=q.target, evidence={}, do={})
            (rq,) = self._normalize_queries([reference_query])
            if rq.target != q.target:
                raise ValueError(
                    "query and reference_query must have the same target node."
                )
            (query_pdf, query_samples), (ref_pdf, ref_samples) = (
                self._infer_many([q, rq], **kwargs)
            )
            sp.set(queries=2, rows=query_pdf.shape[0] + ref_pdf.shape[0])
        qs = self._posterior_stats(query_pdf, query_samples, eps=eps)
        rs = self._posterior_stats(ref_pdf, ref_samples, eps=eps)
        q_mean, r_mean = self._broadcast_batch(qs["mean"], rs["mean"])
        q_std, r_std = self._broadcast_batch(qs["std"], rs["std"])
        q_ess, r_ess = self._broadcast_batch(qs["ess"], rs["ess"])
        delta_mean = q_mean - r_mean
        delta_std = q_std - r_std
        return {
            "target": q.target,
            "query_stats": {
                "mean": q_mean,
                "std": q_std,
                "effective_sample_size": q_ess,
            },
            "reference_stats": {
                "mean": r_mean,
                "std": r_std,
                "effective_sample_size": r_ess,
            },
            "delta_mean": delta_mean,
            "delta_std": delta_std,
            "relative_mean_change": delta_mean / torch.clamp(
                r_mean.abs(), min=eps),
            "relative_std_change": delta_std / torch.clamp(
                r_std.abs(), min=eps),
        }

    def _normalize_query(self, query) -> Query:
        if isinstance(query, Query):
            target, evidence_src, do_src = (
                query.target, query.evidence, query.do or {}
            )
        elif isinstance(query, dict):
            target = query.get("target") or query.get("target_feature")
            if target is None:
                raise ValueError("query must contain 'target'")
            evidence_src = query.get("evidence") or {}
            do_src = query.get("do") or {}
        else:
            raise TypeError("query must be a dict or Query")
        evidence = {k: ensure_2d_np(v) for k, v in evidence_src.items()}
        do = {k: ensure_2d_np(v) for k, v in do_src.items()}
        if target not in self.dag:
            raise ValueError(f"Unknown target node {target!r}.")
        unknown = [n for n in (*evidence, *do) if n not in self.dag]
        if unknown:
            raise ValueError(f"Unknown query nodes: {sorted(unknown)}")
        overlap = set(evidence) & set(do)
        if overlap:
            raise ValueError(
                f"Nodes cannot be in both evidence and do: {sorted(overlap)}"
            )
        infer_batch_size(evidence, do)
        return Query(target=target, evidence=evidence, do=do)

    # ----------------- device management -----------------
    def set_mesh(self, mesh) -> None:
        """Attach a ('data', 'particle') mesh (``parallel.make_mesh``); None
        returns to one device. Every rank of the mesh builds the same model
        and makes the same calls (its random stream then advances in step
        with the others'). Sharded, rows over 'data' and particles over
        'particle', every rank getting the whole result: the sweep kernels
        of LW and MCM; the torch-op sweeps (``ops/sweep.py::shard_trace``:
        the stacked-table forms, IS, KDE and neural plans, LBP, RBM, the
        samplers' ancestral starts, the amortizer's model rows), which
        return the unmeshed answer bit for bit, since each rank draws its
        block's own counters of the row stream; and RIS, whose node draws
        are its block's counters and which resamples over the particle
        shards (``ops/resample_distributed.py``). The MCMC chains' steps,
        the exact engines, the update policies and the amortizer's fit
        run whole on each rank and give the unmeshed answer; so does a
        batch the shard gates refuse. The mesh is not saved."""
        self._mesh = mesh

    def to_device(self, device) -> None:
        """Move the model to ``device``: the params, the amortized net, the
        random stream (its counter kept), and every tensor the CPDs, the
        methods and the update policy keep; compiled-function caches,
        which may hold tensors of the old device, are emptied."""
        dev = resolve_device(device)
        self.params = params_to(self.params, dev)
        if self.amortized is not None:
            self.amortized["net"] = params_to(self.amortized["net"], dev)
        self.device = dev
        self._keys.device = dev
        self._plan_cache.clear()
        seen: set = set()
        for obj in (*self.nodes.values(), self._learning, self._inference,
                    self._sampling, self._update_policy):
            _move_state(obj, dev, seen)

    # ----------------- CPD access -----------------
    def cpd(self, node: str) -> CPDHandle:
        return CPDHandle(self, node)

    def get_cpd(self, node: str) -> CPDHandle:
        return CPDHandle(self, node)

    def get_cpds(self) -> Dict[str, CPDHandle]:
        return {node: CPDHandle(self, node) for node in self.dag.nodes()}

    # ----------------- persistence -----------------
    def save(self, path: str, *, include_configs: bool = True,
             extra: Optional[dict] = None) -> None:
        """Write the JAX package's checkpoint format (npz + JSON)."""
        missing = [n for n in self.dag.nodes() if n not in self.nodes]
        if missing:
            raise RuntimeError(
                f"Cannot save model with missing CPDs for nodes: {missing}"
            )
        configs = {
            "learning": self._learning_config,
            "inference": self._inference_config,
            "sampling": self._sampling_config,
            "update": self._update_config,
        }
        if include_configs:
            for label, cfg in configs.items():
                if cfg and cfg.get("callable"):
                    raise ValueError(
                        f"Cannot serialize callable {label} method: "
                        f"{cfg.get('name')}"
                    )
        checkpoint_path, meta_path = _resolve_checkpoint_paths(path)
        topo = list(self.dag.topological_order())
        dag_info = {
            "nodes": topo,
            "edges": [list(e) for e in self.dag.edges()],
            "topological_order": topo,
            "parents": {n: list(self.dag.parents(n)) for n in topo},
        }
        nodes_meta: Dict[str, Dict] = {}
        arrays: Dict[str, np.ndarray] = {}
        for node in topo:
            cpd = self.nodes[node]
            nodes_meta[node] = {
                "cpd_key": cpd.registry_key,
                "class_name": type(cpd).__name__,
                "input_dim": cpd.input_dim,
                "output_dim": cpd.output_dim,
                "seed": self.seed,
                "init_kwargs": cpd.get_init_kwargs() or {},
                "extra_state": cpd.get_extra_state(),
            }
            for pkey, arr in _flatten_params(self.params[node]).items():
                arrays[f"{node}\x1f{pkey}"] = arr
        meta = {
            "vbn_version": __version__,
            "torch_version": torch.__version__,
            "dtype": "float32",
            "seed": self.seed,
            "prng_impl": None,
            "rng_counter": self._keys.state(),
        }
        structure = {"dag": dag_info, "nodes": nodes_meta, "meta": meta}
        if self.amortized is not None:
            structure["amortized_spec"] = self.amortized["spec"].to_dict()
            for pkey, arr in _flatten_params(self.amortized["net"]).items():
                arrays[f"__amortized__\x1f{pkey}"] = arr
        if extra is not None:
            structure["extra"] = extra
        if include_configs:
            structure["config"] = configs
            if self._update_policy is not None:
                state_meta, state_arrays = self._update_policy.get_state()
                structure["update_state"] = state_meta
                for pkey, arr in state_arrays.items():
                    arrays[f"__update__\x1f{pkey}"] = np.asarray(arr)
        buf = io.BytesIO()
        np.savez(
            buf,
            __structure__=np.frombuffer(
                json.dumps(structure).encode("utf-8"), dtype=np.uint8
            ),
            **arrays,
        )
        with open(checkpoint_path, "wb") as f:
            f.write(buf.getvalue())
        if meta_path is not None:
            summary = {
                "meta": meta,
                "dag": dag_info,
                "nodes": {
                    k: {"cpd_key": v["cpd_key"]} for k, v in nodes_meta.items()
                },
                "config": structure.get("config"),
            }
            with open(meta_path, "w", encoding="utf-8") as f:
                json.dump(summary, f, indent=2)

    @classmethod
    def load(cls, path: str, *, device=None, map_location=None) -> "VBN":
        """Read a checkpoint written by either package's ``save``.

        ``map_location`` (the JAX package's keyword) names the device as
        ``device`` does; giving both raises unless they agree, and with
        neither the model lands on the card.

        The DAG is rebuilt in the saved topological order with each node's
        parents in their saved order, each CPD from
        its ``cpd_key``, ``init_kwargs`` and ``extra_state``, and its params
        as tensors on ``device``. The learning, inference and sampling
        methods and the update policy are restored with their configs,
        and the policy's state (``update_state`` and the ``__update__``
        arrays: the replay buffer), and the amortized net
        (``amortized_spec`` and the ``__amortized__`` arrays). A method
        this port lacks is skipped with a warning, and so are arrays of an
        owner it does not know.
        """
        device = _load_device(device, map_location)
        checkpoint_path = (
            os.path.join(path, "checkpoint.npz") if os.path.isdir(path) else path
        )
        with np.load(checkpoint_path, allow_pickle=False) as data:
            structure = json.loads(bytes(data["__structure__"]).decode("utf-8"))
            arrays = {k: data[k] for k in data.files if k != "__structure__"}
        dag_info = structure.get("dag", {})
        order = dag_info.get("topological_order") or dag_info.get("nodes", [])
        # Parents in their saved order: it fixes the CPTs' mixed-radix
        # layout, and the saved edge list (grouped by source) loses it.
        parents = dag_info.get("parents")
        if parents is None:
            parents = {n: [] for n in order}
            for u, v in dag_info.get("edges", []):
                parents[v].append(u)
        meta = structure.get("meta", {})
        vbn = cls({n: parents[n] for n in order}, seed=meta.get("seed"),
                  device=device)
        vbn._keys.set_state(meta.get("rng_counter", 0))

        config = structure.get("config") or {}
        for slot, registry in (
            ("learning", LEARNING_REGISTRY),
            ("inference", INFERENCE_REGISTRY),
            ("sampling", SAMPLING_REGISTRY),
        ):
            cfg = config.get(slot) or {}
            name = cfg.get("name")
            if not name:
                continue
            if name not in registry:
                warnings.warn(
                    f"checkpoint {slot} method {name!r} is not in this "
                    "port yet; left unset",
                    stacklevel=2,
                )
                continue
            if slot == "learning":
                vbn.set_learning_method(
                    name, nodes_cpds=cfg.get("nodes_cpds"),
                    **(cfg.get("params") or {}),
                )
            elif slot == "inference":
                vbn.set_inference_method(name, **(cfg.get("params") or {}))
            else:
                vbn.set_sampling_method(name, **(cfg.get("params") or {}))
        update_cfg = config.get("update") or {}
        if update_cfg.get("name"):
            update_cls = UPDATE_REGISTRY.get(update_cfg["name"])
            if update_cls is None:
                raise ValueError(
                    f"Unknown update method {update_cfg['name']!r} in "
                    "checkpoint"
                )
            vbn._update_policy = update_cls(
                **(update_cfg.get("init_kwargs") or {}))
            vbn._update_config = update_cfg

        node_arrays: Dict[str, Dict[str, np.ndarray]] = {}
        update_arrays: Dict[str, np.ndarray] = {}
        amortized_arrays: Dict[str, np.ndarray] = {}
        dropped: Dict[str, int] = {}
        for full_key, arr in arrays.items():
            owner, pkey = full_key.split("\x1f", 1)
            if owner == "__update__":
                update_arrays[pkey] = arr
            elif owner == "__amortized__":
                amortized_arrays[pkey] = arr
            elif owner.startswith("__"):
                dropped[owner] = dropped.get(owner, 0) + 1
            else:
                node_arrays.setdefault(owner, {})[pkey] = arr
        for owner, count in sorted(dropped.items()):
            warnings.warn(
                f"checkpoint holds {count} {owner} array(s) that this port "
                "does not restore yet; dropped",
                stacklevel=2,
            )
        amortized_spec = structure.get("amortized_spec")
        if amortized_spec is not None and amortized_arrays:
            from .learning.amortized import AmortizedSpec

            vbn.amortized = {
                "spec": AmortizedSpec.from_dict(amortized_spec),
                "net": params_from_numpy(amortized_arrays, vbn.device),
            }
        for node, info in structure.get("nodes", {}).items():
            cpd_key = info.get("cpd_key")
            if cpd_key not in CPD_REGISTRY:
                raise ValueError(f"Unknown CPD key {cpd_key!r} for node {node!r}")
            cpd = CPD_REGISTRY[cpd_key](
                int(info.get("input_dim", 0)),
                int(info.get("output_dim", 1)),
                seed=info.get("seed", meta.get("seed")),
                **(info.get("init_kwargs") or {}),
            )
            if info.get("extra_state") is not None:
                cpd.set_extra_state(info["extra_state"])
            vbn.nodes[node] = cpd
            vbn.params[node] = params_from_numpy(
                node_arrays.get(node, {}), vbn.device
            )
        update_state = structure.get("update_state")
        if vbn._update_policy is not None and update_state is not None:
            vbn._update_policy.set_state(update_state, update_arrays)
        return vbn


def _load_device(device, map_location):
    """``load``'s device from its two keywords: either, both only when
    they name one device, or None (the card)."""
    if map_location is None:
        return device
    if not isinstance(map_location, (str, torch.device)):
        raise TypeError("map_location must be a device or a device string")
    if device is not None:
        a, b = torch.device(device), torch.device(map_location)
        if a.type != b.type or (a.index is not None and b.index is not None
                                and a.index != b.index):
            raise ValueError(
                f"load(device={device!r}, map_location={map_location!r}) "
                "name different devices"
            )
    return map_location


def params_to(tree, device):
    """A nested dict / list / tuple with tensor leaves, each tensor moved
    to ``device``; other leaves stay as they are."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: params_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list) or type(tree) is tuple:
        return type(tree)(params_to(v, device) for v in tree)
    return tree


def _move_state(obj, device, seen: set) -> None:
    """Move the tensors an object of this package keeps to ``device``,
    through its nested objects of this package (a method's fallback), and
    empty its ``*_cache`` dicts (built functions may close over tensors)."""
    if obj is None or id(obj) in seen or not hasattr(obj, "__dict__"):
        return
    seen.add(id(obj))
    for key, value in list(vars(obj).items()):
        if key.endswith("_cache") and isinstance(value, dict):
            value.clear()
        elif isinstance(value, (torch.Tensor, dict, list, tuple)):
            setattr(obj, key, params_to(value, device))
        elif type(value).__module__.startswith(__package__ + "."):
            _move_state(value, device, seen)


def _resolve_checkpoint_paths(path: str):
    _, ext = os.path.splitext(path)
    if ext in {".npz", ".pt", ".pth", ".ckpt"}:
        return path, None
    os.makedirs(path, exist_ok=True)
    return os.path.join(path, "checkpoint.npz"), os.path.join(path, "meta.json")


def _flatten_params(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict/list of tensors -> {'a/b/#0/c': ndarray} (checkpoint keys)."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten_params(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten_params(v, f"{prefix}#{i}/"))
    elif tree is not None:
        if isinstance(tree, torch.Tensor):
            tree = tree.detach().cpu().numpy()
        out[prefix[:-1]] = np.asarray(tree)
    return out


def params_from_numpy(flat: Dict[str, np.ndarray], device) -> Dict[str, Any]:
    """Checkpoint arrays {'a/b/#0/c': ndarray} -> nested params of tensors
    on ``device`` ('#i' path components become list entries)."""
    root: Dict[str, Any] = {}
    for key, arr in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.startswith("#") for k in node):
            return [node[f"#{i}"] for i in range(len(node))]
        return node

    return params_from_tree(listify(root), device)


def params_from_tree(tree, device):
    """A nested dict / list of arrays -> the same tree of tensors on
    ``device``: a JAX params pytree (a node's params, a grouped fit's nets
    stacked on their leading axis, an amortized net's ``mlp``, ``mean``,
    ``std`` and ``support``) as the port's."""
    if isinstance(tree, dict):
        return {k: params_from_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_tree(v, device) for v in tree]
    if tree is None:
        return None
    return torch.as_tensor(np.array(tree), device=device)
