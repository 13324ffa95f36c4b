"""Main user-facing API: the VBN class, on PyTorch.

Port of ``vectorizedbayesiannetwork_tpu/vbn.py`` for the fit -> serve path:
method setters (str / dict / callable), ``fit``, ``infer_posterior``,
``infer_posterior_many`` (one fused sweep in ``dynamic_masks`` mode, else
sequential), the fused ``infer_posterior_pmf`` / ``_moments`` with
their stream fallback, ``_posterior_stats``, and ``save`` / ``load`` in the
JAX package's checkpoint format (an ``.npz`` of flattened params with a
``__structure__`` JSON entry), so a model fitted by either package serves
in the other. Model state is a dict of params per node on one device;
``device=None`` means the CUDA card, and the CPU is used only when asked
for (``device="cpu"``).
"""

from __future__ import annotations

import io
import json
import os
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .core.base import Query
from .core.dag import StaticDAG
from .core.registry import CPD_REGISTRY, INFERENCE_REGISTRY, LEARNING_REGISTRY
from .core.rng import Draw, KeyStream
from .core.utils import (
    df_to_array_dict,
    ensure_2d_np,
    infer_batch_size,
    resolve_device,
    resolve_verbosity,
    to_plain_dict,
)

__version__ = "0.1.0"


def _serialize_nodes_cpds(nodes_cpds: Optional[Dict]) -> Dict[str, Dict]:
    out: Dict[str, Dict] = {}
    for node, conf in (nodes_cpds or {}).items():
        if isinstance(conf, dict):
            out[node] = to_plain_dict(conf)
        elif isinstance(conf, str):
            from .defaults import defaults as _defaults

            out[node] = _defaults.cpd(conf)
        else:
            raise TypeError(f"nodes_cpds[{node!r}] must be dict/str")
    return out


def _resolve_method_arg(method, registry: Dict[str, type], label: str):
    """Resolve a str/dict method argument to (name, base_params)."""
    if isinstance(method, dict):
        conf = to_plain_dict(method)
        name = conf.get("name") or conf.get("method")
        if not isinstance(name, str):
            raise TypeError(f"{label} dict must include a string 'name' field")
        params = {k: v for k, v in conf.items() if k not in {"name", "method"}}
    elif isinstance(method, str):
        name, params = method, {}
    else:
        raise TypeError(f"{label} must be a string, dict, or callable")
    key = name.lower().strip()
    if key not in registry:
        raise ValueError(
            f"Unknown {label} {name!r}. Available: {sorted(registry)}"
        )
    return key, params


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
        self._learning_config: Optional[Dict[str, Any]] = None
        self._inference_config: Optional[Dict[str, Any]] = None
        self._last_summary_path: Optional[str] = None

    # ----------------- internal plumbing -----------------
    def next_key(self) -> Draw:
        return self._keys.next()

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

    # ----------------- inference -----------------
    def _require_inference(self, what: str) -> None:
        if self._inference is None:
            raise RuntimeError(
                f"Call set_inference_method(...) before {what}()."
            )

    def infer_posterior(self, query, **kwargs) -> Tuple[torch.Tensor, torch.Tensor]:
        """(pdf [B, S], samples [B, S, D]) tensors on the VBN's device."""
        self._require_inference("infer_posterior")
        q = self._normalize_query(query)
        return self._inference.infer_posterior(self, q, **kwargs)

    def infer_posterior_many(self, queries, **kwargs):
        """Answer several queries; a list of (pdf, samples) pairs in input
        order. A method in ``dynamic_masks`` mode runs them as one sweep;
        otherwise they run one after the other."""
        self._require_inference("infer_posterior_many")
        qs = [self._normalize_query(q) for q in queries]
        many = getattr(self._inference, "infer_posterior_many", None)
        results = many(self, qs, **kwargs) if many is not None else None
        if results is None:
            results = [
                self._inference.infer_posterior(self, q, **kwargs) for q in qs
            ]
        return results

    def infer_posterior_pmf(self, queries, *, n_classes, **kwargs):
        """Discrete posterior pmf rows ``(rows [sum B, n_classes], spans)``.

        The static fused path reduces in the sweep kernel and returns rows
        scaled by ``exp(-max log-weight)``; the mask-dynamic reduced path
        returns normalized rows; the stream paths return raw weighted
        histograms. Rows are UNNORMALIZED in general.
        ``_last_summary_path`` records which path served ("fused" or
        "stream").
        """
        self._require_inference("infer_posterior_pmf")
        fused = getattr(self._inference, "infer_posterior_pmf", None)
        qs = [self._normalize_query(q) for q in queries]
        out = fused(self, qs, n_classes=n_classes, **kwargs) if fused else None
        self._last_summary_path = "fused" if out is not None else "stream"
        if out is None:
            out = self._reduce_from_stream(qs, "pmf", int(n_classes), kwargs)
        return out

    def infer_posterior_moments(self, queries, **kwargs):
        """Posterior (mean, std) rows ``(rows [sum B, 2], spans)``."""
        self._require_inference("infer_posterior_moments")
        fused = getattr(self._inference, "infer_posterior_moments", None)
        qs = [self._normalize_query(q) for q in queries]
        out = fused(self, qs, **kwargs) if fused else None
        self._last_summary_path = "fused" if out is not None else "stream"
        if out is None:
            out = self._reduce_from_stream(qs, "mom", None, kwargs)
        return out

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
            w = np.maximum(
                np.nan_to_num(
                    pdf.double().cpu().numpy(), posinf=0.0, neginf=0.0
                ),
                0.0,
            )
            x = samples.double().cpu().numpy()[..., 0]
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
        if extra is not None:
            structure["extra"] = extra
        if include_configs:
            structure["config"] = {**configs, "sampling": None, "update": None}
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
    def load(cls, path: str, *, device=None) -> "VBN":
        """Read a checkpoint written by either package's ``save``.

        The DAG is rebuilt in the saved topological order with each node's
        parents in their saved order, each CPD from
        its ``cpd_key``, ``init_kwargs`` and ``extra_state``, and its params
        as tensors on ``device``. Learning/inference configs are restored
        where this port has the method; others are skipped with a warning.
        """
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
            else:
                vbn.set_inference_method(name, **(cfg.get("params") or {}))

        node_arrays: Dict[str, Dict[str, np.ndarray]] = {}
        for full_key, arr in arrays.items():
            owner, pkey = full_key.split("\x1f", 1)
            if not owner.startswith("__"):
                node_arrays.setdefault(owner, {})[pkey] = arr
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
        return vbn


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
        node[parts[-1]] = torch.as_tensor(np.asarray(arr), device=device)

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.startswith("#") for k in node):
            return [node[f"#{i}"] for i in range(len(node))]
        return node

    return listify(root)
