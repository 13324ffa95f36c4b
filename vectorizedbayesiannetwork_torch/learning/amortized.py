"""Amortized learning: a masked-evidence posterior network.

Port of ``vectorizedbayesiannetwork_tpu/learning/amortized.py``. After the
node-wise fit of the CPDs, one MLP learns every node's conditional given
any observed subset, from rows whose observation masks are drawn at random;
a posterior query is then one forward pass (``inference/amortized.py``).
The net sees ``[x * mask, mask]`` (and a do-mask channel when trained
interventionally) and pays the NLL on the unobserved nodes only: a
Gaussian NLL in standardized units for continuous nodes, a cross-entropy
over the fitted class support for categorical ones.

As in the JAX package:

- the masks come from ``numpy.random.default_rng(seed + 17)``, so both
  packages draw the same masks;
- the model-generated rows (``_model_rows``: mutilated-graph samples with
  per-row do-sets, then do-free ancestral samples) ride one mask-dynamic
  sweep (``inference/_dynamic_sweep.py``) on a generator folded from 999;
- the MLP is initialized from a generator folded from 777 and trained by
  the shared minibatch loop (``models/_train.py``) on a sub-stream of it,
  with the masks in the parents slot and the rows in the x slot; only the
  MLP trains, the standardization and the class support ride along.

The products are ``torch.addmm``: the JAX package computes them outside
any Pallas kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.registry import register_learning
from ..core.rng import Draw, fold
from ..core.utils import resolve_verbosity
from ..models._mlp import check_activation, mlp_apply, mlp_init
from ..models._train import fit_minibatch_nll
from ..ops.gauss import diag_gaussian_log_prob, safe_softplus
from .node_wise import NodeWiseLearner

_CATEGORICAL_CPDS = {"categorical_table", "categorical_embedded_softmax"}


@dataclass(frozen=True)
class AmortizedSpec:
    """Static (hashable, JSON-serializable) layout of the amortized net."""

    topo: Tuple[str, ...]
    dims: Tuple[int, ...]
    offsets: Tuple[int, ...]
    total_dim: int
    kinds: Tuple[str, ...]  # "gaussian" | "categorical"
    n_classes: Tuple[int, ...]  # 0 for gaussian nodes
    head_offsets: Tuple[int, ...]
    head_dims: Tuple[int, ...]
    hidden_dims: Tuple[int, ...]
    activation: str
    min_scale: float
    # trained with a do-mask channel on mutilated-graph samples, so it
    # answers p(target | evidence, do(...)) directly
    interventional: bool = False

    @property
    def n_nodes(self) -> int:
        return len(self.topo)

    @property
    def input_dim(self) -> int:
        extra = 2 if self.interventional else 1
        return self.total_dim + extra * self.n_nodes

    @property
    def head_total(self) -> int:
        return sum(self.head_dims)

    def signature(self) -> tuple:
        return (self.topo, self.dims, self.kinds, self.n_classes,
                self.hidden_dims, self.activation, self.min_scale,
                self.interventional)

    def node_index(self, node: str) -> int:
        return self.topo.index(node)

    def to_dict(self) -> Dict:
        return {
            "topo": list(self.topo),
            "dims": list(self.dims),
            "offsets": list(self.offsets),
            "total_dim": self.total_dim,
            "kinds": list(self.kinds),
            "n_classes": list(self.n_classes),
            "head_offsets": list(self.head_offsets),
            "head_dims": list(self.head_dims),
            "hidden_dims": list(self.hidden_dims),
            "activation": self.activation,
            "min_scale": self.min_scale,
            "interventional": self.interventional,
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "AmortizedSpec":
        ints = lambda k: tuple(int(v) for v in d[k])  # noqa: E731
        return cls(
            topo=tuple(d["topo"]),
            dims=ints("dims"),
            offsets=ints("offsets"),
            total_dim=int(d["total_dim"]),
            kinds=tuple(d["kinds"]),
            n_classes=ints("n_classes"),
            head_offsets=ints("head_offsets"),
            head_dims=ints("head_dims"),
            hidden_dims=ints("hidden_dims"),
            activation=str(d["activation"]),
            min_scale=float(d["min_scale"]),
            interventional=bool(d.get("interventional", False)),
        )


def build_spec(vbn, hidden_dims: Sequence[int], activation: str,
               min_scale: float, interventional: bool = False) -> AmortizedSpec:
    topo = tuple(vbn.dag.topological_order())
    dims = tuple(int(vbn.cpd_spec(n).output_dim) for n in topo)
    offsets = tuple(int(v) for v in np.cumsum((0,) + dims[:-1]))
    kinds, n_classes = [], []
    for n, d in zip(topo, dims):
        cpd = vbn.cpd_spec(n)
        if cpd.registry_key in _CATEGORICAL_CPDS and d == 1:
            kinds.append("categorical")
            n_classes.append(int(cpd.support_values(vbn.params[n]).shape[-1]))
        else:
            kinds.append("gaussian")
            n_classes.append(0)
    head_dims = tuple(k if kind == "categorical" else 2 * d
                      for d, kind, k in zip(dims, kinds, n_classes))
    return AmortizedSpec(
        topo=topo,
        dims=dims,
        offsets=offsets,
        total_dim=sum(dims),
        kinds=tuple(kinds),
        n_classes=tuple(n_classes),
        head_offsets=tuple(int(v) for v in np.cumsum((0,) + head_dims[:-1])),
        head_dims=head_dims,
        hidden_dims=tuple(int(h) for h in hidden_dims),
        activation=check_activation(str(activation)),
        min_scale=float(min_scale),
        interventional=bool(interventional),
    )


_EXPAND_CACHE: Dict[tuple, np.ndarray] = {}


def _mask_expand_matrix(spec: AmortizedSpec) -> np.ndarray:
    """[n_nodes, total_dim] constant: node mask -> per-dim mask."""
    sig = spec.signature()
    e = _EXPAND_CACHE.get(sig)
    if e is None:
        e = np.zeros((spec.n_nodes, spec.total_dim), np.float32)
        for i, (off, d) in enumerate(zip(spec.offsets, spec.dims)):
            e[i, off : off + d] = 1.0
        _EXPAND_CACHE[sig] = e
    return e


def amortized_forward(spec: AmortizedSpec, net: Dict, rows: torch.Tensor,
                      mask: torch.Tensor,
                      do_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Trunk forward: rows [M, total_dim] raw values, mask [M, n_nodes]
    (1 = visible: evidence or intervention), do_mask [M, n_nodes] (1 = the
    visible value is a do-intervention) -> head activations
    [M, head_total]."""
    xn = (rows - net["mean"]) / net["std"]
    expand = torch.as_tensor(_mask_expand_matrix(spec), device=rows.device,
                             dtype=rows.dtype)
    parts = [xn * (mask @ expand), mask]
    if spec.interventional:
        parts.append(torch.zeros_like(mask) if do_mask is None else do_mask)
    return mlp_apply(net["mlp"], torch.cat(parts, dim=-1), spec.activation)


def node_distribution(spec: AmortizedSpec, net: Dict, heads: torch.Tensor,
                      idx: int):
    """Node ``idx``'s predicted conditional from the head block: Gaussian
    -> (loc, scale) in raw units; categorical -> (probs, values)."""
    ho = heads[:, spec.head_offsets[idx] : spec.head_offsets[idx]
               + spec.head_dims[idx]]
    off, d = spec.offsets[idx], spec.dims[idx]
    if spec.kinds[idx] == "categorical":
        k = spec.n_classes[idx]
        return torch.softmax(ho, dim=-1), net["support"][idx, :k]
    mean, std = net["mean"][off : off + d], net["std"][off : off + d]
    return (ho[:, :d] * std + mean,
            safe_softplus(ho[:, d:], spec.min_scale) * std)


def masked_nll(spec: AmortizedSpec, net: Dict, mask: torch.Tensor,
               rows: torch.Tensor) -> torch.Tensor:
    """Mean NLL over the unobserved (row, node) pairs. An interventional
    net takes [obs_mask | do_mask] stacked in ``mask``."""
    do_mask = None
    if spec.interventional:
        mask, do_mask = mask[:, : spec.n_nodes], mask[:, spec.n_nodes :]
    # the normalized inputs are masked, so an unobserved dim enters as 0
    heads = amortized_forward(spec, net, rows, mask, do_mask)
    xn = (rows - net["mean"]) / net["std"]
    total = rows.new_zeros(())
    count = rows.new_zeros(())
    for i in range(spec.n_nodes):
        off, d = spec.offsets[i], spec.dims[i]
        unobs = 1.0 - mask[:, i]
        ho = heads[:, spec.head_offsets[i] : spec.head_offsets[i]
                   + spec.head_dims[i]]
        if spec.kinds[i] == "categorical":
            vals = net["support"][i, : spec.n_classes[i]]
            idx = torch.argmin(torch.abs(rows[:, off, None] - vals[None, :]),
                               dim=1)
            logp = torch.log_softmax(ho, dim=-1)
            nll_row = -logp.gather(1, idx[:, None])[:, 0]
        else:
            scale = safe_softplus(ho[:, d:], spec.min_scale)
            nll_row = -diag_gaussian_log_prob(xn[:, off : off + d],
                                              ho[:, :d], scale)
        total = total + torch.sum(unobs * nll_row)
        count = count + torch.sum(unobs)
    return total / torch.clamp(count, min=1.0)


@register_learning("amortized")
class AmortizedLearner:
    """The node-wise fit, then the amortized posterior network."""

    def __init__(
        self,
        default_cpd: str = "gaussian_nn",
        hidden_dims: Sequence[int] = (128, 128),
        activation: str = "relu",
        epochs: int = 150,
        batch_size: int = 512,
        lr: float = 1e-3,
        weight_decay: float = 0.0,
        n_mask_samples: int = 4,
        min_scale: float = 1e-3,
        interventional: bool = True,
        n_do_sets: int = 12,
        n_obs_sets: int = 4,
        **_kwargs,
    ) -> None:
        self.default_cpd = default_cpd
        self.hidden_dims = tuple(int(h) for h in hidden_dims)
        self.activation = check_activation(str(activation))
        self.epochs = int(epochs)
        self.batch_size = int(batch_size)
        self.lr = float(lr)
        self.weight_decay = float(weight_decay)
        self.n_mask_samples = max(1, int(n_mask_samples))
        self.min_scale = float(min_scale)
        # a single-node graph has nothing to intervene on (see fit)
        self.interventional = bool(interventional)
        self.n_do_sets = max(1, int(n_do_sets))
        # do-free model samples widen the evidence patterns past the data's
        self.n_obs_sets = max(0, int(n_obs_sets))
        self._node_wise = NodeWiseLearner(default_cpd=default_cpd)

    def _model_rows(self, vbn, spec, rows, rng, n_int_sets, n_obs_sets):
        """Model-generated training rows (values, obs_masks, do_masks): the
        first ``n_int_sets`` blocks of up to 1024 rows are mutilated-graph
        samples with per-row random do-sets (do values bootstrapped from
        the data's marginals), the last ``n_obs_sets`` blocks do-free
        ancestral samples; all of them one mask-dynamic sweep."""
        from ..core.base import Query
        from ..core.plan import get_plan
        from ..inference._dynamic_sweep import dynamic_sweep_trace

        plan = get_plan(vbn, Query(target=spec.topo[0], evidence={}, do={}))
        cpds = tuple(vbn.cpd_spec(n) for n in plan.topo_order)
        params_tuple = tuple(vbn.params[n] for n in plan.topo_order)
        n = rows.shape[0]
        m_int = min(1024, n) * n_int_sets
        m = m_int + min(1024, n) * n_obs_sets
        p_do = rng.uniform(0.1, 0.5, size=(m, 1)).astype(np.float32)
        do_mask = (rng.random((m, spec.n_nodes)) < p_do).astype(np.float32)
        do_mask[m_int:] = 0.0
        fixed = np.zeros((m, spec.total_dim), np.float32)
        for i in range(spec.n_nodes):
            off, d = spec.offsets[i], spec.dims[i]
            picks = rng.integers(0, n, size=m)
            fixed[:, off : off + d] = rows[picks, off : off + d]
        dom = torch.as_tensor(do_mask, device=vbn.device)
        packed, _ = dynamic_sweep_trace(
            plan, cpds, params_tuple, fold(Draw(vbn.seed, vbn.device), 999),
            torch.as_tensor(fixed, device=vbn.device), torch.zeros_like(dom),
            dom, 1, mesh=vbn._mesh,
        )
        vals = packed[:, 0, :].cpu().numpy().astype(np.float32)
        p_obs = rng.uniform(0.1, 0.9, size=(m, 1)).astype(np.float32)
        obs = (rng.random((m, spec.n_nodes)) < p_obs).astype(np.float32)
        obs = np.maximum(obs, do_mask)  # do'd values are always given
        return vals, obs, do_mask

    def fit(self, vbn, data: Dict[str, np.ndarray],
            verbose: Optional[int] = None, **kwargs):
        verbosity = resolve_verbosity(verbose)
        self._node_wise.fit(vbn, data, verbose=verbose, **kwargs)

        spec = build_spec(vbn, self.hidden_dims, self.activation,
                          self.min_scale,
                          interventional=self.interventional and len(vbn.dag) > 1)
        rows = np.concatenate(
            [np.asarray(data[n], np.float32) for n in spec.topo], axis=-1)
        n = rows.shape[0]
        rng = np.random.default_rng(vbn.seed + 17)
        reps, masks = [], []
        for _ in range(self.n_mask_samples):
            p_obs = rng.uniform(0.1, 0.9, size=(n, 1)).astype(np.float32)
            masks.append(
                (rng.random((n, spec.n_nodes)) < p_obs).astype(np.float32))
            reps.append(rows)
        rows_rep = np.concatenate(reps, axis=0)
        masks_rep = np.concatenate(masks, axis=0)
        do_rep = np.zeros_like(masks_rep)
        n_int_sets = self.n_do_sets if spec.interventional else 0
        if n_int_sets or self.n_obs_sets:
            mod_rows, mod_masks, mod_dos = self._model_rows(
                vbn, spec, rows, rng, n_int_sets, self.n_obs_sets)
            rows_rep = np.concatenate([rows_rep, mod_rows], axis=0)
            masks_rep = np.concatenate([masks_rep, mod_masks], axis=0)
            do_rep = np.concatenate([do_rep, mod_dos], axis=0)
        if spec.interventional:  # [obs_mask | do_mask] in the parents slot
            masks_rep = np.concatenate([masks_rep, do_rep], axis=1)

        k_max = max([1] + [k for k in spec.n_classes if k > 0])
        support = np.zeros((spec.n_nodes, k_max), np.float32)
        for i, node in enumerate(spec.topo):
            if spec.kinds[i] == "categorical":
                vals = vbn.cpd_spec(node).support_values(
                    vbn.params[node]).reshape(-1)[: spec.n_classes[i]]
                support[i, : vals.numel()] = vals.cpu().numpy()
        dev = vbn.device
        draw = fold(Draw(vbn.seed, dev), 777)
        net = {
            "mlp": mlp_init(draw.generator, spec.input_dim, spec.hidden_dims,
                            spec.head_total, dev),
            "mean": torch.as_tensor(rows.mean(axis=0), device=dev),
            "std": torch.as_tensor(np.maximum(rows.std(axis=0), 1e-6),
                                   device=dev),
            "support": torch.as_tensor(support, device=dev),
        }
        frozen = {k: net[k] for k in ("mean", "std", "support")}
        net["mlp"], _opt = fit_minibatch_nll(
            lambda mlp, mask, rows_: masked_nll(
                spec, {**frozen, "mlp": mlp}, mask, rows_),
            net["mlp"], None, fold(draw, 1).generator,
            torch.as_tensor(masks_rep, device=dev),
            torch.as_tensor(rows_rep, device=dev),
            epochs=self.epochs, batch_size=self.batch_size, lr=self.lr,
            weight_decay=self.weight_decay,
        )
        vbn.amortized = {"net": net, "spec": spec}
        if verbosity >= 1:
            print(f"[amortized] trained posterior net ({spec.input_dim}->"
                  f"{spec.hidden_dims}->{spec.head_total})")
        return vbn.nodes
