"""Categorical CPD with learned embeddings of discrete parents.

Port of
``vectorizedbayesiannetwork_tpu/models/categorical_embedded_softmax.py``:

- supports resolved on the host at fit time (numpy, the JAX package's
  code): declared (``n_classes``, ``parent_n_classes``: 0..k-1) or the
  unique values seen, padded to the largest class count with a mask;
- one embedding table a parent (``emb/e{i}``, N(0, 1) init as torch's
  ``nn.Embedding``), their concatenation through the MLP to class logits,
  invalid classes masked to -1e9;
- a rebuilt module starts its class logits at the empirical
  log-marginal (the root's optimum, the last layer's bias otherwise);
- cross-entropy with label smoothing and optional inverse-frequency class
  weights, averaged as torch's weighted ``cross_entropy`` (sum(w ce) /
  sum(w)); training continues from the fitted params while the supports
  are unchanged;
- ``categorical_probs`` / ``support_values`` (the protocol
  ``categorical_exact`` and ``core/handle.py`` read) and the resolved
  supports through ``get_extra_state`` / ``set_extra_state``.

Values map to indices by a masked comparison count against the sorted
supports, as in the JAX package. A draw picks a class by Gumbel-argmax
over the masked logits, as the JAX package does (from the caller's
generator: the same distribution, not the same draws).

``update`` is the fit's training for ``n_steps`` epochs with the optional
``ema_alpha`` shadow (it continues from the stored params while the
supports are unchanged); with declared supports ``update_program`` trains
against the stored support tables, after ``update_host_precheck`` checks
the rows lie in them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.base import BaseCPD, Params
from ..core.registry import register_cpd
from ._mlp import check_activation, mlp_apply, mlp_init, resolve_compute_dtype
from ._train import fit_minibatch_nll
from .mdn import gumbel_pick
from .softmax_nn import inverse_freq_weights

_NEG = -1e9


@register_cpd("categorical_embedded_softmax")
class CategoricalEmbeddedSoftmaxCPD(BaseCPD):
    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        *,
        seed: Optional[int] = None,
        n_classes: int = 0,
        parent_n_classes: Optional[List[int]] = None,
        embedding_dim: int = 8,
        hidden_dims: Sequence[int] = (64, 64),
        activation: str = "relu",
        label_smoothing: float = 0.0,
        class_weighting: str = "none",
        max_grad_norm: Optional[float] = None,
        compute_dtype: str = "float32",
        **_ignored,
    ) -> None:
        super().__init__(input_dim, output_dim, seed=seed)
        self.n_classes = int(n_classes)
        self.parent_n_classes = (
            [int(v) for v in parent_n_classes]
            if parent_n_classes is not None else None
        )
        self.embedding_dim = int(embedding_dim)
        self.hidden_dims = tuple(int(h) for h in hidden_dims)
        self.activation = check_activation(str(activation))
        self.label_smoothing = float(label_smoothing)
        self.class_weighting = str(class_weighting).lower().strip()
        self.max_grad_norm = max_grad_norm
        resolve_compute_dtype(compute_dtype)
        self.compute_dtype = str(compute_dtype)
        if self.embedding_dim <= 0:
            raise ValueError("embedding_dim must be >= 1")
        if self.class_weighting not in {"none", "inverse_freq"}:
            raise ValueError("class_weighting must be 'none' or 'inverse_freq'")
        # fit-resolved static structure
        self.parent_cards: Optional[Tuple[int, ...]] = None
        self.resolved_classes: int = max(self.n_classes, 0)
        self.ready = False

    def get_init_kwargs(self):
        return {
            "n_classes": self.n_classes,
            "parent_n_classes": self.parent_n_classes,
            "embedding_dim": self.embedding_dim,
            "hidden_dims": list(self.hidden_dims),
            "activation": self.activation,
            "label_smoothing": self.label_smoothing,
            "class_weighting": self.class_weighting,
            "max_grad_norm": self.max_grad_norm,
            "compute_dtype": self.compute_dtype,
        }

    def get_extra_state(self):
        return {
            "parent_cards": (list(self.parent_cards)
                             if self.parent_cards is not None else None),
            "resolved_classes": self.resolved_classes,
            "ready": self.ready,
        }

    def set_extra_state(self, state) -> None:
        if not state:
            return
        pc = state.get("parent_cards")
        self.parent_cards = tuple(pc) if pc is not None else None
        self.resolved_classes = int(state.get("resolved_classes",
                                              self.n_classes))
        self.ready = bool(state.get("ready", False))

    def _static_fields(self) -> tuple:
        return (
            self.embedding_dim, self.hidden_dims, self.activation,
            self.label_smoothing, self.class_weighting, self.parent_cards,
            self.resolved_classes, self.ready, self.compute_dtype,
        )

    # -- lifecycle ----------------------------------------------------------
    def init(self, device, gen: Optional[torch.Generator] = None) -> Params:
        """Empty: the module is built at fit time, once the supports are
        known."""
        return {}

    def _build_params(self, gen: torch.Generator, device) -> Params:
        c = max(self.resolved_classes, 1)
        d = self.output_dim
        if self.input_dim == 0:
            net = {"logits": torch.zeros((d, c), dtype=torch.float32,
                                         device=device)}
            emb = {}
        else:
            net = mlp_init(gen, self.embedding_dim * self.input_dim,
                           self.hidden_dims, d * c, device)
            emb = {f"e{i}": torch.randn((card, self.embedding_dim),
                                        generator=gen, dtype=torch.float32,
                                        device=device)
                   for i, card in enumerate(self.parent_cards or ())}
        return {"net": net, "emb": emb, "opt": None}

    # -- host-side support inference -----------------------------------------
    def _resolve_supports(self, p_np: np.ndarray, x_np: np.ndarray):
        cards: List[int] = []
        parent_values: List[np.ndarray] = []
        if self.parent_n_classes is not None:
            if len(self.parent_n_classes) != self.input_dim:
                raise ValueError(
                    f"parent_n_classes length {len(self.parent_n_classes)} "
                    f"does not match input_dim {self.input_dim}."
                )
            for d, card in enumerate(self.parent_n_classes):
                if int(card) <= 0:
                    raise ValueError(
                        f"Invalid parent cardinality {card} at index {d}."
                    )
                support = np.arange(int(card), dtype=np.float32)
                if not np.isin(p_np[:, d], support).all():
                    raise ValueError(
                        f"Found values outside support for parent {d}."
                    )
                parent_values.append(support)
                cards.append(int(card))
        else:
            for d in range(self.input_dim):
                uniq = np.unique(p_np[:, d].astype(np.float32))
                parent_values.append(uniq)
                cards.append(int(uniq.size))

        declared = self.n_classes if self.n_classes > 0 else None
        class_values: List[np.ndarray] = []
        counts: List[int] = []
        if declared is not None:
            for d in range(self.output_dim):
                support = np.arange(declared, dtype=np.float32)
                if not np.isin(x_np[:, d], support).all():
                    raise ValueError(
                        f"Found values outside support for target dim {d}."
                    )
                class_values.append(support)
                counts.append(declared)
            c = declared
        else:
            for d in range(self.output_dim):
                uniq = np.unique(x_np[:, d].astype(np.float32))
                class_values.append(uniq)
                counts.append(int(uniq.size))
            c = max(counts, default=1)
        cv_pad = np.zeros((self.output_dim, c), np.float32)
        cm = np.zeros((self.output_dim, c), bool)
        for d in range(self.output_dim):
            if counts[d] > c:
                raise ValueError(
                    f"Found {counts[d]} classes for dim {d}, but n_classes={c}."
                )
            cv_pad[d, : counts[d]] = class_values[d]
            cm[d, : counts[d]] = True
        return parent_values, tuple(cards), cv_pad, cm, int(c)

    # -- index mapping --------------------------------------------------------
    def _parents_to_indices(self, params, parents: torch.Tensor):
        """[M, Din] values -> [M, Din] int64 indices."""
        if self.input_dim == 0:
            return torch.zeros((parents.shape[0], 0), dtype=torch.int64,
                               device=parents.device)
        less = (params["parent_values"][None] < parents[:, :, None]) & \
            params["parent_mask"].bool()[None]
        return less.sum(dim=-1)

    def _targets_to_indices(self, params, x: torch.Tensor):
        less = (params["class_values"][None] < x[:, :, None]) & \
            (params["class_mask"] > 0.5)[None]
        return less.sum(dim=-1)

    # -- logits ---------------------------------------------------------------
    def _embed(self, net_emb, parent_idx: torch.Tensor) -> torch.Tensor:
        emb = net_emb["emb"]
        return torch.cat([emb[f"e{i}"][parent_idx[:, i]]
                          for i in range(self.input_dim)], dim=-1)

    def _masked_logits_from_idx(self, net_emb, class_mask, parent_idx, m,
                                dt=None):
        c = max(self.resolved_classes, 1)
        if self.input_dim == 0:
            logits = net_emb["net"]["logits"][None].expand(
                m, self.output_dim, c)
        else:
            logits = mlp_apply(net_emb["net"], self._embed(net_emb, parent_idx),
                               self.activation, dt).reshape(
                                   m, self.output_dim, c)
        return torch.where(class_mask[None] > 0.5, logits, _NEG)

    # -- training -------------------------------------------------------------
    def _nll(self, net_emb, parent_idx_f, targets_f, aux):
        m = targets_f.shape[0]
        c = max(self.resolved_classes, 1)
        t = targets_f.long()
        logits = self._masked_logits_from_idx(
            net_emb, aux["class_mask"], parent_idx_f.long(), m)
        log_probs = torch.log_softmax(logits, dim=-1)
        one_hot = torch.nn.functional.one_hot(t, c).float()
        eps = self.label_smoothing
        if eps > 0:
            one_hot = (1.0 - eps) * one_hot + eps / c
        ce = -torch.sum(one_hot * log_probs, dim=-1)  # [M, Dout]
        w = aux["class_weights"][t]  # [M, Dout]
        # torch cross_entropy(weight=...) mean: sum(w * ce) / sum(w)
        return torch.sum(w * ce) / torch.clamp(torch.sum(w), min=1e-12)

    def _train(self, params, parents, x, *, device, gen, steps, batch_size,
               lr, weight_decay, max_grad_norm, ema_alpha=None):
        x_np = np.asarray(x, np.float32).reshape(-1, self.output_dim)
        n = x_np.shape[0]
        p_np = (np.zeros((n, 0), np.float32) if parents is None
                else np.asarray(parents, np.float32).reshape(n, -1))
        parent_values, cards, cv_pad, cm, c = self._resolve_supports(p_np, x_np)
        rebuild = (not self.ready or self.parent_cards != cards
                   or self.resolved_classes != c or "net" not in params)
        self.parent_cards = cards
        self.resolved_classes = c
        max_card = max(cards, default=1)
        pv_pad = np.zeros((self.input_dim, max_card), np.float32)
        pv_mask = np.zeros_like(pv_pad, bool)
        for d in range(self.input_dim):
            pv_pad[d, : cards[d]] = parent_values[d]
            pv_mask[d, : cards[d]] = True
        if rebuild:
            params = self._build_params(gen, device)
            # the class logits start at the empirical log-marginal
            t_idx = np.zeros(x_np.shape, np.int64)
            for d in range(self.output_dim):
                t_idx[:, d] = np.searchsorted(cv_pad[d, cm[d]], x_np[:, d])
            hist = np.stack([np.bincount(t_idx[:, d], minlength=c)
                             for d in range(self.output_dim)]
                            ).astype(np.float64)
            hist = (hist + 1.0) / (hist.sum(axis=1, keepdims=True) + c)
            log_marg = torch.as_tensor(
                np.where(cm, np.log(hist), 0.0).astype(np.float32),
                device=device)
            if self.input_dim == 0:
                params["net"]["logits"] = log_marg
            else:
                params["net"]["layers"][-1]["b"] = log_marg.reshape(-1)
        tables = {"class_values": cv_pad, "class_mask": cm.astype(np.float32),
                  "parent_values": pv_pad, "parent_mask": pv_mask}
        params = {**params, **{k: torch.as_tensor(v, device=device)
                               for k, v in tables.items()}}
        parent_idx = self._parents_to_indices(
            params, torch.as_tensor(p_np, device=device)).float()
        targets = self._targets_to_indices(
            params, torch.as_tensor(x_np, device=device))
        w = (inverse_freq_weights(targets.cpu().numpy(), c)
             if self.class_weighting == "inverse_freq"
             else np.ones((c,), np.float32))
        aux = {"class_weights": torch.as_tensor(w, device=device),
               "class_mask": params["class_mask"]}
        net_emb = {"net": params["net"], "emb": params.get("emb", {})}
        new_net_emb, opt = fit_minibatch_nll(
            self._nll, net_emb, params.get("opt"), gen, parent_idx,
            targets.float(), epochs=steps, batch_size=batch_size, lr=lr,
            weight_decay=weight_decay,
            max_grad_norm=(max_grad_norm if max_grad_norm is not None
                           else self.max_grad_norm),
            aux=aux, ema_alpha=ema_alpha,
        )
        self.ready = True
        return {**params, "net": new_net_emb["net"],
                "emb": new_net_emb["emb"], "opt": opt}

    def fit(self, params, parents, x, *, device, gen=None, epochs: int = 1,
            lr: float = 1e-3, batch_size: int = 128,
            weight_decay: float = 0.0, max_grad_norm=None, **_kwargs):
        return self._train(params, parents, x, device=device, gen=gen,
                           steps=epochs, batch_size=batch_size, lr=lr,
                           weight_decay=weight_decay,
                           max_grad_norm=max_grad_norm)

    def update(self, params, parents, x, *, device, gen=None, lr=1e-3,
               n_steps: int = 1, batch_size: int = 128,
               weight_decay: float = 0.0, max_grad_norm=None,
               ema_alpha=None, **_kwargs):
        return self._train(params, parents, x, device=device, gen=gen,
                           steps=n_steps, batch_size=batch_size, lr=lr,
                           weight_decay=weight_decay,
                           max_grad_norm=max_grad_norm, ema_alpha=ema_alpha)

    def update_program(self, conf):
        """Training against the stored support tables, for a fitted node
        with DECLARED supports; None otherwise (the eager update may
        refine the supports from the data)."""
        if not self.ready or self.n_classes <= 0:
            return None
        if self.input_dim > 0 and self.parent_n_classes is None:
            return None
        conf = dict(conf)
        c = int(self.resolved_classes)

        def fn(params, gen, parents, x, *, device):
            x_t = torch.as_tensor(
                np.asarray(x, np.float32).reshape(-1, self.output_dim),
                device=device)
            n = x_t.shape[0]
            p_t = (torch.zeros((n, 0), dtype=torch.float32, device=device)
                   if parents is None else torch.as_tensor(
                       np.asarray(parents, np.float32).reshape(n, -1),
                       device=device))
            parent_idx = self._parents_to_indices(params, p_t).float()
            targets = self._targets_to_indices(params, x_t)
            if self.class_weighting == "inverse_freq":
                counts = torch.bincount(targets.reshape(-1), minlength=c
                                        ).float()
                w = counts.sum() / torch.clamp(counts, min=1.0)
                w = w / torch.clamp(w.mean(), min=1e-12)
            else:
                w = torch.ones((c,), dtype=torch.float32, device=device)
            aux = {"class_weights": w, "class_mask": params["class_mask"]}
            net_emb = {"net": params["net"], "emb": params.get("emb", {})}
            mgn = conf.get("max_grad_norm")
            new_net_emb, opt = fit_minibatch_nll(
                self._nll, net_emb, params.get("opt"), gen, parent_idx,
                targets.float(), epochs=conf.get("n_steps", 1),
                batch_size=conf.get("batch_size", 128),
                lr=conf.get("lr", 1e-3),
                weight_decay=conf.get("weight_decay", 0.0),
                max_grad_norm=mgn if mgn is not None else self.max_grad_norm,
                aux=aux, ema_alpha=conf.get("ema_alpha"),
            )
            return {**params, "net": new_net_emb["net"],
                    "emb": new_net_emb["emb"], "opt": opt}

        return fn

    def update_host_precheck(self, params, parents, x) -> None:
        """The declared-support membership checks the eager path raises."""
        x_np = np.asarray(x, np.float32).reshape(-1, self.output_dim)
        support = np.arange(max(self.n_classes, 1), dtype=np.float32)
        for d in range(self.output_dim):
            if not np.isin(x_np[:, d], support).all():
                raise ValueError(
                    f"Found values outside support for target dim {d}.")
        if self.input_dim and parents is not None:
            p_np = np.asarray(parents, np.float32).reshape(-1, self.input_dim)
            for d, card in enumerate(self.parent_n_classes or []):
                if not np.isin(p_np[:, d],
                               np.arange(int(card), dtype=np.float32)).all():
                    raise ValueError(
                        f"Found values outside support for parent {d}.")

    # -- protocol and flat primitives -------------------------------------------
    def _logits_flat(self, params, parents, m: int):
        if not self.ready:
            raise RuntimeError(
                "CategoricalEmbeddedSoftmaxCPD is not fitted yet.")
        if self.input_dim == 0:
            parent_idx = None
        else:
            parent_idx = self._parents_to_indices(params, parents)
        net_emb = {"net": params["net"], "emb": params.get("emb", {})}
        return self._masked_logits_from_idx(
            net_emb, params["class_mask"], parent_idx, m,
            resolve_compute_dtype(self.compute_dtype))

    def support_values(self, params: Params) -> torch.Tensor:
        """[Dout, C] class values."""
        return params["class_values"]

    def categorical_probs(self, params: Params, parents):
        m = 1 if parents is None else parents.shape[0]
        probs = torch.softmax(self._logits_flat(params, parents, m), dim=-1)
        return probs[:, 0, :] if self.output_dim == 1 else probs

    def _sample_flat(self, params, gen, parents, m):
        idx = gumbel_pick(self._logits_flat(params, parents, m), gen)
        return params["class_values"][None].expand(m, -1, -1).gather(
            2, idx[..., None])[..., 0]

    def _draws(self):
        return ((self.output_dim * max(self.resolved_classes, 1), 0, False),)

    def _vmappable(self) -> bool:
        return resolve_compute_dtype(self.compute_dtype) is None

    def _log_prob_flat(self, params, x, parents):
        log_probs = torch.log_softmax(
            self._logits_flat(params, parents, x.shape[0]), dim=-1)
        tidx = self._targets_to_indices(params, x)
        c = log_probs.shape[-1]
        # a value past every class picks nothing (the JAX one-hot is zero)
        picked = log_probs.gather(2, torch.clamp(tidx, max=c - 1)[..., None])
        return torch.where(tidx < c, picked[..., 0], 0.0).sum(dim=-1)
