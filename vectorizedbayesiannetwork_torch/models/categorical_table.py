"""Exact tabular categorical CPD with Dirichlet/Laplace smoothing.

Port of ``vectorizedbayesiannetwork_tpu/models/categorical_table.py``:
declared-or-inferred parent/class supports (resolved on the host at fit
time into static spec state), mixed-radix parent indexing, counts by one
scatter-add with ``alpha_mode`` in {per_class, total_mass} and ``prior`` in
{uniform, global}, class-mask padding for ragged supports, and inverse-CDF
sampling over the count rows. ``categorical_probs`` and ``support_values``
are the protocol the exact engines and ``core/handle.py`` read.

``_noise_spec`` says the inverse CDF's uniforms (its declared ``_draws``)
do not depend on the parents, so Gibbs draws all its steps' uniforms
ahead of its loop (the JAX package takes a Gumbel field there for C = 1
or C >= 128; the port draws every C by inverse CDF: the same
distribution). ``update`` refits (the base class's default); with declared
supports ``update_program`` recounts against the stored support tables,
after ``update_host_precheck`` checks the rows lie in them.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.base import BaseCPD, Params
from ..core.registry import register_cpd
from ..core.rng import uniforms


def _index_of(values: torch.Tensor, mask: torch.Tensor, x: torch.Tensor):
    """Masked comparison count: x [M, D] against supports [D, K] -> [M, D]."""
    less = (values[None, :, :] < x[:, :, None]) & mask[None, :, :]
    return less.sum(dim=-1)


def _accumulate_counts(
    p, x, class_values, class_mask, pv, pv_mask, strides,
    *, p_states: int, c: int, alpha: float, alpha_mode: str, prior: str,
):
    """[Dout, P, C] float32 smoothed counts, as the JAX scatter-add."""
    n, dout = x.shape
    dev = x.device
    if p.shape[1] == 0:
        parent_idx = torch.zeros((n,), dtype=torch.int64, device=dev)
    else:
        parent_idx = (_index_of(pv, pv_mask, p) * strides[None, :]).sum(-1)
    target_idx = _index_of(class_values, class_mask, x)  # [N, Dout]
    ones = torch.ones((n,), dtype=torch.float32, device=dev)
    flat = parent_idx[:, None] * c + target_idx
    counts = torch.stack(
        [
            torch.zeros((p_states * c,), dtype=torch.float32, device=dev)
            .index_add_(0, flat[:, d], ones)
            for d in range(dout)
        ]
    ).reshape(dout, p_states, c)
    mask_f = class_mask.to(torch.float32)
    if alpha > 0:
        uniform = mask_f / torch.clamp(mask_f.sum(1, keepdim=True), min=1e-12)
        if prior == "uniform":
            prior_probs = uniform
        else:  # global empirical marginal
            marg = torch.stack(
                [
                    torch.zeros((c,), dtype=torch.float32, device=dev)
                    .index_add_(0, target_idx[:, d], ones)
                    for d in range(dout)
                ]
            ) * mask_f
            denom = marg.sum(1, keepdim=True)
            prior_probs = torch.where(
                denom > 1e-12, marg / torch.clamp(denom, min=1e-12), uniform
            )
        prior_mass = alpha * c if alpha_mode == "per_class" else alpha
        counts = counts + prior_mass * prior_probs[:, None, :]
    return counts * mask_f[:, None, :]


@register_cpd("categorical_table")
class CategoricalTableCPD(BaseCPD):
    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        *,
        seed: Optional[int] = None,
        n_classes: int = 0,
        parent_n_classes: Optional[List[int]] = None,
        alpha: float = 1.0,
        alpha_mode: str = "per_class",
        prior: str = "uniform",
        **_ignored,
    ) -> None:
        super().__init__(input_dim, output_dim, seed=seed)
        self.n_classes = int(n_classes)
        self.parent_n_classes = (
            [int(v) for v in parent_n_classes]
            if parent_n_classes is not None
            else None
        )
        self.alpha = float(alpha)
        self.alpha_mode = str(alpha_mode).lower().strip()
        self.prior = str(prior).lower().strip()
        if self.alpha < 0:
            raise ValueError("alpha must be >= 0")
        if self.alpha_mode not in {"per_class", "total_mass"}:
            raise ValueError("alpha_mode must be 'per_class' or 'total_mass'")
        if self.prior not in {"uniform", "global"}:
            raise ValueError("prior must be 'uniform' or 'global'")
        # Fit-time-resolved static structure:
        self.parent_cards: Optional[Tuple[int, ...]] = None
        self.max_parent_card: int = 0
        self.resolved_classes: int = max(self.n_classes, 0)

    def get_init_kwargs(self):
        return {
            "n_classes": self.n_classes,
            "parent_n_classes": self.parent_n_classes,
            "alpha": self.alpha,
            "alpha_mode": self.alpha_mode,
            "prior": self.prior,
        }

    def get_extra_state(self):
        return {
            "parent_cards": (
                list(self.parent_cards) if self.parent_cards is not None else None
            ),
            "max_parent_card": self.max_parent_card,
            "resolved_classes": self.resolved_classes,
        }

    def set_extra_state(self, state) -> None:
        if not state:
            return
        pc = state.get("parent_cards")
        self.parent_cards = tuple(pc) if pc is not None else None
        self.max_parent_card = int(state.get("max_parent_card", 0))
        self.resolved_classes = int(
            state.get("resolved_classes", self.n_classes)
        )

    def _static_fields(self) -> tuple:
        return (
            self.alpha,
            self.alpha_mode,
            self.prior,
            self.parent_cards,
            self.max_parent_card,
            self.resolved_classes,
        )

    @property
    def _strides(self) -> Tuple[int, ...]:
        strides = []
        s = 1
        for card in reversed(self.parent_cards or ()):
            strides.append(s)
            s *= card
        return tuple(reversed(strides))

    @property
    def _parent_states(self) -> int:
        s = 1
        for card in self.parent_cards or ():
            s *= card
        return s

    def init(self, device, gen=None) -> Params:
        return {}

    @staticmethod
    def _check_in_support(col, support, label):
        if not np.isin(col, support).all():
            raise ValueError(f"Found values outside support for {label}.")

    def fit(self, params, parents, x, *, device, **_training) -> Params:
        x_np = np.asarray(x, np.float32).reshape(-1, self.output_dim)
        n = x_np.shape[0]
        if parents is None:
            p_np = np.zeros((n, 0), np.float32)
        else:
            p_np = np.asarray(parents, np.float32).reshape(n, -1)
        if p_np.shape[-1] != self.input_dim:
            raise ValueError(
                f"Expected parents_dim {self.input_dim}, got {p_np.shape[-1]}"
            )

        # ---- host-side support inference (static spec refinement) ----
        parent_values: List[np.ndarray] = []
        cards: List[int] = []
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
                self._check_in_support(p_np[:, d], support, f"parent {d}")
                parent_values.append(support)
                cards.append(int(card))
        else:
            for d in range(self.input_dim):
                uniq = np.unique(p_np[:, d])
                parent_values.append(uniq)
                cards.append(int(uniq.size))
        self.parent_cards = tuple(cards)
        self.max_parent_card = max(cards, default=0)

        class_values: List[np.ndarray] = []
        class_counts: List[int] = []
        if self.n_classes > 0:
            support = np.arange(self.n_classes, dtype=np.float32)
            for d in range(self.output_dim):
                self._check_in_support(x_np[:, d], support, f"target dim {d}")
                class_values.append(support)
                class_counts.append(self.n_classes)
            c = self.n_classes
        else:
            for d in range(self.output_dim):
                uniq = np.unique(x_np[:, d])
                class_values.append(uniq)
                class_counts.append(int(uniq.size))
            c = max(class_counts, default=1)
        self.resolved_classes = int(c)

        class_values_pad = np.zeros((self.output_dim, c), np.float32)
        class_mask = np.zeros((self.output_dim, c), bool)
        for d, k in enumerate(class_counts):
            class_values_pad[d, :k] = class_values[d]
            class_mask[d, :k] = True
        pv_pad = np.zeros(
            (self.input_dim, max(self.max_parent_card, 1)), np.float32
        )
        pv_mask = np.zeros_like(pv_pad, dtype=bool)
        for d in range(self.input_dim):
            pv_pad[d, : cards[d]] = parent_values[d]
            pv_mask[d, : cards[d]] = True

        new = {
            "class_values": torch.as_tensor(class_values_pad, device=device),
            "class_mask": torch.as_tensor(class_mask, device=device),
            "parent_values": torch.as_tensor(pv_pad, device=device),
            "parent_mask": torch.as_tensor(pv_mask, device=device),
        }
        new["counts"] = _accumulate_counts(
            torch.as_tensor(p_np, device=device),
            torch.as_tensor(x_np, device=device),
            new["class_values"],
            new["class_mask"],
            new["parent_values"],
            new["parent_mask"],
            torch.as_tensor(self._strides, dtype=torch.int64, device=device),
            p_states=int(self._parent_states),
            c=int(c),
            alpha=self.alpha,
            alpha_mode=self.alpha_mode,
            prior=self.prior,
        )
        return new

    # -- flat primitives -----------------------------------------------------
    def _parents_to_index(self, params: Params, parents, m: int):
        """[M, Din] float parent values -> [M] mixed-radix row index."""
        if self.input_dim == 0:
            return None
        idx_d = _index_of(params["parent_values"], params["parent_mask"], parents)
        strides = torch.as_tensor(
            self._strides, dtype=torch.int64, device=parents.device
        )
        return (idx_d * strides[None, :]).sum(-1)

    def _rows(self, params: Params, pidx, d: int, m: int) -> torch.Tensor:
        """[M, C] count rows of output dim ``d`` (broadcast for roots).
        Parent values past the support clamp to the last row, as the fused
        sweep clamps its fixed values."""
        cnt = params["counts"][d]  # [P, C]
        if pidx is None:
            return cnt[0].expand(m, cnt.shape[1])
        return cnt[torch.clamp(pidx, max=cnt.shape[0] - 1)]

    def categorical_probs(self, params: Params, parents) -> torch.Tensor:
        """Class probabilities given flat parents [M, Din] (None for a root:
        M = 1): [M, C] for one output column, else [M, Dout, C]; each
        probability floored at 1e-12 as the log-density floors it."""
        m = 1 if parents is None else parents.shape[0]
        pidx = self._parents_to_index(params, parents, m)
        rows = torch.stack(
            [self._rows(params, pidx, d, m) for d in range(self.output_dim)], 1
        )  # [M, Dout, C]
        probs = rows / torch.clamp(rows.sum(-1, keepdim=True), min=1e-12)
        probs = torch.exp(torch.log(torch.clamp(probs, min=1e-12)))
        return probs[:, 0] if self.output_dim == 1 else probs

    def support_values(self, params: Params) -> torch.Tensor:
        """[Dout, C] class values (the exact engines' support grid)."""
        return params["class_values"]

    def _inverse_cdf(self, params, pidx, d: int, u, m: int):
        """Class = #{j >= 1 : cum_{j-1} <= u * total} of output dim ``d``."""
        cum = torch.cumsum(self._rows(params, pidx, d, m), dim=-1)
        thresh = u * cum[:, -1]
        idx = (cum[:, :-1] <= thresh[:, None]).sum(-1)
        return params["class_values"][d][idx]

    def _sample_flat(self, params, gen, parents, m):
        """Inverse-CDF draw, one uniform a row and output dim (slot d)."""
        pidx = self._parents_to_index(params, parents, m)
        u = uniforms(gen, m, self.output_dim, params["class_values"].device)
        return torch.stack([
            self._inverse_cdf(params, pidx, d, u[:, d], m)
            for d in range(self.output_dim)], dim=-1)

    def _draws(self):
        return ((self.output_dim, 0, False),)

    def _noise_spec(self, params, m):
        return ((m, self.output_dim), "uniform")

    # -- online update -------------------------------------------------------
    def update_program(self, conf):
        """The recount against the stored supports, for DECLARED supports
        (``n_classes`` and, with parents, ``parent_n_classes``); None when
        a support is inferred (the eager update may refine it from the
        data) or the node is not fitted yet."""
        if self.n_classes <= 0 or (
            self.input_dim > 0 and self.parent_n_classes is None
        ):
            return None
        if self.input_dim > 0 and not self.parent_cards:
            return None
        p_states = int(self._parent_states)
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
            counts = _accumulate_counts(
                p_t, x_t, params["class_values"], params["class_mask"],
                params["parent_values"], params["parent_mask"],
                torch.as_tensor(self._strides, dtype=torch.int64,
                                device=device),
                p_states=p_states, c=c, alpha=self.alpha,
                alpha_mode=self.alpha_mode, prior=self.prior,
            )
            return {**params, "counts": counts}

        return fn

    def update_host_precheck(self, params, parents, x) -> None:
        """The declared-support membership checks the eager fit raises."""
        x_np = np.asarray(x, np.float32).reshape(-1, self.output_dim)
        support = np.arange(max(self.n_classes, 1), dtype=np.float32)
        for d in range(self.output_dim):
            self._check_in_support(x_np[:, d], support, f"target dim {d}")
        if self.input_dim and parents is not None:
            p_np = np.asarray(parents, np.float32).reshape(-1, self.input_dim)
            for d, card in enumerate(self.parent_n_classes or []):
                self._check_in_support(
                    p_np[:, d], np.arange(int(card), dtype=np.float32),
                    f"parent {d}")

    def _log_prob_flat(self, params, x, parents):
        m = x.shape[0]
        pidx = self._parents_to_index(params, parents, m)
        tidx = _index_of(params["class_values"], params["class_mask"], x)
        out = torch.zeros((m,), dtype=torch.float32, device=x.device)
        for d in range(self.output_dim):
            rows = self._rows(params, pidx, d, m)
            total = rows.sum(-1)
            t = tidx[:, d : d + 1]
            c = rows.shape[1]
            # a value past the support selects no class (probability 0)
            cnt_sel = rows.gather(1, torch.clamp(t, max=c - 1))[:, 0]
            cnt_sel = torch.where(t[:, 0] < c, cnt_sel, 0.0)
            prob = cnt_sel / torch.clamp(total, min=1e-12)
            out = out + torch.log(torch.clamp(prob, min=1e-12))
        return out
