"""Binned-categorical CPD over continuous targets (a softmax classifier).

Port of ``vectorizedbayesiannetwork_tpu/models/softmax_nn.py``:

- bins built on the host at fit time (numpy, the JAX package's code):
  uniform, gaussian (normal quantiles through ``_erfinv``) or quantile
  edges with a minimum bin width, and per-dimension discrete detection (a
  dimension with exactly ``n_classes`` unique values is discrete: its
  classes are those values);
- cross-entropy training on the bin indices, with label smoothing and
  optional inverse-frequency class weights;
- a root fast path: the empirical histogram's log-probabilities, no
  training;
- within-bin densities and draws, uniform / triangular / gaussian, with a
  log-density of -inf outside the bin unless ``within_bin_clip``;
- ``categorical_probs`` / ``support_values`` (the protocol
  ``categorical_exact`` and ``core/handle.py`` read) and ``bins_ready`` /
  ``root_ready`` through ``get_extra_state`` / ``set_extra_state``.

A draw picks a bin by Gumbel-argmax, as the JAX package does (from the
caller's generator: the same distribution, not the same draws).

``update`` continues Adam from the stored ``opt`` state for ``n_steps``
epochs (the root refits its histogram), keeping the bins but for the
JAX package's expansion: new rows past the stored range rebuild the edges
over the widened range; a discrete dimension refuses values outside its
classes. Not ported: ``debug_mode`` (a dict of four settings) and the
fixed ``temperature`` of 1, by which the JAX package divides its logits.
"""

from __future__ import annotations

from math import erf
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.base import BaseCPD, Params
from ..core.registry import register_cpd
from ..core.rng import next_slot, normals, uniforms
from ..ops.gauss import LOG_2PI
from ._mlp import check_activation, mlp_apply, mlp_init, resolve_compute_dtype
from ._train import as_rows, fit_minibatch_nll
from .mdn import gumbel_pick

_BINNINGS = ("uniform", "gaussian", "quantile")
_WITHIN_BIN = ("uniform", "triangular", "gaussian")


def inverse_freq_weights(targets: np.ndarray, c: int) -> np.ndarray:
    """Class weights sum/count, scaled to mean 1 (float32)."""
    counts = np.bincount(targets.reshape(-1), minlength=c).astype(np.float64)
    w = counts.sum() / np.maximum(counts, 1.0)
    return (w / max(w.mean(), 1e-12)).astype(np.float32)


@register_cpd("softmax_nn")
class SoftmaxNNCPD(BaseCPD):
    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        *,
        seed: Optional[int] = None,
        n_classes: int = 8,
        hidden_dims: Sequence[int] = (32, 32),
        activation: str = "relu",
        label_smoothing: float = 0.0,
        min_bin_width: float = 1e-12,
        binning: str = "uniform",
        within_bin: str = "uniform",
        within_bin_scale: float = 0.25,
        within_bin_clip: bool = False,
        mode_when_not_discrete: str = "binned",
        class_weighting: str = "none",
        debug: bool = False,
        debug_every: int = 0,
        compute_dtype: str = "float32",
        **_ignored,
    ) -> None:
        super().__init__(input_dim, output_dim, seed=seed)
        self.n_classes = int(n_classes)
        self.hidden_dims = tuple(int(h) for h in hidden_dims)
        self.activation = check_activation(str(activation))
        self.label_smoothing = float(label_smoothing)
        self.min_bin_width = float(min_bin_width)
        self.binning = str(binning).lower().strip()
        self.within_bin = str(within_bin).lower().strip()
        self.within_bin_scale = float(within_bin_scale)
        self.within_bin_clip = bool(within_bin_clip)
        self.mode_when_not_discrete = str(mode_when_not_discrete).lower().strip()
        self.class_weighting = str(class_weighting).lower().strip()
        self.debug = bool(debug)
        self.debug_every = int(debug_every)
        resolve_compute_dtype(compute_dtype)
        self.compute_dtype = str(compute_dtype)
        if self.n_classes <= 0:
            raise ValueError("n_classes must be >= 1")
        if self.binning not in _BINNINGS:
            raise ValueError(f"Unknown binning {binning!r}")
        if self.within_bin not in _WITHIN_BIN:
            raise ValueError(f"Unknown within_bin {within_bin!r}")
        if self.mode_when_not_discrete != "binned":
            raise ValueError(
                f"Unknown mode_when_not_discrete {mode_when_not_discrete!r}"
            )
        if self.class_weighting not in {"none", "inverse_freq"}:
            raise ValueError(f"Unknown class_weighting {class_weighting!r}")
        if self.debug_every < 0:
            raise ValueError("debug_every must be >= 0")
        self.bins_ready = False
        self.root_ready = False

    def get_init_kwargs(self):
        return {
            "n_classes": self.n_classes,
            "hidden_dims": list(self.hidden_dims),
            "activation": self.activation,
            "label_smoothing": self.label_smoothing,
            "min_bin_width": self.min_bin_width,
            "binning": self.binning,
            "within_bin": self.within_bin,
            "within_bin_scale": self.within_bin_scale,
            "within_bin_clip": self.within_bin_clip,
            "mode_when_not_discrete": self.mode_when_not_discrete,
            "class_weighting": self.class_weighting,
            "debug": self.debug,
            "debug_every": self.debug_every,
            "compute_dtype": self.compute_dtype,
        }

    def get_extra_state(self):
        return {"bins_ready": self.bins_ready, "root_ready": self.root_ready}

    def set_extra_state(self, state) -> None:
        if state:
            self.bins_ready = bool(state.get("bins_ready", False))
            self.root_ready = bool(state.get("root_ready", False))

    def _static_fields(self) -> tuple:
        return (
            self.n_classes, self.hidden_dims, self.activation,
            self.label_smoothing, self.min_bin_width, self.binning,
            self.within_bin, self.within_bin_scale, self.within_bin_clip,
            self.class_weighting, self.bins_ready, self.root_ready,
            self.compute_dtype,
        )

    # -- lifecycle ----------------------------------------------------------
    def init(self, device, gen: Optional[torch.Generator] = None) -> Params:
        c, d = self.n_classes, self.output_dim
        f32 = dict(dtype=torch.float32, device=device)
        if self.input_dim == 0:
            net = {"logits": torch.zeros((d, c), **f32)}
        else:
            net = mlp_init(gen, self.input_dim, self.hidden_dims, d * c,
                           device)
        zeros = lambda *shape: torch.zeros(shape, **f32)  # noqa: E731
        return {
            "net": net,
            "bins": {
                "vmin": zeros(d), "vmax": zeros(d), "edges": zeros(d, c + 1),
                "centers": zeros(d, c), "class_values": zeros(d, c),
                "sample_values": zeros(d, c), "is_discrete": zeros(d),
            },
            "root_log_probs": zeros(d, c),
            "opt": None,
        }

    # -- host-side bin construction ------------------------------------------
    def _compute_bins_host(self, x_flat: np.ndarray):
        """(vmin, vmax, edges, centers, class_values, is_discrete)."""
        d, c = self.output_dim, self.n_classes
        vmin = x_flat.min(axis=0)
        vmax = x_flat.max(axis=0)
        min_range = self.min_bin_width * c
        if min_range > 0:
            span = vmax - vmin
            vmax = np.where(span < min_range, vmin + min_range, vmax)
        q = np.linspace(0.0, 1.0, c + 1)
        if self.binning == "uniform":
            width = np.maximum((vmax - vmin) / c, self.min_bin_width)
            edges = vmin[:, None] + width[:, None] * q[None, :]
        elif self.binning == "gaussian":
            mean = x_flat.mean(axis=0)
            std = np.maximum(x_flat.std(axis=0), self.min_bin_width)
            qs = np.clip(q, 1e-6, 1.0 - 1e-6)
            z = np.sqrt(2.0) * _erfinv(2.0 * qs - 1.0)
            edges = mean[:, None] + std[:, None] * z[None, :]
            edges[:, 0] = vmin
            edges[:, -1] = vmax
        else:  # quantile
            edges = np.quantile(x_flat, q, axis=0).T
            edges[:, 0] = vmin
            edges[:, -1] = vmax
        if self.min_bin_width > 0:
            for i in range(1, edges.shape[1]):
                edges[:, i] = np.maximum(
                    edges[:, i], edges[:, i - 1] + self.min_bin_width
                )
        centers = 0.5 * (edges[:, :-1] + edges[:, 1:])
        is_discrete = np.zeros((d,), bool)
        class_values = np.zeros((d, c), np.float32)
        for dim in range(d):
            uniq = np.unique(x_flat[:, dim])
            if uniq.size == c:
                is_discrete[dim] = True
                class_values[dim] = uniq
        return (vmin.astype(np.float32), vmax.astype(np.float32),
                edges.astype(np.float32), centers.astype(np.float32),
                class_values, is_discrete)

    def _bins(self, x_flat: np.ndarray, device):
        vmin, vmax, edges, centers, class_values, is_discrete = (
            self._compute_bins_host(x_flat))
        sample_values = np.where(is_discrete[:, None], class_values, centers)
        self.bins_ready = True
        arrays = {
            "vmin": vmin, "vmax": vmax, "edges": edges, "centers": centers,
            "class_values": class_values,
            "sample_values": sample_values.astype(np.float32),
            "is_discrete": is_discrete.astype(np.float32),
        }
        return {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}

    def _refresh_bins(self, params, x_flat: np.ndarray, device, *,
                      allow_expand: bool, force: bool):
        """The fit's bins (``force``, or none yet), else the stored ones:
        discrete dimensions checked against their classes and, with
        ``allow_expand``, the edges rebuilt over a range the rows widen
        (the JAX package's ``_refresh_bins``)."""
        if force or not self.bins_ready:
            return self._bins(x_flat, device)
        bins = params["bins"]
        is_discrete = bins["is_discrete"].cpu().numpy() > 0.5
        cv = bins["class_values"].cpu().numpy()
        for dim in np.where(is_discrete)[0]:
            if not np.isin(x_flat[:, dim], cv[dim]).all():
                raise ValueError(
                    "Found values outside discrete class set during update.")
        if not allow_expand:
            return bins
        vmin_old = bins["vmin"].cpu().numpy()
        vmax_old = bins["vmax"].cpu().numpy()
        new_vmin = np.minimum(vmin_old, x_flat.min(axis=0))
        new_vmax = np.maximum(vmax_old, x_flat.max(axis=0))
        if not ((new_vmin < vmin_old).any() or (new_vmax > vmax_old).any()):
            return bins
        _, _, edges, _, _, _ = self._compute_bins_host(x_flat)
        min_range = self.min_bin_width * self.n_classes
        span = new_vmax - new_vmin
        new_vmax = np.where(span < min_range, new_vmin + min_range, new_vmax)
        if self.binning == "uniform":
            width = np.maximum((new_vmax - new_vmin) / self.n_classes,
                               self.min_bin_width)
            q = np.arange(self.n_classes + 1, dtype=np.float64)
            edges = new_vmin[:, None] + width[:, None] * q[None, :]
        else:
            edges[:, 0] = new_vmin
            edges[:, -1] = new_vmax
        if self.min_bin_width > 0:
            for i in range(1, edges.shape[1]):
                edges[:, i] = np.maximum(edges[:, i],
                                         edges[:, i - 1] + self.min_bin_width)
        centers = 0.5 * (edges[:, :-1] + edges[:, 1:])
        sample_values = np.where(is_discrete[:, None], cv, centers)
        arrays = {
            "vmin": new_vmin, "vmax": new_vmax, "edges": edges,
            "centers": centers, "sample_values": sample_values,
        }
        return {**bins, **{k: torch.as_tensor(v.astype(np.float32),
                                              device=device)
                           for k, v in arrays.items()}}

    # -- bin mapping (device) -------------------------------------------------
    def _x_to_bin(self, bins, x: torch.Tensor) -> torch.Tensor:
        """x [M, Dout] -> int64 bin/class indices [M, Dout]."""
        cont = (x[:, :, None] >= bins["edges"][None]).sum(dim=-1) - 1
        cont = torch.clamp(cont, 0, self.n_classes - 1)
        match = x[:, :, None] == bins["class_values"][None]
        disc = torch.argmax(match.to(torch.int8), dim=-1)
        return torch.where(bins["is_discrete"][None, :] > 0.5, disc, cont)

    def _gather_edges(self, bins, idx: torch.Tensor):
        """idx [M, Dout] -> (left, right, width, center), each [M, Dout]."""
        edges = bins["edges"]  # [D, C+1]
        idx = torch.clamp(idx, 0, self.n_classes - 1)
        m = idx.shape[0]
        left = edges[:, :-1][None].expand(m, -1, -1).gather(
            2, idx[..., None])[..., 0]
        right = edges[:, 1:][None].expand(m, -1, -1).gather(
            2, idx[..., None])[..., 0]
        width = torch.clamp(right - left, min=self.min_bin_width)
        return left, right, width, 0.5 * (left + right)

    # -- logits ----------------------------------------------------------------
    def _logits_flat(self, params, parents, m: int):
        """[M, Dout, C] logits (log-softmax not yet applied)."""
        c, d = self.n_classes, self.output_dim
        if self.input_dim == 0:
            if self.root_ready:
                lp = torch.log_softmax(params["root_log_probs"], dim=-1)
                return lp[None].expand(m, d, c)
            return params["net"]["logits"][None].expand(m, d, c)
        out = mlp_apply(params["net"], parents, self.activation,
                        resolve_compute_dtype(self.compute_dtype))
        return out.reshape(m, d, c)

    # -- training ---------------------------------------------------------------
    def _nll(self, net, parents, targets, aux):
        """Weighted CE with label smoothing; targets are float bin indices."""
        m = targets.shape[0]
        c, d = self.n_classes, self.output_dim
        logits = mlp_apply(net, parents, self.activation).reshape(m, d, c)
        log_probs = torch.log_softmax(logits, dim=-1)
        one_hot = torch.nn.functional.one_hot(targets.long(), c).float()
        eps = self.label_smoothing
        if eps > 0:
            one_hot = (1.0 - eps) * one_hot + eps / c
        if self.class_weighting == "inverse_freq":
            log_probs = log_probs * aux["class_weights"][None, None, :]
        return -torch.mean(torch.sum(one_hot * log_probs, dim=-1))

    def _train(self, params, parents, x, *, device, gen, steps, batch_size,
               lr, weight_decay, max_grad_norm, allow_expand, force_bins,
               ema_alpha=None):
        x_np = np.asarray(x, np.float32).reshape(-1, self.output_dim)
        bins = self._refresh_bins(params, x_np, device,
                                  allow_expand=allow_expand, force=force_bins)
        params = {**params, "bins": bins}
        x_t = torch.as_tensor(x_np, device=device)
        targets = self._x_to_bin(bins, x_t)
        if self.input_dim == 0:
            # root fast path: the empirical histogram
            t = targets.cpu().numpy()
            counts = np.stack([np.bincount(t[:, dim], minlength=self.n_classes)
                               for dim in range(self.output_dim)]
                              ).astype(np.float64)
            probs = counts / np.maximum(counts.sum(axis=1, keepdims=True), 1.0)
            eps = self.label_smoothing
            if eps > 0:
                probs = (1.0 - eps) * probs + eps / self.n_classes
            self.root_ready = True
            return {**params, "root_log_probs": torch.as_tensor(
                np.log(np.maximum(probs, 1e-12)).astype(np.float32),
                device=device)}
        w = (inverse_freq_weights(targets.cpu().numpy(), self.n_classes)
             if self.class_weighting == "inverse_freq"
             else np.ones((self.n_classes,), np.float32))
        aux = {"class_weights": torch.as_tensor(w, device=device)}
        net, opt = fit_minibatch_nll(
            self._nll, params["net"], params.get("opt"), gen,
            as_rows(parents, self.input_dim, device), targets.float(),
            epochs=steps, batch_size=batch_size, lr=lr,
            weight_decay=weight_decay, max_grad_norm=max_grad_norm, aux=aux,
            ema_alpha=ema_alpha,
        )
        return {**params, "net": net, "opt": opt}

    def fit(self, params, parents, x, *, device, gen=None, epochs: int = 1,
            lr: float = 1e-3, batch_size: int = 128,
            weight_decay: float = 0.0, max_grad_norm=None, **_kwargs):
        return self._train(params, parents, x, device=device, gen=gen,
                           steps=epochs, batch_size=batch_size, lr=lr,
                           weight_decay=weight_decay,
                           max_grad_norm=max_grad_norm, allow_expand=False,
                           force_bins=True)

    def update(self, params, parents, x, *, device, gen=None, lr=1e-3,
               n_steps: int = 1, batch_size: int = 128,
               weight_decay: float = 0.0, max_grad_norm=None,
               ema_alpha=None, **_kwargs):
        return self._train(params, parents, x, device=device, gen=gen,
                           steps=n_steps, batch_size=batch_size, lr=lr,
                           weight_decay=weight_decay,
                           max_grad_norm=max_grad_norm, allow_expand=True,
                           force_bins=False, ema_alpha=ema_alpha)

    # -- protocol and flat primitives -------------------------------------------
    def support_values(self, params: Params) -> torch.Tensor:
        """[Dout, C] sample values (bin centers / discrete classes)."""
        return params["bins"]["sample_values"]

    def categorical_probs(self, params: Params, parents):
        m = 1 if parents is None else parents.shape[0]
        probs = torch.softmax(self._logits_flat(params, parents, m), dim=-1)
        return probs[:, 0, :] if self.output_dim == 1 else probs

    def _require_bins(self) -> None:
        if not self.bins_ready:
            raise RuntimeError("Bins not initialized. Call fit(...) first.")

    def _sample_flat(self, params, gen, parents, m):
        self._require_bins()
        bins = params["bins"]
        idx = gumbel_pick(torch.log_softmax(
            self._logits_flat(params, parents, m), dim=-1), gen)  # [M, D]
        disc_values = bins["sample_values"][None].expand(m, -1, -1).gather(
            2, idx[..., None])[..., 0]
        left, right, width, center = self._gather_edges(bins, idx)
        # the within-bin draw takes the slots after the Gumbel noise's
        at = next_slot(idx[0].numel() * self.n_classes)
        if self.within_bin == "gaussian":
            sigma = torch.clamp(self.within_bin_scale * width,
                                min=self.min_bin_width)
            cont_values = center + normals(
                gen, m, center.shape[1], center.device, at=at) * sigma
        else:
            u = uniforms(gen, m, center.shape[1], center.device, at=at)
            if self.within_bin == "uniform":
                cont_values = left + u * width
            else:  # triangular
                cont_values = torch.where(
                    u < 0.5,
                    left + width * torch.sqrt(torch.clamp(u * 0.5, min=0.0)),
                    right - width * torch.sqrt(
                        torch.clamp((1.0 - u) * 0.5, min=0.0)),
                )
        if self.within_bin_clip:
            cont_values = torch.clamp(cont_values, left, right)
        return torch.where(bins["is_discrete"][None, :] > 0.5, disc_values,
                           cont_values)

    def _draws(self):
        k = self.output_dim * self.n_classes  # the Gumbel noise's slots
        return ((k, 0, False),
                (self.output_dim, next_slot(k), self.within_bin == "gaussian"))

    def _vmappable(self) -> bool:
        return resolve_compute_dtype(self.compute_dtype) is None

    def _log_prob_flat(self, params, x, parents):
        self._require_bins()
        bins = params["bins"]
        m = x.shape[0]
        log_probs = torch.log_softmax(self._logits_flat(params, parents, m),
                                      dim=-1)
        idx = self._x_to_bin(bins, x)
        log_bin = log_probs.gather(2, idx[..., None])[..., 0]
        left, right, width, center = self._gather_edges(bins, idx)
        x_use = torch.clamp(x, left, right) if self.within_bin_clip else x
        if self.within_bin == "uniform":
            log_within = -torch.log(width)
        elif self.within_bin == "triangular":
            floor = self.min_bin_width**2
            pdf = torch.where(
                x_use <= center,
                2.0 * (x_use - left) / torch.clamp(width * (center - left),
                                                   min=floor),
                2.0 * (right - x_use) / torch.clamp(width * (right - center),
                                                    min=floor),
            )
            log_within = torch.log(torch.clamp(pdf, min=0.0).clamp(min=1e-12))
        else:  # gaussian
            sigma = torch.clamp(self.within_bin_scale * width,
                                min=self.min_bin_width)
            z = (x_use - center) / sigma
            log_within = -0.5 * (z * z + LOG_2PI) - torch.log(sigma)
        if self.within_bin in ("uniform", "triangular") and \
                not self.within_bin_clip:
            inside = (x >= left) & (x <= right)
            log_within = torch.where(inside, log_within, -torch.inf)
        log_within = torch.where(bins["is_discrete"][None, :] <= 0.5,
                                 log_within, 0.0)
        return torch.sum(log_bin + log_within, dim=-1)


def _erfinv(y: np.ndarray) -> np.ndarray:
    """Inverse error function (Winitzki approximation + two Newton steps),
    for the 'gaussian' binning's normal quantiles on the host."""
    y = np.clip(np.asarray(y, np.float64), -1 + 1e-12, 1 - 1e-12)
    a = 0.147
    ln = np.log(1.0 - y * y)
    t1 = 2.0 / (np.pi * a) + ln / 2.0
    x = np.sign(y) * np.sqrt(np.sqrt(t1 * t1 - ln / a) - t1)
    sqrt_pi = np.sqrt(np.pi)
    for _ in range(2):
        x = x - (_erf_np(x) - y) * sqrt_pi / 2.0 * np.exp(x * x)
    return x


def _erf_np(x: np.ndarray) -> np.ndarray:
    return np.vectorize(erf)(x)
