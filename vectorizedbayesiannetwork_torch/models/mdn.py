"""Mixture Density Network CPD (a Gaussian mixture head on an MLP).

Port of ``vectorizedbayesiannetwork_tpu/models/mdn.py``: MLP -> K logits
and K x (loc, softplus scale); the NLL a logsumexp over components with the
mixture weights floored at 1e-5 and renormalized; a root fast path with
learnable (logits, loc, log_scale). A draw picks a component from the
floored weights by Gumbel-argmax, as the JAX package does (from the
caller's generator: the same distribution, not the same draws), then a
Gaussian within it.
``mixture_params`` is the protocol ``core/handle.py`` reads.

``update`` continues Adam from the stored ``opt`` state for ``n_steps``
epochs with the optional ``ema_alpha`` shadow; ``update_program`` is the
same function. ``fit_many`` is the grouped initial fit of same-signature
nodes (``_train.fit_minibatch_nll_many``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core.base import BaseCPD, Params
from ..core.registry import register_cpd
from ..core.rng import next_slot, normals, uniforms
from ..ops.gauss import LOG_2PI, safe_softplus
from ._mlp import check_activation, mlp_apply, mlp_init, resolve_compute_dtype
from ._train import (
    as_rows,
    fit_minibatch_nll,
    fit_minibatch_nll_many,
    stack_trees,
    unstack_fit,
)


def floored_log_weights(logits: torch.Tensor) -> torch.Tensor:
    """log of softmax(logits) floored at 1e-5 and renormalized."""
    pi = torch.clamp(torch.softmax(logits, dim=-1), min=1e-5)
    pi = pi / torch.clamp(pi.sum(dim=-1, keepdim=True), min=1e-12)
    return torch.log(pi)


def gumbel_pick(log_probs: torch.Tensor, gen) -> torch.Tensor:
    """One class a row of log_probs [m, ..., K] (normalized or not), drawn
    as argmax(log_probs + Gumbel noise), as the JAX package draws it;
    [m, ...] int64. The noise takes slots 0 .. numel / m - 1 of a node's
    row stream, or ``torch.rand`` on a generator. (``torch.cumsum`` over a
    short last axis, an inverse-CDF draw, runs ~40 ms on [8M, 2] on the
    card.)"""
    m = log_probs.shape[0]
    u = uniforms(gen, m, log_probs[0].numel(), log_probs.device,
                 dtype=log_probs.dtype).reshape(log_probs.shape)
    return torch.argmax(log_probs - torch.log(-torch.log(u)), dim=-1)


@register_cpd("mdn")
class MDNCPD(BaseCPD):
    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        *,
        seed: Optional[int] = None,
        n_components: int = 5,
        hidden_dims: Sequence[int] = (32, 32),
        activation: str = "relu",
        min_scale: float = 1e-3,
        compute_dtype: str = "float32",
        **_ignored,
    ) -> None:
        super().__init__(input_dim, output_dim, seed=seed)
        self.n_components = int(n_components)
        self.hidden_dims = tuple(int(h) for h in hidden_dims)
        self.activation = check_activation(str(activation))
        self.min_scale = float(min_scale)
        resolve_compute_dtype(compute_dtype)
        self.compute_dtype = str(compute_dtype)

    def get_init_kwargs(self):
        return {
            "n_components": self.n_components,
            "hidden_dims": list(self.hidden_dims),
            "activation": self.activation,
            "min_scale": self.min_scale,
            "compute_dtype": self.compute_dtype,
        }

    def _static_fields(self) -> tuple:
        return (self.n_components, self.hidden_dims, self.activation,
                self.min_scale, self.compute_dtype)

    # -- lifecycle ----------------------------------------------------------
    def init(self, device, gen: Optional[torch.Generator] = None) -> Params:
        k, d = self.n_components, self.output_dim
        f32 = dict(dtype=torch.float32, device=device)
        if self.input_dim == 0:
            # component means spread so the mixture can specialize
            net = {
                "logits": torch.zeros((k,), **f32),
                "loc": 0.1 * torch.randn((k, d), generator=gen, **f32),
                "log_scale": torch.zeros((k, d), **f32),
            }
        else:
            net = mlp_init(gen, self.input_dim, self.hidden_dims,
                           k * (2 * d) + k, device)
        return {"net": net, "opt": None}

    # -- mixture head ---------------------------------------------------------
    def mixture_params(self, params_or_net, parents, dt=None):
        """(logits [M, K], loc [M, K, D], scale [M, K, D]) for flat parents
        [M, Din] (None for a root: M = 1)."""
        net = params_or_net.get("net", params_or_net)
        k, d = self.n_components, self.output_dim
        if self.input_dim == 0:
            m = 1 if parents is None else parents.shape[0]
            return (net["logits"].expand(m, k), net["loc"].expand(m, k, d),
                    safe_softplus(net["log_scale"], self.min_scale).expand(
                        m, k, d))
        out = mlp_apply(net, parents, self.activation, dt)
        rest = out[..., k:].reshape(out.shape[0], k, 2 * d)
        return (out[..., :k], rest[..., :d],
                safe_softplus(rest[..., d:], self.min_scale))

    def _mixture_log_prob(self, logits, loc, scale, x):
        """x [M, D] under the mixtures [M, K, ...] -> [M]."""
        z = (x[:, None, :] - loc) / scale
        log_comp = -0.5 * torch.sum(z * z + 2.0 * torch.log(scale) + LOG_2PI,
                                    dim=-1)  # [M, K]
        return torch.logsumexp(floored_log_weights(logits) + log_comp, dim=-1)

    def _nll(self, net, parents, x):
        logits, loc, scale = self.mixture_params(net, parents)
        return -torch.mean(self._mixture_log_prob(logits, loc, scale, x))

    def _train(self, params, parents, x, *, device, gen, steps, batch_size,
               lr, weight_decay, max_grad_norm, ema_alpha=None):
        x = as_rows(x, self.output_dim, device)
        p = None if parents is None else as_rows(parents, self.input_dim,
                                                 device)
        net, opt = fit_minibatch_nll(
            self._nll, params["net"], params.get("opt"), gen, p, x,
            epochs=steps, batch_size=batch_size, lr=lr,
            weight_decay=weight_decay, max_grad_norm=max_grad_norm,
            ema_alpha=ema_alpha,
        )
        return {"net": net, "opt": opt}

    def fit(self, params, parents, x, *, device, gen=None, epochs: int = 1,
            lr: float = 1e-3, batch_size: int = 128,
            weight_decay: float = 0.0, max_grad_norm=None, **_kwargs):
        return self._train(params, parents, x, device=device, gen=gen,
                           steps=epochs, batch_size=batch_size, lr=lr,
                           weight_decay=weight_decay,
                           max_grad_norm=max_grad_norm)

    def fit_many(self, params_list, parents_list, x_list, *, device, gens,
                 epochs: int = 1, lr: float = 1e-3, batch_size: int = 128,
                 weight_decay: float = 0.0, max_grad_norm=None, **_kwargs):
        """The initial fit of G same-signature nodes as one grouped loop
        (see ``gaussian_nn.fit_many``); None when a node has an optimizer
        state."""
        if any(p.get("opt") is not None for p in params_list):
            return None
        xs = [as_rows(x, self.output_dim, device) for x in x_list]
        pns = [x.new_zeros((x.shape[0], 0))
               if p is None or self.input_dim == 0
               else as_rows(p, self.input_dim, device)
               for p, x in zip(parents_list, xs)]
        nets, opts = fit_minibatch_nll_many(
            self._nll, stack_trees([p["net"] for p in params_list]), gens,
            torch.stack(pns), torch.stack(xs), epochs=epochs,
            batch_size=batch_size, lr=lr, weight_decay=weight_decay,
            max_grad_norm=max_grad_norm,
        )
        out = []
        for i in range(len(params_list)):
            net, opt = unstack_fit(nets, opts, i)
            out.append({"net": net, "opt": opt})
        return out

    def update(self, params, parents, x, *, device, gen=None, lr=1e-3,
               n_steps: int = 1, batch_size: int = 128,
               weight_decay: float = 0.0, max_grad_norm=None,
               ema_alpha=None, **_kwargs):
        return self._train(params, parents, x, device=device, gen=gen,
                           steps=n_steps, batch_size=batch_size, lr=lr,
                           weight_decay=weight_decay,
                           max_grad_norm=max_grad_norm, ema_alpha=ema_alpha)

    def update_program(self, conf):
        """The Adam update is a function of fixed-shape inputs."""
        conf = dict(conf)

        def fn(params, gen, parents, x, *, device):
            return self.update(params, parents, x, device=device, gen=gen,
                               **conf)

        return fn

    # -- flat primitives -----------------------------------------------------
    def _mixtures(self, params, parents, m: int):
        logits, loc, scale = self.mixture_params(
            params, parents, resolve_compute_dtype(self.compute_dtype))
        k, d = self.n_components, self.output_dim
        return (logits.expand(m, k), loc.expand(m, k, d),
                scale.expand(m, k, d))

    def _sample_flat(self, params, gen, parents, m):
        logits, loc, scale = self._mixtures(params, parents, m)
        comp = gumbel_pick(floored_log_weights(logits), gen)
        sel = comp[:, None, None].expand(m, 1, self.output_dim)
        loc_c = loc.gather(1, sel)[:, 0]
        scale_c = scale.gather(1, sel)[:, 0]
        eps = normals(gen, m, self.output_dim, loc.device,
                      at=next_slot(self.n_components), dtype=loc.dtype)
        return loc_c + eps * scale_c

    def _draws(self):
        return ((self.n_components, 0, False),
                (self.output_dim, next_slot(self.n_components), True))

    def _vmappable(self) -> bool:
        return resolve_compute_dtype(self.compute_dtype) is None

    def _log_prob_flat(self, params, x, parents):
        logits, loc, scale = self._mixtures(params, parents, x.shape[0])
        return self._mixture_log_prob(logits, loc, scale, x)
