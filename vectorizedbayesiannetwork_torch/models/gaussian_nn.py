"""Neural Gaussian CPD: MLP -> (loc, softplus scale), with standardization.

Port of ``vectorizedbayesiannetwork_tpu/models/gaussian_nn.py``: parents
and target standardized once before training (``stats``), Adam NLL
minibatch training (``_train.py``) with the optimizer state kept in the
params as ``opt``, a root fast path with learnable (loc, log_scale), the
``min_scale`` softplus floor, and loc/scale denormalized at evaluation.
``compute_dtype="bfloat16"`` serves through bf16 products with float32
outputs; training stays float32, as in the JAX package.
``conditional_params`` is the protocol ``gaussian_exact``'s grid path and
``core/handle.py`` read. A served draw or log-density of a node with
parents runs its forward inside a ``vbn.mlp.sample`` or
``vbn.mlp.log_prob`` span and counts it in ``utils/profiling.py``'s
``MLP``; on the card, where ``ops/mlp_fused.py::refusal`` lets it, the
forward is one ``vbn_gauss_mlp`` launch (``csrc/mlp.cu``), also counted
in ``MLP["fused"]`` and ``MLP["fused_rows"]``.

``update`` continues Adam from the stored ``opt`` state for ``n_steps``
epochs on the new rows, with the standardization refreshed from them and
the optional ``ema_alpha`` shadow, as the JAX package's ``_train`` does;
``update_program`` is the same function. ``fit_many`` is the grouped
initial fit of same-signature nodes (``_train.fit_minibatch_nll_many``),
each node standardized by its own rows.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core.base import BaseCPD, Params
from ..core.registry import register_cpd
from ..core.rng import normals
from ..ops import mlp_fused
from ..ops.gauss import diag_gaussian_log_prob, safe_softplus, standardize_stats
from ..utils.profiling import MLP, annotate
from ._mlp import check_activation, mlp_apply, mlp_init, resolve_compute_dtype
from ._train import (
    as_rows,
    fit_minibatch_nll,
    fit_minibatch_nll_many,
    stack_trees,
    unstack_fit,
)


@register_cpd("gaussian_nn")
class GaussianNNCPD(BaseCPD):
    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        *,
        seed: Optional[int] = None,
        hidden_dims: Sequence[int] = (32, 32),
        activation: str = "relu",
        min_scale: float = 1e-3,
        compute_dtype: str = "float32",
        **_ignored,
    ) -> None:
        super().__init__(input_dim, output_dim, seed=seed)
        self.hidden_dims = tuple(int(h) for h in hidden_dims)
        self.activation = check_activation(str(activation))
        self.min_scale = float(min_scale)
        resolve_compute_dtype(compute_dtype)
        self.compute_dtype = str(compute_dtype)

    def get_init_kwargs(self):
        return {
            "hidden_dims": list(self.hidden_dims),
            "activation": self.activation,
            "min_scale": self.min_scale,
            "compute_dtype": self.compute_dtype,
        }

    def _static_fields(self) -> tuple:
        return (self.hidden_dims, self.activation, self.min_scale,
                self.compute_dtype)

    # -- lifecycle ----------------------------------------------------------
    def init(self, device, gen: Optional[torch.Generator] = None) -> Params:
        f32 = dict(dtype=torch.float32, device=device)
        if self.input_dim == 0:
            net = {"loc": torch.zeros((self.output_dim,), **f32),
                   "log_scale": torch.zeros((self.output_dim,), **f32)}
        else:
            net = mlp_init(gen, self.input_dim, self.hidden_dims,
                           self.output_dim * 2, device)
        return {
            "net": net,
            "stats": {
                "mean_x": torch.zeros((self.input_dim,), **f32),
                "std_x": torch.ones((self.input_dim,), **f32),
                "mean_y": torch.zeros((self.output_dim,), **f32),
                "std_y": torch.ones((self.output_dim,), **f32),
            },
            "opt": None,
        }

    def _standardization(self, parents: Optional[torch.Tensor], x):
        f32 = dict(dtype=torch.float32, device=x.device)
        if parents is None or parents.numel() == 0:
            mean_x = torch.zeros((self.input_dim,), **f32)
            std_x = torch.ones((self.input_dim,), **f32)
        else:
            mean_x, std_x = standardize_stats(parents)
        mean_y, std_y = standardize_stats(x)
        return {"mean_x": mean_x, "std_x": std_x,
                "mean_y": mean_y, "std_y": std_y}

    def _nll(self, net, parents, x):
        """Mean NLL in normalized units of normalized rows."""
        loc, scale = self._loc_scale_norm(net, parents, x.shape[0])
        return -torch.mean(diag_gaussian_log_prob(x, loc, scale))

    def _loc_scale_norm(self, net, parents, m: int, dt=None):
        """(loc, scale) in normalized target units from normalized parents."""
        if self.input_dim == 0:
            loc = net["loc"].expand(m, self.output_dim)
            scale = safe_softplus(net["log_scale"], self.min_scale).expand(
                m, self.output_dim)
            return loc, scale
        out = mlp_apply(net, parents, self.activation, dt)
        loc = out[..., : self.output_dim]
        scale = safe_softplus(out[..., self.output_dim :], self.min_scale)
        return loc, scale

    def _train(self, params, parents, x, *, device, gen, steps, batch_size,
               lr, weight_decay, max_grad_norm, ema_alpha=None):
        x = as_rows(x, self.output_dim, device)
        p = None if parents is None else as_rows(parents, self.input_dim,
                                                 device)
        stats = self._standardization(p, x)
        xn = (x - stats["mean_y"]) / stats["std_y"]
        pn = None if p is None else (p - stats["mean_x"]) / stats["std_x"]
        net, opt = fit_minibatch_nll(
            self._nll, params["net"], params.get("opt"), gen, pn, xn,
            epochs=steps, batch_size=batch_size, lr=lr,
            weight_decay=weight_decay, max_grad_norm=max_grad_norm,
            ema_alpha=ema_alpha,
        )
        return {"net": net, "stats": stats, "opt": opt}

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
        """The initial fit of G same-signature nodes as one grouped loop; a
        list of params in input order, or None when a node already has an
        optimizer state (an update, which stays sequential)."""
        if any(p.get("opt") is not None for p in params_list):
            return None
        xs, pns, stats_list = [], [], []
        for parents, x in zip(parents_list, x_list):
            x = as_rows(x, self.output_dim, device)
            p = (None if parents is None or self.input_dim == 0
                 else as_rows(parents, self.input_dim, device))
            stats = self._standardization(p, x)
            stats_list.append(stats)
            xs.append((x - stats["mean_y"]) / stats["std_y"])
            pns.append(x.new_zeros((x.shape[0], 0)) if p is None
                       else (p - stats["mean_x"]) / stats["std_x"])
        nets, opts = fit_minibatch_nll_many(
            self._nll, stack_trees([p["net"] for p in params_list]), gens,
            torch.stack(pns), torch.stack(xs), epochs=epochs,
            batch_size=batch_size, lr=lr, weight_decay=weight_decay,
            max_grad_norm=max_grad_norm,
        )
        out = []
        for i, stats in enumerate(stats_list):
            net, opt = unstack_fit(nets, opts, i)
            out.append({"net": net, "stats": stats, "opt": opt})
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
    def _denorm_params(self, params, parents, m: int):
        stats = params["stats"]
        pn = (None if self.input_dim == 0
              else (parents - stats["mean_x"]) / stats["std_x"])
        loc_n, scale_n = self._loc_scale_norm(
            params["net"], pn, m, resolve_compute_dtype(self.compute_dtype))
        return (loc_n * stats["std_y"] + stats["mean_y"],
                scale_n * stats["std_y"])

    def _served_params(self, which: str, params, parents, m: int):
        """``_denorm_params`` of a served draw or log-density: a node with
        parents runs its forward in a ``vbn.mlp.<which>`` span and counts
        it in ``MLP``, on ``vbn_gauss_mlp`` where ``mlp_fused.refusal``
        finds nothing against it; a root's (loc, log_scale) runs none."""
        if self.input_dim == 0:
            return self._denorm_params(params, parents, m)
        MLP["forwards"] += 1
        MLP["rows"] += m
        with annotate(f"vbn.mlp.{which}"):
            net, stats = params["net"], params["stats"]
            if mlp_fused.refusal(parents, net, stats, self.activation,
                                 self.compute_dtype) is None:
                return mlp_fused.gauss_mlp(parents.contiguous(), net, stats,
                                           self.min_scale)
            return self._denorm_params(params, parents, m)

    def _sample_flat(self, params, gen, parents, m):
        loc, scale = self._served_params("sample", params, parents, m)
        eps = normals(gen, m, self.output_dim, loc.device, dtype=loc.dtype)
        return loc + eps * scale

    def _draws(self):
        return ((self.output_dim, 0, True),)

    def _vmappable(self) -> bool:
        return resolve_compute_dtype(self.compute_dtype) is None

    def _log_prob_flat(self, params, x, parents):
        loc, scale = self._served_params("log_prob", params, parents,
                                         x.shape[0])
        return diag_gaussian_log_prob(x, loc, scale)

    def conditional_params(self, params: Params, parents):
        """(loc, scale), each [M, Dout], given flat parents [M, Din] (None
        for a root: M = 1)."""
        m = 1 if parents is None else parents.shape[0]
        return self._denorm_params(params, parents, m)
