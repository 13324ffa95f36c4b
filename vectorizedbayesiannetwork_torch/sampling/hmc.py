"""Hamiltonian Monte Carlo over the latent nodes of a continuous network.

Port of ``vectorizedbayesiannetwork_tpu/sampling/hmc.py``: leapfrog steps
with a Metropolis accept over the joint log-density of all nodes, as a
function of the flat latent vector ``z`` [B * n_chains, L]; the chains
start from one ancestral sweep; ``adapt_step_size`` runs
``find_reasonable_eps`` (step doubling or halving, at most 24 times) and
then the dual-averaging adaptation (Hoffman & Gelman 2014: gamma 0.05,
t0 10, kappa 0.75) through burn-in. The gradient is ``torch.autograd.grad``
of the summed joint log-density with respect to ``z`` in place of
``jax.grad``; the JAX package's compiled scan of steps is a Python loop
here, and the step size stays a device scalar, so the loop reads the
device only in ``find_reasonable_eps``. A network with a categorical CPD
(one that has ``categorical_probs``), or a query with no latent node,
falls back to ancestral sampling. On KDE nodes the log-density's forward
launches ``vbn_kde_root`` / ``vbn_kde_cond`` on the card and its backward
is ``ops/kde_kernel.py``'s closed form. NUTS (``nuts.py``) replaces
``_make_transition``.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

from ..core.base import Query
from ..core.registry import register_sampling
from ..core.rng import fold
from ..inference._base import Method
from ..inference._sweep import node_values, sweep_trace
from .ancestral import AncestralSampler, fixed_rows

_GAMMA, _T0, _KAPPA = 0.05, 10.0, 0.75  # dual averaging
_MAX_EPS_SEARCH = 24


def _is_continuous_cpd(cpd) -> bool:
    return not hasattr(cpd, "categorical_probs")


def _kinetic(p: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.sum(p * p, dim=1)


@register_sampling("hmc")
class HMCSampler(Method):
    def __init__(self, n_samples: int = 200, n_chains: int = 1,
                 **_kwargs) -> None:
        self.n_samples = int(n_samples)
        self.n_chains = max(1, int(n_chains))
        self._ancestral = AncestralSampler(n_samples=self.n_samples)

    # -- the transition kernel (NUTSSampler overrides it) --------------------
    def _make_transition(self, value_and_grad: Callable, m: int, kwargs,
                         gen: torch.Generator) -> Callable:
        """``(z, eps) -> (z', mean accept statistic)``; ``value_and_grad(z)
        -> (log p [M], d log p / dz [M, L])``."""
        n_leapfrog = max(1, int(kwargs.get("n_leapfrog", 8)))

        def hmc_step(z, eps):
            logp0, grad = value_and_grad(z)
            momentum = torch.randn(z.shape, generator=gen, device=z.device)
            h0 = -logp0 + _kinetic(momentum)
            p = momentum + 0.5 * eps * grad
            q = z
            for _ in range(n_leapfrog):
                q = q + eps * p
                logp1, g = value_and_grad(q)
                p = p + eps * g
            self._leapfrogs += n_leapfrog
            p = p - 0.5 * eps * g  # the last kick was a full step: take half back
            h1 = -logp1 + _kinetic(p)
            accept_prob = torch.clamp(torch.exp(h0 - h1), max=1.0)
            accept = torch.rand((m,), generator=gen, device=z.device) < accept_prob
            return torch.where(accept[:, None], q, z), accept_prob.mean()

        return hmc_step

    def _joint(self, plan, cpds, params, fixed_rep, latent):
        """``value_and_grad(z)`` of the joint log-density, with evidence
        and do values from ``fixed_rep`` [M, total_dim]."""
        offs, o = {}, 0
        for i in latent:
            offs[i] = (o, o + plan.node_dims[i])
            o += plan.node_dims[i]
        fixed = [node_values(plan, fixed_rep, i) for i in range(plan.n_nodes)]

        def log_prob(z):
            vals = [z[:, offs[i][0]:offs[i][1]] if i in offs else fixed[i]
                    for i in range(plan.n_nodes)]
            total = torch.zeros((z.shape[0],), dtype=torch.float32,
                                device=z.device)
            for i in range(plan.n_nodes):
                pidx = plan.parent_idx[i]
                parents = (torch.cat([vals[p] for p in pidx], dim=-1)
                           if pidx else None)
                total = total + cpds[i]._log_prob_flat(params[i], vals[i],
                                                       parents)
            return total

        def value_and_grad(z) -> Tuple[torch.Tensor, torch.Tensor]:
            with torch.enable_grad():
                zz = z.detach().requires_grad_(True)
                lp = log_prob(zz)
                (g,) = torch.autograd.grad(lp.sum(), zz)
            return lp.detach(), g

        return value_and_grad, offs

    def sample(self, vbn, query: Query, n_samples=None, **kwargs):
        s = int(n_samples or kwargs.get("n_samples", self.n_samples))
        if not all(_is_continuous_cpd(vbn.cpd_spec(n))
                   for n in vbn.dag.nodes()):
            return self._ancestral.sample(vbn, query, n_samples=s)
        step_size = float(kwargs.get("step_size", 0.05))
        burn_in = int(kwargs.get("burn_in", 10))
        adapt = bool(kwargs.get("adapt_step_size", False))
        target_accept = float(kwargs.get("target_accept", 0.8))
        c = max(1, int(kwargs.get("n_chains", self.n_chains)))
        plan, bb = self._plan_and_batch(vbn, query)
        latent = [i for i in range(plan.n_nodes) if not plan.is_fixed(i)]
        if not latent:
            return self._ancestral.sample(vbn, query, n_samples=s)
        cpds = self._cpds(vbn, plan)
        params = self._params_tuple(vbn, plan)
        m = bb * c
        draws = -(-s // c)
        total_steps = burn_in + draws
        dev = vbn.device
        draw = vbn.next_key()

        fixed = fixed_rows(vbn, query, plan, bb)
        fixed_rep = fixed.repeat_interleave(c, dim=0)  # [M, total_dim]
        with torch.no_grad():
            packed, _ = sweep_trace(plan, cpds, params, fold(draw, 0),
                                    fixed, c, mesh=vbn._mesh)
        z = torch.cat([node_values(plan, packed, i) for i in latent],
                      dim=-1).reshape(m, -1)
        value_and_grad, offs = self._joint(plan, cpds, params, fixed_rep,
                                           latent)
        gen = fold(draw, 1).generator
        self._leapfrogs = 0  # leapfrog steps of this call's transitions
        transition = self._make_transition(value_and_grad, m, kwargs, gen)

        eps = torch.tensor(step_size, dtype=torch.float32, device=dev)
        if adapt:
            eps = self._find_reasonable_eps(value_and_grad, z, eps,
                                            fold(draw, 2).generator)
        mu = torch.log(10.0 * eps)
        h_bar = torch.zeros((), dtype=torch.float32, device=dev)
        log_eps_bar = torch.log(eps)
        t = plan.target_idx
        kept = []
        for step in range(total_steps):
            z, acc = transition(z, eps)
            if adapt:
                tt = step + 1.0
                if step < burn_in:
                    h_bar = ((1.0 - 1.0 / (tt + _T0)) * h_bar
                             + (target_accept - acc) / (tt + _T0))
                    log_eps = mu - math.sqrt(tt) / _GAMMA * h_bar
                    eta = tt ** (-_KAPPA)
                    log_eps_bar = eta * log_eps + (1.0 - eta) * log_eps_bar
                    eps = torch.exp(log_eps)
                else:
                    eps = torch.exp(log_eps_bar)
            if step >= burn_in:
                kept.append(z[:, offs[t][0]:offs[t][1]] if t in offs
                            else node_values(plan, fixed_rep, t))
        out = torch.stack(kept).movedim(0, 1)  # [M, draws, Dt]
        return out.reshape(bb, c * draws, plan.node_dims[t])[:, :s]

    @staticmethod
    def _find_reasonable_eps(value_and_grad, z, eps, gen) -> torch.Tensor:
        """Double (or halve) the step while one leapfrog's mean accept
        probability stays above (below) 0.5, at most 24 times; the same
        momentum for every trial. One device read a trial."""
        momentum = torch.randn(z.shape, generator=gen, device=z.device)
        logp0, g0 = value_and_grad(z)
        h0 = -logp0 + _kinetic(momentum)

        def accept_at(e):
            p = momentum + 0.5 * e * g0
            q = z + e * p
            logp1, g1 = value_and_grad(q)
            p = p + 0.5 * e * g1
            h1 = -logp1 + _kinetic(p)
            return float(torch.clamp(torch.exp(h0 - h1), max=1.0).mean())

        acc = accept_at(eps)
        up = acc > 0.5
        for _ in range(_MAX_EPS_SEARCH):
            if not (acc > 0.5 if up else acc < 0.5):
                break
            eps = eps * (2.0 if up else 0.5)
            acc = accept_at(eps)
        return eps
