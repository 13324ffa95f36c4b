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

Every draw is keyed by (key, chain, row, step, purpose)
(``sampling/chains.py``): a transition's momentum and accept uniform come
from counter (chain, row, ``2 step + purpose``) of the call's chain
stream, the step-size search's momentum from a stream of its own. So row 0
of a batch draws what a batch of one draws, and at a fixed step size its
samples are those of a batch of one. Under a mesh (rows over 'data',
chains over 'particle') each rank runs its block of chains; the mean
accept statistic of the adaptation and of ``find_reasonable_eps`` is taken
over the gathered [B * C] statistics, in the unmeshed order, so a meshed
call returns the unmeshed samples bit for bit.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from ..core.base import Query
from ..core.registry import register_sampling
from ..core.rng import RowStream, chain_word, fold
from ..inference._base import Method
from ..inference._sweep import node_values, sweep_trace
from .ancestral import AncestralSampler, fixed_rows
from .chains import ChainBlock

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
    def _make_transition(self, value_and_grad: Callable, chains: ChainBlock,
                         kwargs, stream: RowStream) -> Callable:
        """``(z, eps, step) -> (z', accept statistics [M], their counts [M]
        or None)``; ``value_and_grad(z) -> (log p [M], d log p / dz [M,
        L])``; the step's draws are ``stream``'s at its words."""
        n_leapfrog = max(1, int(kwargs.get("n_leapfrog", 8)))

        def hmc_step(z, eps, step):
            logp0, grad = value_and_grad(z)
            momentum = stream.normal(chain_word(step, 2, 0), z.shape[1])
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
            u = stream.uniform(chain_word(step, 2, 1))[:, 0]
            accept = u < accept_prob
            return torch.where(accept[:, None], q, z), accept_prob, None

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
        draws = -(-s // c)
        total_steps = burn_in + draws
        self._check_words(total_steps, kwargs)
        dev = vbn.device
        draw = vbn.next_key()

        chains = ChainBlock(vbn._mesh, bb, c)
        fixed = fixed_rows(vbn, query, plan, bb)
        fixed_rep = chains.rows(fixed).repeat_interleave(chains.c, dim=0)
        with torch.no_grad():
            packed, _ = sweep_trace(plan, cpds, params, fold(draw, 0),
                                    fixed, c, mesh=vbn._mesh, gather=False)
        z = torch.cat([node_values(plan, packed, i) for i in latent],
                      dim=-1).reshape(chains.m, -1)
        value_and_grad, offs = self._joint(plan, cpds, params, fixed_rep,
                                           latent)
        self._leapfrogs = 0  # leapfrog steps of this call's transitions
        transition = self._make_transition(value_and_grad, chains, kwargs,
                                           chains.stream(fold(draw, 1)))

        eps = torch.tensor(step_size, dtype=torch.float32, device=dev)
        if adapt:
            eps = self._find_reasonable_eps(
                value_and_grad, z, eps, chains.stream(fold(draw, 2)), chains)
        mu = torch.log(10.0 * eps)
        h_bar = torch.zeros((), dtype=torch.float32, device=dev)
        log_eps_bar = torch.log(eps)
        t = plan.target_idx
        kept = []
        for step in range(total_steps):
            z, stat, count = transition(z, eps, step)
            if adapt:
                acc = _mean_accept(chains, stat, count)
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
        out = torch.stack(kept, dim=1)  # [b*c, draws, Dt]
        out = chains.gather(out.reshape(chains.b, chains.c, draws, -1))
        return out.reshape(bb, c * draws, plan.node_dims[t])[:, :s]

    def _check_words(self, total_steps: int, kwargs) -> None:
        """Raise now if the last step's words would pass 2^32."""
        chain_word(total_steps - 1, 2, 1)

    @staticmethod
    def _find_reasonable_eps(value_and_grad, z, eps, stream: RowStream,
                             chains: ChainBlock) -> torch.Tensor:
        """Double (or halve) the step while one leapfrog's mean accept
        probability stays above (below) 0.5, at most 24 times; the same
        momentum for every trial (word 0 of ``stream``). One device read a
        trial."""
        momentum = stream.normal(0, z.shape[1])
        logp0, g0 = value_and_grad(z)
        h0 = -logp0 + _kinetic(momentum)

        def accept_at(e):
            p = momentum + 0.5 * e * g0
            q = z + e * p
            logp1, g1 = value_and_grad(q)
            p = p + 0.5 * e * g1
            h1 = -logp1 + _kinetic(p)
            return float(_mean_accept(
                chains, torch.clamp(torch.exp(h0 - h1), max=1.0), None))

        acc = accept_at(eps)
        up = acc > 0.5
        for _ in range(_MAX_EPS_SEARCH):
            if not (acc > 0.5 if up else acc < 0.5):
                break
            eps = eps * (2.0 if up else 0.5)
            acc = accept_at(eps)
        return eps


def _mean_accept(chains: ChainBlock, stat: torch.Tensor,
                 count: Optional[torch.Tensor]) -> torch.Tensor:
    """The batch's mean accept statistic: ``stat`` [M] averaged over the
    chains, or summed over ``count`` [M] (NUTS: a sum over the leaves a
    chain visited, and their number); the per-chain vectors gathered over
    the mesh first, so the reduction runs on the unmeshed vector."""
    stat = chains.whole(stat)
    if count is None:
        return stat.mean()
    return stat.sum() / torch.clamp(chains.whole(count).sum(), min=1.0)
