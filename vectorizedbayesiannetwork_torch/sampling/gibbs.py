"""Multiple-candidate Gibbs sampling over the latent nodes.

Port of ``vectorizedbayesiannetwork_tpu/sampling/gibbs.py``: each step
visits every latent node in topological order, draws ``n_candidates`` (8)
proposals from its CPD given its current parents, scores them through
its children's log-densities (the Markov blanket, through
``plan.children_idx``), and keeps one by Gumbel-argmax over the scores (a
softmax-multinomial pick). ``burn_in`` steps are dropped, then every
``n_steps``-th step's target is kept; ``n_chains`` independent chains run
along the particle axis, started by one ancestral sweep. The JAX package
compiles the steps as one ``lax.scan``; here they are a Python loop of
torch ops.

Two departures from the JAX package make a step leave the node's full
conditional invariant (a conditional importance-resampling step), where
the JAX step does not: candidate 0 is the node's current value (the JAX
step draws all 8 afresh, so it forgets where the chain is), and the score
omits the node's own log-density (the candidates come from it, so it
cancels; the JAX step adds it again and so samples from its square). The
JAX sampler's posterior is pulled toward the prior: on the flagship,
x0 | x2 = 0.5 gives a mean of 0.70 against the exact 0.83, and x2 = -1
-1.23 against -1.65; the port's is exact within Monte-Carlo error.

Two noise routes, as in the JAX package. When every latent CPD splits its
draw into parent-independent noise and a transform (``_noise_spec``,
``_sample_flat_noise``: linear-Gaussian and categorical tables) and all
steps' noise fits in 2^24 floats, it is drawn before the loop in one call
a node, and the selection Gumbels in one more: a step then launches no
random-number kernel. Otherwise (KDE, the neural families) each step draws
its candidates from the CPD's ``_sample_flat`` and its Gumbels in the
loop, from one generator of the call. On KDE nodes a step launches
``vbn_kde_pick`` for the candidates and ``vbn_kde_root`` /
``vbn_kde_cond`` for the scores on the card.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..core.base import Query
from ..core.registry import register_sampling
from ..core.rng import fold
from ..inference._base import Method
from ..inference._sweep import node_values, sweep_trace
from .ancestral import fixed_rows

HOIST_LIMIT = 1 << 24  # floats of noise drawn ahead of the loop, at most


def gumbel(shape, gen: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log u)``, u in (0, 1)."""
    u = torch.rand(shape, generator=gen, device=device)
    u = torch.clamp(u, min=float(np.finfo(np.float32).tiny))
    return -torch.log(-torch.log(u))


_NOISE = {
    "normal": lambda shape, gen, dev: torch.randn(shape, generator=gen,
                                                  device=dev),
    "uniform": lambda shape, gen, dev: torch.rand(shape, generator=gen,
                                                  device=dev),
    "gumbel": gumbel,
}


@register_sampling("gibbs")
class GibbsSampler(Method):
    def __init__(self, n_samples: int = 200, burn_in: int = 10,
                 n_steps: int = 1, n_chains: int = 1, **_kwargs) -> None:
        self.n_samples = int(n_samples)
        self.burn_in = int(burn_in)
        self.n_steps = int(n_steps)
        self.n_chains = max(1, int(n_chains))
        self.n_candidates = 8

    def sample(self, vbn, query: Query, n_samples=None, **kwargs):
        s = int(n_samples or kwargs.get("n_samples", self.n_samples))
        burn_in = int(kwargs.get("burn_in", self.burn_in))
        thin = max(1, int(kwargs.get("n_steps", self.n_steps)))
        c = max(1, int(kwargs.get("n_chains", self.n_chains)))
        plan, bb = self._plan_and_batch(vbn, query)
        cpds = self._cpds(vbn, plan)
        params = self._params_tuple(vbn, plan)
        k = self.n_candidates
        draws = -(-s // c)  # per chain
        total_steps = burn_in + draws * thin
        latent = [i for i in range(plan.n_nodes) if not plan.is_fixed(i)]
        dev = vbn.device
        draw = vbn.next_key()

        packed, _ = sweep_trace(plan, cpds, params, fold(draw, 0),
                                fixed_rows(vbn, query, plan, bb), c,
                                mesh=vbn._mesh)
        vals: List[torch.Tensor] = [node_values(plan, packed, i)
                                    for i in range(plan.n_nodes)]  # [B, C, D]
        m = bb * c * k
        self._last_hoisted = hoist = self._hoistable(cpds, params, latent, m,
                                                     total_steps, bb * c * k)
        if hoist:
            cand_noise = {}
            for idx in latent:
                shape, kind = cpds[idx]._noise_spec(params[idx], m)
                cand_noise[idx] = _NOISE[kind](
                    (total_steps,) + tuple(shape), fold(draw, 2, idx).generator,
                    dev)
            sel_g = gumbel((total_steps, len(latent), bb * c, k),
                           fold(draw, 3).generator, dev)
        else:
            step_gen = fold(draw, 1).generator

        def rep(v):  # each chain's row K times: [B, C, D] -> [B*C*K, D]
            return v.reshape(bb * c, -1).repeat_interleave(k, dim=0)

        kept = []
        for step in range(total_steps):
            for j, idx in enumerate(latent):
                d = plan.node_dims[idx]
                pidx = plan.parent_idx[idx]
                pk = (rep(torch.cat([vals[p] for p in pidx], dim=-1))
                      if pidx else None)
                if hoist:
                    cand = cpds[idx]._sample_flat_noise(
                        params[idx], cand_noise[idx][step], pk, m)
                else:
                    cand = cpds[idx]._sample_flat(params[idx], step_gen, pk, m)
                cand = cand.reshape(bb * c, k, d)
                cand[:, 0] = vals[idx].reshape(bb * c, d)  # the current value
                cand = cand.reshape(m, d)
                score = torch.zeros((m,), dtype=torch.float32, device=dev)
                for ch in plan.children_idx[idx]:
                    parts = [cand if p == idx else rep(vals[p])
                             for p in plan.parent_idx[ch]]
                    score = score + cpds[ch]._log_prob_flat(
                        params[ch], rep(vals[ch]), torch.cat(parts, dim=-1))
                score_k = score.reshape(bb * c, k)
                g = (sel_g[step, j] if hoist
                     else gumbel(score_k.shape, step_gen, dev))
                choice = torch.argmax(score_k + g, dim=-1)  # [B*C]
                chosen = cand.reshape(bb * c, k, d)[
                    torch.arange(bb * c, device=dev), choice]
                vals[idx] = chosen.reshape(bb, c, d)
            if step >= burn_in and (step - burn_in) % thin == 0:
                kept.append(vals[plan.target_idx])
        out = torch.stack(kept).movedim(0, 1)  # [B, draws, C, Dt]
        return out.reshape(bb, draws * c, plan.node_dims[plan.target_idx])[:, :s]

    @staticmethod
    def _hoistable(cpds, params, latent, m, total_steps, gumbels) -> bool:
        """Every latent CPD splits its draw, and all steps' noise and
        selection Gumbels fit in ``HOIST_LIMIT`` floats."""
        elems = total_steps * len(latent) * gumbels
        for idx in latent:
            if not hasattr(cpds[idx], "_noise_spec"):
                return False
            shape, _ = cpds[idx]._noise_spec(params[idx], m)
            elems += total_steps * int(np.prod(shape))
        return elems <= HOIST_LIMIT
