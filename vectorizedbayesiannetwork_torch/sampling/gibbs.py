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

Every draw of a step is keyed by (key, chain, row, step, node)
(``sampling/chains.py``): a node's K candidates from counter (chain * K +
j, row, ``step * N + node``) of one stream, its selection Gumbels from
counter (chain, row, ``step * N + node``) of another. So row 0 of a batch
draws what a batch of one draws, and under a mesh (rows over 'data',
chains over 'particle') each rank runs its block of chains on their
unmeshed draws and the kept draws are gathered: a meshed call returns the
unmeshed samples bit for bit.

Two noise routes, as in the JAX package. When every latent CPD splits its
draw into parent-independent noise and a transform (``_noise_spec``:
linear-Gaussian and categorical tables) and all steps' noise fits in
2^24 floats, it is drawn before the loop: each node's declared draws
(``_draws``) over its step words by ``RowStream.predraw`` (a
``vbn_uniforms`` launch for each 64 steps on the card), and the
selection Gumbels of every (step, node) likewise. A step then launches
no random-number kernel. Otherwise (KDE, the neural families) each step
draws its candidates on the node's stream and its Gumbels in one launch.
Both routes draw the same counters, so they give the same samples. On KDE nodes a step launches
``vbn_kde_pick`` for the candidates and ``vbn_kde_root`` /
``vbn_kde_cond`` for the scores on the card.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..core.base import Query
from ..core.registry import register_sampling
from ..core.rng import chain_word, fold
from ..inference._base import Method
from ..inference._sweep import node_values, sweep_trace
from .ancestral import fixed_rows
from .chains import ChainBlock

HOIST_LIMIT = 1 << 24  # floats of noise drawn ahead of the loop, at most


def gumbel(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log u)`` of row-stream uniforms, which
    lie in (0, 1)."""
    return -torch.log(-torch.log(u))


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
        n = plan.n_nodes
        chain_word(total_steps - 1, n, n - 1)  # the last word: raise now
        dev = vbn.device
        draw = vbn.next_key()

        chains = ChainBlock(vbn._mesh, bb, c)
        packed, _ = sweep_trace(plan, cpds, params, fold(draw, 0),
                                fixed_rows(vbn, query, plan, bb), c,
                                mesh=vbn._mesh, gather=False)
        vals: List[torch.Tensor] = [node_values(plan, packed, i)
                                    for i in range(plan.n_nodes)]  # [b, c, D]
        b_l, c_l = chains.b, chains.c
        mc = b_l * c_l
        m = mc * k
        cand_stream = chains.stream(fold(draw, 2), per_chain=k)
        sel_stream = chains.stream(fold(draw, 3))
        self._last_hoisted = hoist = self._hoistable(cpds, params, latent, m,
                                                     total_steps, mc * k)
        if hoist:  # each node's draws of every step: {draw_key: [steps, m, k]}
            ahead = {idx: cand_stream.predraw(
                [chain_word(t, n, idx) for t in range(total_steps)],
                cpds[idx]._draws()) for idx in latent}
            sel_g = gumbel(sel_stream.values_many(
                [chain_word(t, n, i) for t in range(total_steps)
                 for i in latent], k)).reshape(total_steps, len(latent), mc, k)

        def rep(v):  # each chain's row K times: [b, c, D] -> [b*c*K, D]
            return v.reshape(mc, -1).repeat_interleave(k, dim=0)

        kept = []
        for step in range(total_steps):
            if not hoist:
                sel = gumbel(sel_stream.values_many(
                    [chain_word(step, n, i) for i in latent], k))
            for j, idx in enumerate(latent):
                d = plan.node_dims[idx]
                pidx = plan.parent_idx[idx]
                pk = (rep(torch.cat([vals[p] for p in pidx], dim=-1))
                      if pidx else None)
                src = ({key: v[step] for key, v in ahead[idx].items()}
                       if hoist else cand_stream.node(chain_word(step, n, idx)))
                cand = cpds[idx]._sample_flat(params[idx], src, pk, m)
                cand = cand.reshape(mc, k, d)
                cand[:, 0] = vals[idx].reshape(mc, d)  # the current value
                cand = cand.reshape(m, d)
                score = torch.zeros((m,), dtype=torch.float32, device=dev)
                for ch in plan.children_idx[idx]:
                    parts = [cand if p == idx else rep(vals[p])
                             for p in plan.parent_idx[ch]]
                    score = score + cpds[ch]._log_prob_flat(
                        params[ch], rep(vals[ch]), torch.cat(parts, dim=-1))
                score_k = score.reshape(mc, k)
                g = sel_g[step, j] if hoist else sel[j]
                choice = torch.argmax(score_k + g, dim=-1)  # [b*c]
                chosen = cand.reshape(mc, k, d)[
                    torch.arange(mc, device=dev), choice]
                vals[idx] = chosen.reshape(b_l, c_l, d)
            if step >= burn_in and (step - burn_in) % thin == 0:
                kept.append(vals[plan.target_idx])
        out = chains.gather(torch.stack(kept, dim=1), dims=(0, 2))
        return out.reshape(bb, draws * c, plan.node_dims[plan.target_idx])[:, :s]

    @staticmethod
    def _hoistable(cpds, params, latent, m, total_steps, gumbels) -> bool:
        """Every latent CPD splits its draw, and all steps' noise and
        selection Gumbels fit in ``HOIST_LIMIT`` floats."""
        elems = total_steps * len(latent) * gumbels
        for idx in latent:
            if not hasattr(cpds[idx], "_noise_spec") or \
                    cpds[idx]._draws() is None:
                return False
            shape, _ = cpds[idx]._noise_spec(params[idx], m)
            elems += total_steps * int(np.prod(shape))
        return elems <= HOIST_LIMIT
