"""No-U-Turn Sampler with dynamic trajectory lengths (multinomial NUTS).

Port of ``vectorizedbayesiannetwork_tpu/sampling/nuts.py``: iterative tree
doubling (Hoffman & Gelman 2014) with progressive multinomial selection
(Betancourt 2017) over B x n_chains chains at once. Each doubling picks a
direction a chain, integrates ``2^depth`` leapfrog steps from that end of
the trajectory, samples the subtree's proposal leaf by leaf, checks the
U-turn across the subtree's ends and across the whole trajectory's, and
stops a chain that turns or diverges (``H - H0 > max_delta_energy``);
finished chains are frozen by masks while the others go on. The JAX
package's ``while_loop`` over depth is a host loop here that reads the
device once a doubling (whether any chain is still going); the leapfrog
steps within a doubling are a loop of torch ops, each one gradient
evaluation (the gradient at the end of one step is the next one's start).
As in the JAX package, the U-turn checks between interior leaves of a
subtree are skipped (subtree-end and trajectory-end checks only).
The chain scaffolding and the step-size adaptation are ``hmc.py``'s.

Every draw is keyed by (key, chain, row, step, purpose)
(``sampling/chains.py``): a transition's momentum from counter (chain,
row, ``step * (max_depth + 1)``), doubling d's direction, merge uniform
and 2^d leaf uniforms from slots 0, 1 and 2.. of counter (chain, row,
``step * (max_depth + 1) + 1 + d``), one draw a doubling. Under a mesh
each rank runs its block of chains; "any chain still going" is a MAX over
the mesh, so every rank takes the same doublings, and the accept
statistic is summed a chain and reduced over the gathered batch.
"""

from __future__ import annotations

import torch

from ..core.registry import register_sampling
from ..core.rng import RowStream, chain_word
from .chains import ChainBlock
from .hmc import HMCSampler, _kinetic


@register_sampling("nuts")
class NUTSSampler(HMCSampler):
    def _make_transition(self, value_and_grad, chains: ChainBlock, kwargs,
                         stream: RowStream):
        max_depth = max(0, int(kwargs.get("max_tree_depth", 8)))
        max_delta = float(kwargs.get("max_delta_energy", 1000.0))
        width = max_depth + 1  # words a step: the momentum, then a doubling each
        m = chains.m

        def nuts_step(z0, eps, step):
            """One NUTS transition for the block's chains: (z', accept
            statistics summed a chain [m], the leaves they sum [m])."""
            dev = z0.device
            p0 = stream.normal(chain_word(step, width, 0), z0.shape[1])
            lp0, g0 = value_and_grad(z0)
            h0 = -lp0 + _kinetic(p0)
            zm, pm, gm = z0, p0, g0  # the trajectory's backward end
            zp, pp, gp = z0, p0, g0  # and its forward end
            zprop = z0
            log_w = torch.zeros((m,), device=dev)  # the root leaf's weight
            done = torch.zeros((m,), dtype=torch.bool, device=dev)
            acc_sum = torch.zeros((m,), device=dev)
            acc_cnt = torch.zeros((m,), device=dev)
            depth = 0
            while depth < max_depth and chains.any(~done):
                # direction, merge uniform, then the subtree's leaves
                u = stream.uniform(chain_word(step, width, 1 + depth),
                                   2 + 2 ** depth)
                direction = torch.where(u[:, 0] < 0.5, 1.0, -1.0)
                fwd = (direction > 0)[:, None]
                eps_s = eps * direction[:, None]
                z = torch.where(fwd, zp, zm)
                p = torch.where(fwd, pp, pm)
                g = torch.where(fwd, gp, gm)
                active = ~done
                z_sub = z
                log_sub_w = torch.full((m,), -float("inf"), device=dev)
                diverged = torch.zeros((m,), dtype=torch.bool, device=dev)
                for i in range(2 ** depth):
                    p = p + 0.5 * eps_s * g
                    z = z + eps_s * p
                    lp, g = value_and_grad(z)
                    p = p + 0.5 * eps_s * g
                    lw = h0 - (-lp + _kinetic(p))
                    lw = torch.where(torch.isfinite(lw), lw, -float("inf"))
                    diverged = diverged | (lw < -max_delta)
                    # progressive multinomial sampling within the subtree
                    take = u[:, 2 + i] < torch.exp(
                        lw - torch.logaddexp(log_sub_w, lw))
                    z_sub = torch.where(take[:, None], z, z_sub)
                    log_sub_w = torch.logaddexp(log_sub_w, lw)
                    if i == 0:
                        z_start, p_start = z, p
                    acc_sum = acc_sum + torch.where(
                        active, torch.clamp(torch.exp(lw), max=1.0), 0.0)
                    acc_cnt = acc_cnt + active.float()
                self._leapfrogs += 2 ** depth

                # the subtree's U-turn across its own ends, in trajectory time
                dzs = (z - z_start) * direction[:, None]
                sub_turn = ((dzs * p_start).sum(dim=1) < 0) | (
                    (dzs * p).sum(dim=1) < 0)
                sub_ok = active & ~diverged & ~sub_turn
                # biased progressive merge: take the subtree's proposal
                # with probability min(1, W_sub / W_tree)
                take = sub_ok & (u[:, 1] < torch.exp(
                    torch.clamp(log_sub_w - log_w, max=0.0)))
                zprop = torch.where(take[:, None], z_sub, zprop)
                log_w = torch.where(sub_ok, torch.logaddexp(log_w, log_sub_w),
                                    log_w)
                upd_p = sub_ok[:, None] & fwd
                upd_m = sub_ok[:, None] & ~fwd
                zp, pp, gp = (torch.where(upd_p, z, zp),
                              torch.where(upd_p, p, pp),
                              torch.where(upd_p, g, gp))
                zm, pm, gm = (torch.where(upd_m, z, zm),
                              torch.where(upd_m, p, pm),
                              torch.where(upd_m, g, gm))
                # the whole trajectory's U-turn across its outermost ends
                dzt = zp - zm
                turn = ((dzt * pm).sum(dim=1) < 0) | ((dzt * pp).sum(dim=1) < 0)
                done = done | ~sub_ok | turn
                depth += 1
            return zprop, acc_sum, acc_cnt

        return nuts_step

    def _check_words(self, total_steps: int, kwargs) -> None:
        width = max(0, int(kwargs.get("max_tree_depth", 8))) + 1
        chain_word(total_steps - 1, width, width - 1)
