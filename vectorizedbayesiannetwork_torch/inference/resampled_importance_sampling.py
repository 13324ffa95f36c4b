"""Sequential importance resampling (SIR).

Port of
``vectorizedbayesiannetwork_tpu/inference/resampled_importance_sampling.py``:
a per-node prior-proposal sweep in torch ops over the CPDs' flat
primitives; after each evidence node's weight update the ESS is computed
and, on the rows where it fell below the threshold, the particles that are
still read later are resampled and their weights reset. The "resample or
not" decision is a per-row ``where`` select between resampled and original
particles, so nothing waits on the host mid-sweep.

Each resampling event runs the merge path of ``ops/resample_merge.py``
(one ``vbn_cumsum`` and one ``vbn_srg`` launch on the card; multinomial:
two cumsums and ``vbn_spg``) where
``srg_supported`` admits the shape, else the index form of
``ops/resample.py``. Node draws come from the call's row stream
(``core/rng.py::RowStream``: counter (particle, row, node)); each
resampling event keys its draws by its own sub-stream ``fold(draw,
10_000 + node)``: systematic's ``u0`` by row, multinomial's uniforms (the
merge's Exp(1) draws are their ``-log``) by (particle, row). So a row's
answer does not depend on its batch.

Under a mesh (``VBN.set_mesh``), when B splits over 'data' and S over
'particle', each rank runs the loop on its block of rows and particles:
its node draws are its block of the unmeshed row stream (``row0``,
``particle0``), the weights' softmax and ESS take the particle group's max and sums, and each
resampling event is ``ops/resample_distributed.py``'s ring over the live
columns (one ``vbn_cumsum`` and one ``vbn_spg`` a ring step on the card;
multinomial one more cumsum). Every rank returns the whole result.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from ..core.base import Query
from ..core.plan import InferencePlan, pack_fixed_values
from ..core.registry import register_inference
from ..core.rng import RowStream, fold
from ..ops.resample_distributed import (
    distributed_resample_gather,
    distributed_resample_supported,
)
from ..ops.resample import (
    gather_particles,
    multinomial_resample_indices,
    systematic_resample_indices,
)
from ..ops.resample_merge import (
    multinomial_resample_gather,
    srg_supported,
    systematic_resample_gather,
)
from ..parallel.mesh import (
    DATA_AXIS,
    PARTICLE_AXIS,
    all_reduce,
    block,
    gather_blocks,
    mesh_coords,
    mesh_shape,
)
from ._base import Method, Program
from ._sweep import _parents_flat


def _softmax(log_w: torch.Tensor, mesh) -> torch.Tensor:
    """Row softmax over all S particles, the particle axis sharded over
    ``mesh`` when one is given."""
    if mesh is None:
        return torch.softmax(log_w, dim=1)
    m = all_reduce(log_w.max(dim=1).values, mesh, PARTICLE_AXIS,
                   dist.ReduceOp.MAX)
    e = torch.exp(log_w - m[:, None])
    return e / all_reduce(e.sum(dim=1), mesh, PARTICLE_AXIS)[:, None]


def _ess(weights: torch.Tensor, mesh) -> torch.Tensor:
    sq = torch.sum(weights * weights, dim=1)
    if mesh is not None:
        sq = all_reduce(sq, mesh, PARTICLE_AXIS)
    return 1.0 / sq


def live_after(plan: InferencePlan, idx: int) -> List[int]:
    """Nodes whose particle values are still read after node ``idx``'s
    resampling event: the target, and parents of a later node. Fixed nodes
    are broadcast over the particle axis, so resampling leaves them as they
    are; every other node is dead and is not gathered."""
    out = []
    for j in range(idx + 1):
        if plan.is_fixed(j):
            continue
        if j == plan.target_idx or any(
            j in plan.parent_idx[k] for k in range(idx + 1, plan.n_nodes)
        ):
            out.append(j)
    return out


@register_inference("resampled_importance_sampling")
class ResampledImportanceSampling(Method):
    """``resample_method``: 'systematic' (default, the standard SMC choice,
    lower variance) or 'multinomial' (``torch.multinomial`` semantics)."""

    def __init__(
        self,
        n_samples: int = 512,
        ess_threshold: float = 0.5,
        resample: bool = True,
        clamp_obs: bool = True,
        resample_method: str = "systematic",
        **_kwargs,
    ) -> None:
        self.n_samples = int(n_samples)
        self.ess_threshold = float(ess_threshold)
        self.resample = bool(resample)
        self.clamp_obs = bool(clamp_obs)
        if resample_method not in {"systematic", "multinomial"}:
            raise ValueError(
                "resample_method must be 'systematic' or 'multinomial'"
            )
        self.resample_method = resample_method
        self._last_ess: Optional[torch.Tensor] = None
        self._resampled_dev: Optional[torch.Tensor] = None  # from the last call

    @property
    def _last_resampled(self) -> bool:
        """Whether the last call resampled any row (read from the device
        on first use)."""
        if self._resampled_dev is None:
            return False
        return bool(self._resampled_dev)

    def make_program(self, vbn, query: Query, **kwargs):
        s = int(kwargs.get("n_samples", self.n_samples))
        ess_threshold = float(kwargs.get("ess_threshold", self.ess_threshold))
        resample = bool(kwargs.get("resample", self.resample))
        clamp_obs = bool(kwargs.get("clamp_obs", self.clamp_obs))
        method = str(kwargs.get("resample_method", self.resample_method))
        if method == "systematic":
            fused, indices = systematic_resample_gather, systematic_resample_indices
        else:
            fused, indices = multinomial_resample_gather, multinomial_resample_indices
        plan, b = self._plan_and_batch(vbn, query)
        fixed = pack_fixed_values(query, plan, b, clamp_obs=clamp_obs)
        cpds = self._cpds(vbn, plan)
        t = plan.target_idx
        threshold = (
            max(1.0, ess_threshold * float(s))
            if ess_threshold <= 1.0
            else float(ess_threshold)
        )

        def resampled(weights, cat, sub, shard):
            """``cat`` [B, S, D] resampled by ``weights``: over the particle
            shards under a mesh, else the merge kernel where it takes the
            shape, else the index form."""
            if shard is not None:
                return distributed_resample_gather(sub, weights, cat, shard,
                                                   method=method)
            bb = weights.shape[0]
            merge = srg_supported(s, cat.shape[-1])
            if method == "systematic":
                u0 = RowStream(sub, bb, 1).uniform(0)  # [B, 1], by row
                if merge:
                    return fused(weights, cat, u0=u0)
                return gather_particles(cat, indices(weights, u0=u0))
            u = RowStream(sub, bb, s + 1).uniform(0).reshape(bb, s + 1)
            if merge:
                return fused(weights, cat, e=-torch.log(u))
            return gather_particles(cat, indices(weights, u=u[:, :s]))

        mesh = vbn._mesh

        def fn(params_tuple, draw, fixed_vals):
            # this rank's rows and particles under the mesh, else all
            shard = mesh if distributed_resample_supported(
                mesh, fixed_vals.shape[0], s) else None
            (nd, npart), (di, pi) = mesh_shape(shard), mesh_coords(shard)
            fixed_vals = block(fixed_vals, nd, di)
            bb, s_l = fixed_vals.shape[0], s // npart
            stream = RowStream(draw, bb, s_l, row0=di * bb,
                               particle0=pi * s_l, n_particles=s)
            m = bb * s_l
            dev = fixed_vals.device
            vals: List[Optional[torch.Tensor]] = [None] * plan.n_nodes
            log_w = torch.zeros((bb, s_l), dtype=torch.float32, device=dev)
            any_resampled = torch.zeros((), dtype=torch.bool, device=dev)
            last_ess = torch.full((bb,), float(s), device=dev)
            for idx in range(plan.n_nodes):
                d = plan.node_dims[idx]
                off = plan.node_offsets[idx]
                pflat = _parents_flat(plan, vals, idx, m)
                if not plan.is_fixed(idx):
                    v = cpds[idx]._sample_flat(params_tuple[idx],
                                               stream.node(idx), pflat, m)
                    vals[idx] = v.reshape(bb, s_l, d)
                    continue
                vals[idx] = fixed_vals[:, None, off : off + d].expand(bb, s_l, d)
                if not plan.evidence_mask[idx]:
                    continue
                lp = cpds[idx]._log_prob_flat(
                    params_tuple[idx], vals[idx].reshape(m, d), pflat
                )
                log_w = log_w + lp.reshape(bb, s_l)
                if not resample:
                    continue
                weights = _softmax(log_w, shard)
                last_ess = _ess(weights, shard)
                need = last_ess < threshold  # [B]
                live = live_after(plan, idx)
                if live:
                    # one gather over the concatenated live columns; the
                    # rows that do not need it keep their particles
                    cat = torch.cat([vals[j] for j in live], dim=-1)
                    res = resampled(weights, cat, fold(draw, 10_000 + idx),
                                    shard)
                    cat = torch.where(need[:, None, None], res, cat)
                    o = 0
                    for j in live:
                        dj = plan.node_dims[j]
                        vals[j] = cat[..., o : o + dj]
                        o += dj
                log_w = torch.where(need[:, None], 0.0, log_w)
                any_resampled = any_resampled | need.any()
            weights = _softmax(log_w, shard)
            if shard is None:
                return weights, vals[t], last_ess, any_resampled
            any_resampled = all_reduce(any_resampled.to(torch.int32), shard,
                                       DATA_AXIS, dist.ReduceOp.MAX) > 0
            return (gather_blocks(weights, shard),
                    gather_blocks(vals[t], shard),
                    gather_blocks(last_ess, shard, dims=(0,)), any_resampled)

        def post(outs):
            weights, samples, ess, resampled = outs
            self._last_ess = ess
            self._resampled_dev = resampled
            return weights, samples

        return Program(plan, fn, self._params_tuple(vbn, plan), fixed, post)

    def infer_posterior(self, vbn, query: Query, **kwargs):
        return self._run_program(vbn, self.make_program(vbn, query, **kwargs))
