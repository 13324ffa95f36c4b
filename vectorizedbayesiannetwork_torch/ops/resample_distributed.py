"""Distributed systematic / multinomial resampling over a sharded particle axis.

Port of ``vectorizedbayesiannetwork_tpu/ops/resample_distributed.py``, with
fixed shapes and bounded memory: no global all-gather of the particles.

- The global CDF exists only as each shard's inclusive cumsum
  (``ops/scan.py::cumsum_rows``, ``vbn_cumsum`` on the card) plus an
  exclusive per-shard offset, from one all-gather of the shards' masses
  over 'particle'.
- Each rank owns a contiguous block of output positions. Systematic (and
  sorted-uniform multinomial) positions are monotone, so the ancestors each
  source shard gives are one window: a ring (``parallel.mesh.ring_shift``,
  the JAX ``ppermute`` shifted left) takes every shard's (CDF, values) past
  every rank once. At step r a rank claims the positions whose mass falls
  in the visiting shard's span and picks them with a local sorted gather
  (``ops/resample_merge.py::sorted_gather``, ``vbn_spg``'s merge kernel on
  the card, under the JAX gate; else ``searchsorted`` and ``gather``).
- Peak memory is the resident and the visiting window, and the traffic one
  rotation of the values.

Positions use the raw-mass predicate ``cum >= u * total``, so no global
normalization pass is needed; each visiting window is renormalized
locally. Randomness: ``u0`` (systematic) is drawn a data shard, so every
particle shard of a row agrees; multinomial takes its Exp(1) order
statistics a shard (``fold(row, pi)``) with the tail draw ``fold(row,
n_particle)``. ``u0``, ``e`` and ``e_tail`` may be passed instead.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.rng import Draw, fold
from ..parallel.mesh import (
    PARTICLE_AXIS,
    all_gather,
    mesh_coords,
    mesh_shape,
    ring_shift,
)
from .resample_merge import sorted_gather, srg_supported
from .scan import cumsum_rows

_POS_MAX = 1.0 - 2.0**-24


def _local_cumsum(x: torch.Tensor) -> torch.Tensor:
    return cumsum_rows(x.float().contiguous(), monotone=True)


def _ring_pick(q, cum_l, v_l, sums, mesh):
    """Values [B_l, s_out, D] at the target masses ``q`` [B_l, s_out]
    (monotone a row) from every shard's window, by one ring rotation."""
    n_p = sums.shape[0]
    me = mesh_coords(mesh)[1]
    offs = torch.cumsum(sums, dim=0) - sums  # exclusive [n_p, B_l]
    s_l, d = v_l.shape[1], v_l.shape[2]
    use_kernel = srg_supported(s_l, d) and q.shape[1] % 512 == 0 and \
        q.shape[1] >= 512
    out = torch.zeros(q.shape + (d,), dtype=v_l.dtype, device=v_l.device)
    cw, vw = cum_l, v_l
    for r in range(n_p):
        src = (me + r) % n_p
        lo = offs[src]  # [B_l]
        mass = torch.clamp(sums[src], min=1e-20)
        # side='right' ancestor predicate (first cum > q), as the one-device
        # merge kernel: src owns q in [lo, lo + mass)
        mine = (q >= lo[:, None]) & (q < (lo + mass)[:, None])
        # monotone local positions in [0, 1): clipping keeps them sorted
        pos = torch.clamp((q - lo[:, None]) / mass[:, None], 0.0, _POS_MAX)
        cn = torch.clamp(cw / mass[:, None], max=1.0)
        if use_kernel:
            picked = sorted_gather(cn, pos, vw)
        else:
            rank = torch.searchsorted(cn.contiguous(), pos.contiguous(),
                                      right=True)
            rank = torch.clamp(rank, 0, s_l - 1)
            picked = vw.gather(1, rank[..., None].expand(-1, -1, d))
        out = torch.where(mine[..., None], picked, out)
        if r < n_p - 1:
            cw = ring_shift(cw, mesh, PARTICLE_AXIS)
            vw = ring_shift(vw, mesh, PARTICLE_AXIS)
    return out


def distributed_resample_gather(
    draw: Draw,
    weights_l: torch.Tensor,  # [B_l, s_l] this rank's block
    values_l: torch.Tensor,  # [B_l, s_l, D]
    mesh,
    *,
    method: str = "systematic",
    u0: Optional[torch.Tensor] = None,  # [B_l, 1]
    e: Optional[torch.Tensor] = None,  # [B_l, s_l] Exp(1)
    e_tail: Optional[torch.Tensor] = None,  # [B_l] Exp(1)
) -> torch.Tensor:
    """Resample this rank's block of ``values`` by the global weights, the
    particle axis sharded over the mesh -> [B_l, s_l, D].

    Every rank of the mesh calls it with the same ``draw`` and its own
    block (``distributed_resample_supported`` says whether B and S split).
    """
    n_p = mesh_shape(mesh)[1]
    di, me = mesh_coords(mesh)
    b_l, s_l = weights_l.shape
    s = s_l * n_p
    dev = weights_l.device
    w = torch.clamp(weights_l.float(), min=0.0)
    cum_l = _local_cumsum(w)
    sums = all_gather(cum_l[:, -1].contiguous(), mesh, PARTICLE_AXIS)
    total = sums.sum(dim=0)  # [B_l] raw global mass
    # per global row: every particle shard of a row folds the same data index
    row = fold(draw, di)
    if method == "systematic":
        if u0 is None:
            u0 = torch.rand((b_l, 1), generator=row.generator, device=dev)
        t = (me * s_l + torch.arange(s_l, dtype=torch.float32, device=dev))
        u = (t[None, :] + u0.float()) / s  # my output slots' quantiles
    elif method == "multinomial":  # sorted uniform order statistics
        if e is None:
            e = torch.empty((b_l, s_l), device=dev).exponential_(
                generator=fold(row, me).generator)
        if e_tail is None:
            e_tail = torch.empty((b_l,), device=dev).exponential_(
                generator=fold(row, n_p).generator)
        ec = _local_cumsum(e)
        esums = all_gather(ec[:, -1].contiguous(), mesh, PARTICLE_AXIS)
        e_tot = esums.sum(dim=0) + e_tail.float()  # Z_{S+1}
        e_off = (torch.cumsum(esums, dim=0) - esums)[me]  # [B_l]
        u = (ec + e_off[:, None]) / torch.clamp(e_tot[:, None], min=1e-20)
    else:
        raise ValueError("method must be 'systematic' or 'multinomial'")
    q = torch.clamp(u, max=_POS_MAX) * total[:, None]
    return _ring_pick(q, cum_l, values_l.float(), sums, mesh)


def distributed_resample_supported(mesh, b: int, s: int) -> bool:
    """Whether B rows split over 'data' and S particles over 'particle'."""
    if mesh is None:
        return False
    n_d, n_p = mesh_shape(mesh)
    return b % n_d == 0 and s % n_p == 0
