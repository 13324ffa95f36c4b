"""KDE pairwise-kernel evaluation: the dispatch of the log-density to the
kernels of ``ops/kde_fused.py``, and the chunked torch forms.

Port of ``vectorizedbayesiannetwork_tpu/ops/kde_kernel.py``.
``kde_log_prob`` dispatches as ``kde_kernel.py:77-117`` does, the
tensor's device choosing where ``pallas_available()`` did: ``kde_root``
for a root with Dx <= 32, ``kde_cond`` for max(Dx, Dp) <= 32 and
``kde_cond_wide`` beyond. Each wrapper launches its CUDA kernel on a CUDA
tensor and runs its plain version on a CPU tensor.

The chunked forms serve what the JAX package sends to XLA on every
backend: a root's log-density with Dx > 32, and the picks of nodes with
more than 32 parent features (``models/kde.py``). The squared distance is
expanded to ``|x|^2 - 2 x.t + |t|^2`` so the cross term is one matrix
product (float32 on the card: PyTorch's default leaves TF32 off for matrix
products), and the query rows are streamed in ``_CHUNK``-row tiles, so no
[M, N] tensor is ever whole. ``kde_sample_indices`` also serves every pick
on the CPU, as a Gumbel-argmax whose noise comes from ``torch.rand``: the
plain pick rebuilds the kernel's Philox uniforms in int64 torch ops and
is held against the kernel on the card.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .kde_fused import (
    _CHUNK,
    _DIRECT_D,
    _chunked,
    kde_cond,
    kde_cond_wide,
    kde_root,
)


def _pairwise_kernel_logits(q: torch.Tensor, data: torch.Tensor,
                            scale: float) -> torch.Tensor:
    """sum_d log N(q_md - t_nd; 0, scale) -> [M, N] via one matrix product."""
    d = q.shape[-1]
    inv2s2 = 1.0 / (2.0 * scale * scale)
    cross = q @ data.T
    q2 = (q * q).sum(dim=-1, keepdim=True)
    t2 = (data * data).sum(dim=-1)[None, :]
    sq = q2 - 2.0 * cross + t2
    const = -d * (0.5 * math.log(2.0 * math.pi) + math.log(scale))
    return -sq * inv2s2 + const


def kde_log_prob(
    x: torch.Tensor,  # [M, Dx]
    parents: Optional[torch.Tensor],  # [M, Dp] or None (root)
    data_x: torch.Tensor,  # [N, Dx]
    data_p: torch.Tensor,  # [N, Dp]
    log_mask: torch.Tensor,  # [N] (0 valid, very negative invalid)
    y_scale: float,
    p_scale: float,
) -> torch.Tensor:
    """Conditional KDE log density -> [M]."""
    if parents is None or data_p.shape[-1] == 0:
        log_n_eff = torch.log(torch.clamp(torch.exp(log_mask).sum(), min=1.0))
        if x.shape[-1] <= _DIRECT_D:
            return kde_root(x.contiguous(), data_x, log_mask, y_scale) - log_n_eff

        def tile_root(xt):
            log_ky = _pairwise_kernel_logits(xt, data_x, y_scale)
            return torch.logsumexp(log_ky + log_mask[None, :], dim=1)

        return _chunked(tile_root, x.shape[0], x) - log_n_eff

    wide = max(x.shape[-1], parents.shape[-1]) > _DIRECT_D
    fn = kde_cond_wide if wide else kde_cond
    return fn(x.contiguous(), parents.contiguous(), data_x, data_p, log_mask,
              y_scale, p_scale)


def kde_sample_indices(
    gen: torch.Generator,
    parents: Optional[torch.Tensor],  # [M, Dp] or None
    data_p: torch.Tensor,  # [N, Dp]
    log_mask: torch.Tensor,  # [N]
    p_scale: float,
    m: int,
) -> torch.Tensor:
    """Parent-softmax-weighted support pick by Gumbel-argmax -> [M] int64.

    The Gumbel noise is drawn per tile from ``gen``, never as a whole
    [M, N] field.
    """
    n = data_p.shape[0]

    def gumbel(rows):
        u = torch.rand((rows, n), generator=gen, device=log_mask.device)
        return -torch.log(-torch.log(u))

    if parents is None or data_p.shape[-1] == 0:
        return torch.cat([
            torch.argmax(log_mask[None, :] + gumbel(min(_CHUNK, m - i)), dim=1)
            for i in range(0, m, _CHUNK)])

    def tile(pt):
        scores = _pairwise_kernel_logits(pt, data_p, p_scale) + log_mask[None, :]
        return torch.argmax(scores + gumbel(pt.shape[0]), dim=1)

    return _chunked(tile, m, parents)
