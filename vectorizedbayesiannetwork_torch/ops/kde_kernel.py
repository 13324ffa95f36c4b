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
[M, N] tensor is ever whole. ``kde_sample_indices`` is that wide pick:
the pick kernel's inverse CDF on one given uniform a row
(``kde_fused.inverse_cdf_pick``), never a [rows, N] Gumbel field. Picks of
up to 32 parent features run ``kde_fused.kde_pick``, whose plain version
serves the CPU on the kernel's own Philox uniforms.

``kde_log_prob`` is differentiable in the queries and the parents (HMC
and NUTS take the gradient of the joint log-density): when autograd wants
either, the dispatch runs inside ``KDELogProb``, a
``torch.autograd.Function`` whose forward is the same dispatch (the kernel
on the card, never the plain version because a gradient is wanted) and
whose backward is the closed form in ``_CHUNK``-row tiles. The JAX
package's Pallas kernels have no backward either; its gradient is XLA's
autodiff of the plain form (``kde_kernel.py:91-117`` there). The support
(``data_x``, ``data_p``, ``log_mask``) takes no gradient: fits never
differentiate it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .kde_fused import (
    _CHUNK,
    _DIRECT_D,
    ReadFlag,
    _chunked,
    kde_cond,
    kde_cond_wide,
    inverse_cdf_pick,
    kde_root,
    kernel_consts,
    sq_dist,
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


def _kde_log_prob(x, parents, data_x, data_p, log_mask, y_scale, p_scale,
                  read=None):
    if parents is None or data_p.shape[-1] == 0:
        log_n_eff = torch.log(torch.clamp(torch.exp(log_mask).sum(), min=1.0))
        if x.shape[-1] <= _DIRECT_D:
            return kde_root(x.contiguous(), data_x, log_mask, y_scale,
                            read) - log_n_eff

        def tile_root(xt):
            log_ky = _pairwise_kernel_logits(xt, data_x, y_scale)
            return torch.logsumexp(log_ky + log_mask[None, :], dim=1)

        return _chunked(tile_root, x.shape[0], x) - log_n_eff

    x, parents = x.contiguous(), parents.contiguous()
    if max(x.shape[-1], parents.shape[-1]) > _DIRECT_D:
        return kde_cond_wide(x, parents, data_x, data_p, log_mask, y_scale,
                             p_scale)
    return kde_cond(x, parents, data_x, data_p, log_mask, y_scale, p_scale,
                    read)


def _pull(w, q, data, two_inv2):
    """``sum_n w_mn (t_nd - q_md) * 2 inv2`` [M, D], feature by feature."""
    return torch.stack(
        [(w * (data[None, :, d] - q[:, d : d + 1])).sum(dim=1)
         for d in range(q.shape[1])], dim=1) * two_inv2


def kde_log_prob_grad(g, x, parents, data_x, data_p, log_mask,
                      y_scale: float, p_scale: float, want_x=True,
                      want_p=True):
    """The closed-form gradient of ``kde_log_prob`` scaled by ``g`` [M]:
    (d/dx [M, Dx] or None, d/dparents [M, Dp] or None). With
    ``w_num = softmax_n(kp + ky)`` and ``w_den = softmax_n(kp)``: d/dx =
    ``sum_n w_num (t_n - x) / h_y^2``, d/dp = ``sum_n (w_num - w_den)
    (t^p_n - p) / h_p^2`` (a root: ``w = softmax_n(ky + log_mask)``)."""
    root = parents is None or data_p.shape[-1] == 0
    inv2y, cy = (float(v) for v in kernel_consts(x.shape[1], y_scale))
    if not root:
        inv2p, cp = (float(v) for v in kernel_consts(parents.shape[1],
                                                       p_scale))
    gx, gp = [], []
    for r0 in range(0, x.shape[0], _CHUNK):
        r1 = min(r0 + _CHUNK, x.shape[0])
        xt, gt = x[r0:r1], g[r0:r1, None]
        ky = -sq_dist(xt, data_x) * inv2y + cy
        if root:
            w_num = torch.softmax(ky + log_mask[None, :], dim=1)
        else:
            pt = parents[r0:r1]
            kp = -sq_dist(pt, data_p) * inv2p + cp + log_mask[None, :]
            w_num = torch.softmax(kp + ky, dim=1)
            if want_p:
                w_den = torch.softmax(kp, dim=1)
                gp.append(gt * _pull(w_num - w_den, pt, data_p, 2.0 * inv2p))
        if want_x:
            gx.append(gt * _pull(w_num, xt, data_x, 2.0 * inv2y))
    return (torch.cat(gx) if want_x else None,
            torch.cat(gp) if gp else None)


class KDELogProb(torch.autograd.Function):
    """``kde_log_prob`` with the closed-form backward of
    ``kde_log_prob_grad``; the forward is the dispatch as it stands."""

    @staticmethod
    def forward(ctx, x, parents, data_x, data_p, log_mask, y_scale, p_scale):
        ctx.save_for_backward(x, parents, data_x, data_p, log_mask)
        ctx.scales = (y_scale, p_scale)
        return _kde_log_prob(x, parents, data_x, data_p, log_mask, y_scale,
                             p_scale)

    @staticmethod
    def backward(ctx, g):
        x, parents, data_x, data_p, log_mask = ctx.saved_tensors
        gx, gp = kde_log_prob_grad(
            g, x, parents, data_x, data_p, log_mask, *ctx.scales,
            want_x=ctx.needs_input_grad[0],
            want_p=ctx.needs_input_grad[1])
        return gx, gp, None, None, None, None, None


def kde_log_prob(
    x: torch.Tensor,  # [M, Dx]
    parents: Optional[torch.Tensor],  # [M, Dp] or None (root)
    data_x: torch.Tensor,  # [N, Dx]
    data_p: torch.Tensor,  # [N, Dp]
    log_mask: torch.Tensor,  # [N] (0 valid, very negative invalid)
    y_scale: float,
    p_scale: float,
    read: Optional[ReadFlag] = None,
) -> torch.Tensor:
    """Conditional KDE log density -> [M]; differentiable in ``x`` and
    ``parents`` through ``KDELogProb``. ``read`` (``kde_fused.ReadFlag``):
    the rows the caller reads; the direct forms (``kde_root``,
    ``kde_cond``) skip the others, whose values then mean nothing; the
    wide and chunked forms and the differentiable path score every row."""
    if torch.is_grad_enabled():
        if any(t.requires_grad for t in (data_x, data_p, log_mask)):
            raise ValueError(
                "kde_log_prob: the support (data_x, data_p, log_mask) takes "
                "no gradient; detach it")
        if x.requires_grad or (parents is not None and parents.requires_grad):
            return KDELogProb.apply(x, parents, data_x, data_p, log_mask,
                                    y_scale, p_scale)
    return _kde_log_prob(x, parents, data_x, data_p, log_mask, y_scale,
                         p_scale, read)


def kde_sample_indices(
    u: torch.Tensor,  # [M] uniforms in (0, 1)
    parents: Optional[torch.Tensor],  # [M, Dp] or None
    data_p: torch.Tensor,  # [N, Dp]
    log_mask: torch.Tensor,  # [N]
    p_scale: float,
    m: int,
) -> torch.Tensor:
    """Parent-softmax-weighted support pick by inverse CDF on one uniform a
    row (the pick kernel's draw) -> [M] int64, the scores a ``_CHUNK``-row
    tile at a time."""
    if parents is None or data_p.shape[-1] == 0:
        return inverse_cdf_pick(log_mask[None, :], u)

    def tile(pt, ut):
        scores = _pairwise_kernel_logits(pt, data_p, p_scale) + log_mask[None, :]
        return inverse_cdf_pick(scores, ut)

    return _chunked(tile, m, parents, u)
