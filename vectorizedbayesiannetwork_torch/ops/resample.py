"""Fixed-shape particle resampling in plain torch ops.

Port of ``vectorizedbayesiannetwork_tpu/ops/resample.py``: ancestor
indices for systematic resampling (the search-free ceil/histogram form)
and multinomial resampling (per-draw inverse CDF), and the gather of the
resampled particles. RIS takes these for the shapes that
``resample_merge.srg_supported`` refuses (S below two windows, S not a
multiple of 512, more than 512 live columns), as the JAX package does.

Randomness: the uniforms come from an explicit argument (``u0`` [B, 1],
``u`` [B, S]) or are drawn from ``generator`` on the weights' device.
"""

from __future__ import annotations

from typing import Optional

import torch


def _uniforms(shape, weights, u, generator) -> torch.Tensor:
    if u is not None:
        return u.to(device=weights.device, dtype=torch.float32)
    return torch.rand(shape, generator=generator, device=weights.device,
                      dtype=torch.float32)


def _normalized_cdf(weights: torch.Tensor) -> torch.Tensor:
    cum = torch.cumsum(weights.float(), dim=1)
    return cum / torch.clamp(cum[:, -1:], min=1e-20)


def systematic_resample_indices(
    weights: torch.Tensor,  # [B, S] normalized
    *,
    u0: Optional[torch.Tensor] = None,  # [B, 1]
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """weights [B, S] -> ancestor indices [B, S] (int64).

    With stratified positions p_j = (j + u0)/S the count of positions below
    each CDF step has the closed form ``t_i = ceil(S cum_i - u0)``, and the
    ancestor of position j is ``a_j = #{i : t_i <= j}``: one scatter-add
    histogram of the t_i and a prefix sum.
    """
    b, s = weights.shape
    u0 = _uniforms((b, 1), weights, u0, generator)
    cum = _normalized_cdf(weights)
    t = torch.clamp(torch.ceil(s * cum - u0), 0, s).long()
    hist = torch.zeros((b, s + 1), dtype=torch.int64, device=weights.device)
    hist.scatter_add_(1, t, torch.ones_like(t))
    a = torch.cumsum(hist[:, :s], dim=1)
    return torch.clamp(a, 0, s - 1)


def multinomial_resample_indices(
    weights: torch.Tensor,
    *,
    u: Optional[torch.Tensor] = None,  # [B, S]
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """i.i.d. multinomial ancestors [B, S] via per-draw inverse CDF."""
    b, s = weights.shape
    u = _uniforms((b, s), weights, u, generator)
    cum = _normalized_cdf(weights)
    idx = torch.searchsorted(cum.contiguous(), u.contiguous(), right=False)
    return torch.clamp(idx, 0, s - 1)


def gather_particles(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values [B, S, D], idx [B, S] -> resampled [B, S, D]."""
    return values.gather(1, idx[..., None].expand(-1, -1, values.shape[-1]))
