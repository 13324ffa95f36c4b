"""Gaussian numeric helpers shared by the CPDs.

Port of the part of ``vectorizedbayesiannetwork_tpu/ops/gauss.py`` that the
ported CPDs use: ``LOG_2PI``, the diagonal Gaussian log-density that
``linear_gaussian``, ``gaussian_nn`` and ``rff_gaussian`` evaluate for
likelihood weights (the per-node evidence weights of importance sampling
and RIS), ``safe_softplus`` (the scale heads of ``gaussian_nn`` and
``mdn``) and ``standardize_stats`` (their input and output
standardization). The JAX file's ``gaussian_log_prob``, ``stable_log`` and
``normalize_probs`` serve no ported CPD.
"""

from __future__ import annotations

import math

import torch

LOG_2PI = math.log(2.0 * math.pi)


def diag_gaussian_log_prob(
    x: torch.Tensor, loc: torch.Tensor, scale: torch.Tensor
) -> torch.Tensor:
    """Sum of independent Normal log-pdfs over the last axis.

    x/loc/scale broadcastable [..., D] -> [...].
    """
    z = (x - loc) / scale
    return -0.5 * torch.sum(z * z + 2.0 * torch.log(scale) + LOG_2PI, dim=-1)


def safe_softplus(x: torch.Tensor, min_value: float = 0.0) -> torch.Tensor:
    """softplus(x) + min_value (``jax.nn.softplus``: log1p(exp(-|x|)) +
    max(x, 0), which ``F.softplus`` computes with its default threshold)."""
    return torch.nn.functional.softplus(x) + min_value


def standardize_stats(x: torch.Tensor, eps: float = 1e-6):
    """Per-feature (mean, std >= eps) over axis 0, population std."""
    mean = x.mean(dim=0)
    std = torch.clamp(x.std(dim=0, unbiased=False), min=eps)
    return mean, std
