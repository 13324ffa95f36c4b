"""Gaussian numeric helpers shared by the CPDs.

Port of the part of ``vectorizedbayesiannetwork_tpu/ops/gauss.py`` that the
ported CPDs use: ``LOG_2PI`` and the diagonal Gaussian log-density that
``linear_gaussian`` evaluates for likelihood weights (the per-node
evidence weights of importance sampling and RIS). The rest of that file
(``gaussian_log_prob``, ``safe_softplus``, ``stable_log``,
``normalize_probs``, ``standardize_stats``) serves CPD families that are not
ported yet and comes with them.
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
