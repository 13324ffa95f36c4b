"""Inference methods (registered on import)."""

from .importance_sampling import ImportanceSampling
from .likelihood_weighting import LikelihoodWeighting
from .monte_carlo_marginalization import MonteCarloMarginalization
from .resampled_importance_sampling import ResampledImportanceSampling

__all__ = [
    "ImportanceSampling",
    "LikelihoodWeighting",
    "MonteCarloMarginalization",
    "ResampledImportanceSampling",
]
