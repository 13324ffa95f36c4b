"""Inference methods (registered on import)."""

from .categorical_exact import CategoricalExact
from .gaussian_exact import GaussianExact
from .importance_sampling import ImportanceSampling
from .likelihood_weighting import LikelihoodWeighting
from .monte_carlo_marginalization import MonteCarloMarginalization
from .resampled_importance_sampling import ResampledImportanceSampling

__all__ = [
    "CategoricalExact",
    "GaussianExact",
    "ImportanceSampling",
    "LikelihoodWeighting",
    "MonteCarloMarginalization",
    "ResampledImportanceSampling",
]
