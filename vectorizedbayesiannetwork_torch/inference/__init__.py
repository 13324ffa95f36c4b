"""Inference methods (registered on import)."""

from .amortized import AmortizedInference
from .categorical_exact import CategoricalExact
from .gaussian_exact import GaussianExact
from .importance_sampling import ImportanceSampling
from .lbp import LoopyBeliefPropagation
from .likelihood_weighting import LikelihoodWeighting
from .monte_carlo_marginalization import MonteCarloMarginalization
from .rao_blackwellized_marginalization import RaoBlackwellizedMarginalization
from .resampled_importance_sampling import ResampledImportanceSampling

__all__ = [
    "AmortizedInference",
    "CategoricalExact",
    "GaussianExact",
    "ImportanceSampling",
    "LikelihoodWeighting",
    "LoopyBeliefPropagation",
    "MonteCarloMarginalization",
    "RaoBlackwellizedMarginalization",
    "ResampledImportanceSampling",
]
