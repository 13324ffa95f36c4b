"""Inference methods (registered on import)."""

from .likelihood_weighting import LikelihoodWeighting
from .monte_carlo_marginalization import MonteCarloMarginalization

__all__ = ["LikelihoodWeighting", "MonteCarloMarginalization"]
