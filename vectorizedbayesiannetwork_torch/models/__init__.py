"""CPD families (registered on import)."""

from .categorical_table import CategoricalTableCPD
from .linear_gaussian import LinearGaussianCPD

__all__ = ["CategoricalTableCPD", "LinearGaussianCPD"]
