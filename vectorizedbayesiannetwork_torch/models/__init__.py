"""CPD families (registered on import)."""

from .categorical_table import CategoricalTableCPD
from .kde import KDECPD
from .linear_gaussian import LinearGaussianCPD

__all__ = ["CategoricalTableCPD", "KDECPD", "LinearGaussianCPD"]
