"""CPD families (registered on import)."""

from .categorical_embedded_softmax import CategoricalEmbeddedSoftmaxCPD
from .categorical_table import CategoricalTableCPD
from .gaussian_nn import GaussianNNCPD
from .kde import KDECPD
from .linear_gaussian import LinearGaussianCPD
from .mdn import MDNCPD
from .rff_gaussian import RFFGaussianCPD
from .softmax_nn import SoftmaxNNCPD

__all__ = [
    "CategoricalEmbeddedSoftmaxCPD",
    "CategoricalTableCPD",
    "GaussianNNCPD",
    "KDECPD",
    "LinearGaussianCPD",
    "MDNCPD",
    "RFFGaussianCPD",
    "SoftmaxNNCPD",
]
