"""Learning methods (registered on import)."""

from .amortized import AmortizedLearner
from .node_wise import NodeWiseLearner

__all__ = ["AmortizedLearner", "NodeWiseLearner"]
