"""Learning methods (registered on import)."""

from .node_wise import NodeWiseLearner

__all__ = ["NodeWiseLearner"]
