"""Component registries, populated by decorators (duplicate keys refused).

Same surface as ``vectorizedbayesiannetwork_tpu/core/registry.py`` for the
components this port has: two CPD families, one learner and two inference
methods are registered; the sampling and update registries come with their
slices.
"""

from __future__ import annotations

from typing import Callable, Dict, Type

CPD_REGISTRY: Dict[str, Type] = {}
LEARNING_REGISTRY: Dict[str, Type] = {}
INFERENCE_REGISTRY: Dict[str, Type] = {}


def _make_register(registry: Dict[str, Type], kind: str) -> Callable:
    def register(name: str) -> Callable[[Type], Type]:
        def deco(cls: Type) -> Type:
            if name in registry:
                raise KeyError(f"Duplicate {kind} registry key: {name!r}")
            registry[name] = cls
            cls.registry_key = name
            return cls

        return deco

    return register


register_cpd = _make_register(CPD_REGISTRY, "cpd")
register_learning = _make_register(LEARNING_REGISTRY, "learning")
register_inference = _make_register(INFERENCE_REGISTRY, "inference")
