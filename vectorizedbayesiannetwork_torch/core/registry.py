"""Component registries, populated by decorators (duplicate keys refused).

Same surface as ``vectorizedbayesiannetwork_tpu/core/registry.py`` for the
components this port has: all eight CPD families (``categorical_table``,
``linear_gaussian``, ``kde``, ``gaussian_nn``, ``mdn``, ``rff_gaussian``,
``softmax_nn``, ``categorical_embedded_softmax``), one learner, six
inference methods, four samplers (``ancestral``, ``gibbs``, ``hmc``,
``nuts``) and four update policies (``streaming_stats``, ``online_sgd``,
``ema``, ``replay_buffer``) are registered.
"""

from __future__ import annotations

from typing import Callable, Dict, Type

CPD_REGISTRY: Dict[str, Type] = {}
LEARNING_REGISTRY: Dict[str, Type] = {}
INFERENCE_REGISTRY: Dict[str, Type] = {}
SAMPLING_REGISTRY: Dict[str, Type] = {}
UPDATE_REGISTRY: Dict[str, Type] = {}


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
register_sampling = _make_register(SAMPLING_REGISTRY, "sampling")
register_update = _make_register(UPDATE_REGISTRY, "update")
