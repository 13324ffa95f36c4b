"""vectorizedbayesiannetwork_torch: vectorized Bayesian networks on PyTorch.

The PyTorch/CUDA port of ``vectorizedbayesiannetwork_tpu``, one slice at a
time. Ported so far: node-wise fitting of ``categorical_table`` and
``linear_gaussian`` CPDs, and likelihood weighting / Monte-Carlo
marginalization served as posterior pmf or (mean, std) rows through
hand-written CUDA sweep kernels: the unrolled ones (``ops/sweep.py``,
``csrc/sweep.cu``) and the mask-dynamic scan ones for networks of up to
1500 nodes (``ops/sweep_scan.py``, ``csrc/sweep_scan.cu``, served with
``dynamic_masks=True``). It runs on a CUDA device unless the caller passes
``device="cpu"``. Importing the package populates the registries; it never
imports JAX or the JAX package.
"""

from .core.base import BaseCPD, Query
from .core.dag import StaticDAG
from .core.registry import (
    CPD_REGISTRY,
    INFERENCE_REGISTRY,
    LEARNING_REGISTRY,
    register_cpd,
    register_inference,
    register_learning,
)
from .defaults import defaults

from . import models  # noqa: F401  (CPD families)
from . import learning  # noqa: F401
from . import inference  # noqa: F401

from .vbn import VBN, __version__, params_from_numpy

__all__ = [
    "VBN",
    "Query",
    "BaseCPD",
    "StaticDAG",
    "defaults",
    "params_from_numpy",
    "CPD_REGISTRY",
    "LEARNING_REGISTRY",
    "INFERENCE_REGISTRY",
    "register_cpd",
    "register_learning",
    "register_inference",
    "__version__",
]
