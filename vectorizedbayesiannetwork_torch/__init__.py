"""vectorizedbayesiannetwork_torch: vectorized Bayesian networks on PyTorch.

The PyTorch/CUDA port of ``vectorizedbayesiannetwork_tpu``, one slice at a
time. Ported so far: node-wise fitting of ``categorical_table``,
``linear_gaussian`` and ``kde`` CPDs, and likelihood weighting / Monte-Carlo
marginalization served as posterior pmf or (mean, std) rows through
hand-written CUDA sweep kernels: the unrolled ones (``ops/sweep.py``,
``csrc/sweep.cu``) and the mask-dynamic scan ones for networks of up to
1500 nodes (``ops/sweep_scan.py``, ``csrc/sweep_scan.cu``, served with
``dynamic_masks=True``); importance sampling, and resampled importance
sampling on the CUDA resampling kernels (``ops/scan.py``,
``ops/resample_merge.py``, ``csrc/resample.cu``); KDE log-densities and
draws on the CUDA KDE kernels (``ops/kde_kernel.py``, ``ops/kde_fused.py``,
``csrc/kde.cu``); the exact engines ``categorical_exact`` (enumeration,
junction tree) and ``gaussian_exact`` (closed-form linear-Gaussian
conditioning), and per-node CPD handles (``VBN.cpd``), in plain torch on
the device; sampling (ancestral, Gibbs, HMC, NUTS, ``VBN.sample``),
the online update policies (``VBN.update``), the grouped fit of
same-signature neural nodes (``VBN_FIT_GROUP=always``), and the
``lbp``, ``rao_blackwellized_marginalization`` and ``amortized``
methods (with the ``amortized`` learner); the stacked-table sweeps of
networks of 64 nodes or more that no kernel takes
(``inference/_discrete_sweep.py``, ``_gaussian_sweep.py``,
``VBN_DISCRETE_SCAN``), ``VBN.infer_relative``, ``VBN.to_device``,
``VBN.load(map_location=)``, the config catalog ``VBN.config``
(``ConfigItem``), the kernels' build cache (``core/cache.py``,
``VBN_COMPILATION_CACHE``), ``utils`` and ``display``; and the
('data', 'particle') mesh over ``torch.distributed`` (``parallel``,
``VBN.set_mesh``, ``ops/resample_distributed.py``). It runs on a CUDA
device unless the caller passes ``device="cpu"``. Importing the package
populates the registries; it never imports JAX or the JAX package, and
nothing imports matplotlib until a figure is drawn.
"""

from .core.base import BaseCPD, CPDOutput, Query
from .core.dag import DynamicDAG, StaticDAG, TemporalDAG
from .core.handle import CPDHandle
from .core.registry import (
    CPD_REGISTRY,
    INFERENCE_REGISTRY,
    LEARNING_REGISTRY,
    SAMPLING_REGISTRY,
    UPDATE_REGISTRY,
    register_cpd,
    register_inference,
    register_learning,
    register_sampling,
    register_update,
)
from .defaults import defaults

from . import models  # noqa: F401  (CPD families)
from . import learning  # noqa: F401
from . import inference  # noqa: F401
from . import sampling  # noqa: F401
from . import update  # noqa: F401

from .vbn import (
    VBN,
    ConfigItem,
    ConfigNamespace,
    __version__,
    params_from_numpy,
    params_from_tree,
)

__all__ = [
    "VBN",
    "Query",
    "BaseCPD",
    "CPDOutput",
    "CPDHandle",
    "StaticDAG",
    "TemporalDAG",
    "DynamicDAG",
    "ConfigItem",
    "ConfigNamespace",
    "defaults",
    "params_from_numpy",
    "params_from_tree",
    "CPD_REGISTRY",
    "LEARNING_REGISTRY",
    "INFERENCE_REGISTRY",
    "SAMPLING_REGISTRY",
    "UPDATE_REGISTRY",
    "register_cpd",
    "register_learning",
    "register_inference",
    "register_sampling",
    "register_update",
    "__version__",
]
