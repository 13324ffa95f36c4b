"""The one seam through which the port launches its CUDA kernels.

Every kernel wrapper in ``ops/`` checks the tensors it hands a kernel with
``check`` and launches an entry point that ``_build.load`` typed with
``launch``, which appends the current stream, raises on a non-zero CUDA
error code and only then counts the launch in ``LAUNCHES``. A wrapper keeps
its own gates (the shapes and ranges its kernel takes), its buffers and its
argument order; its span (``vbn.kernel.<name>``) stays on the wrapper.
"""

from __future__ import annotations

import torch

from ..utils.profiling import counter
from ._build import load

# Kernel launches by wrapper, every kernel of a served batch under one
# reset: the static sweeps (ops/sweep.py), the scan sweeps
# (ops/sweep_scan.py), the resampling kernels (ops/scan.py,
# ops/resample_merge.py), the KDE kernels (ops/kde_fused.py), the row
# stream's (ops/rng.py) and the neural Gaussian CPD's forward
# (ops/mlp_fused.py); "<key>.flagged" counts the launches of "<key>" that
# carried a read flag (ops/kde_fused.py).
LAUNCHES = counter("LAUNCHES", (
    "categorical", "lg", "categorical_scan", "lg_scan",
    "cumsum", "cum_index", "srg", "spg",
    "kde_root", "kde_cond", "kde_cond_wide", "kde_pick",
    "uniforms", "gauss_mlp",
    "kde_root.flagged", "kde_cond.flagged", "kde_pick.flagged",
))


def check(t: torch.Tensor, name: str, dtype, shape, device,
          strided: bool = False) -> None:
    """Raise ValueError unless ``t`` is a CUDA ``dtype`` tensor of
    ``shape`` on ``device``, contiguous (any strides with ``strided``: the
    kernel takes them)."""
    dense = strided or t.is_contiguous()
    if (not t.is_cuda or t.device != device or t.dtype != dtype
            or tuple(t.shape) != tuple(shape) or not dense):
        raise ValueError(
            f"{name}: expected a {'' if strided else 'contiguous '}CUDA "
            f"{dtype} tensor of shape {tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
            f"{'' if dense else ' (not contiguous)'}"
        )


def launch(lib: str, entry: str, *args, device, key=None,
           flagged: bool = False) -> None:
    """Run ``entry`` of ``csrc/<lib>.cu`` on ``args`` and the current
    stream of ``device``; on a zero return code count it in
    ``LAUNCHES[key]`` (and ``key + ".flagged"`` where ``flagged``: it
    carried a read flag), else raise. ``key`` None counts nothing (a test
    hook)."""
    fn = getattr(load(lib), entry)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    if key is not None:
        LAUNCHES[key] += 1
        if flagged:
            LAUNCHES[key + ".flagged"] += 1
