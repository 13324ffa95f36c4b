"""The served forward of a neural Gaussian CPD on one hand-written CUDA
kernel.

``vbn_gauss_mlp`` (``csrc/mlp.cu``) takes a ``gaussian_nn`` node's flat
parents [m, dp] and returns its denormalized (loc, scale), each [m, Dout],
in one pass: the standardization, two ReLU layers, the head, the softplus
floor and the denormalization, with the hiddens held in registers. No TPU
kernel stands behind it (the JAX package leaves the MLP to XLA); it takes
the place of ``models/gaussian_nn.py::_denorm_params`` ->
``models/_mlp.py::mlp_apply`` on the served path, whose [m, 32] hiddens
went through device memory between cuBLAS products and elementwise passes.
The kernel covers dp 1-4 parents, hidden widths (32, 32) and one output
column; its products are float32 FFMA (no TF32, no fast-math).

``refusal`` says why the kernel cannot serve a forward, or None where it
can: ``GaussianNNCPD._served_params`` launches it only then, and runs the
plain route otherwise (the CPU, bf16 products, other activations or
widths, a forward that autograd or ``torch.func`` follows). ``gauss_mlp``
launches the kernel for CUDA tensors and raises on what it does not take;
for CPU tensors it runs ``gauss_mlp_plain``, the plain version of the
kernel's arithmetic. Each launch that returns without error counts once
in ``LAUNCHES["gauss_mlp"]`` (``ops/_launch.py``), and its forward and rows
in ``MLP["fused"]`` and ``MLP["fused_rows"]`` (``utils/profiling.py``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models._mlp import resolve_compute_dtype
from ..utils.profiling import MLP
from ._launch import check, launch

DPS = (1, 2, 3, 4)  # parents a template covers
HIDDEN = (32, 32)  # the hidden widths instantiated
DOUT = 1  # output columns instantiated

_wrapped = torch._C._functorch.is_functorch_wrapped_tensor


def _tensors(net: Dict, stats: Dict):
    """The kernel's ten tensors, in the order of ``csrc/mlp.cu``'s ``Net``."""
    (l1, l2, l3) = net["layers"]
    return (stats["mean_x"], stats["std_x"], l1["w"], l1["b"], l2["w"],
            l2["b"], l3["w"], l3["b"], stats["mean_y"], stats["std_y"])


def refusal(parents: torch.Tensor, net: Dict, stats: Dict, activation: str,
            compute_dtype: str) -> Optional[str]:
    """Why ``vbn_gauss_mlp`` cannot serve this forward, or None where it
    can: ``"functorch"`` (an input wrapped by ``torch.func``: a vmapped
    level group or a functional gradient), ``"grad"`` (an input requires
    grad), ``"dtype"`` (bf16 products, or a tensor not float32),
    ``"activation"`` (not relu), ``"shape"`` (parents, widths or outputs
    no template covers, or a weight not contiguous), ``"device"`` (not
    all on one CUDA device)."""
    layers = net.get("layers")
    if not isinstance(layers, (list, tuple)) or len(layers) != 3:
        return "shape"
    ts = (parents,) + _tensors(net, stats)
    if any(_wrapped(t) for t in ts):
        return "functorch"
    if any(t.requires_grad for t in ts):
        return "grad"
    if resolve_compute_dtype(compute_dtype) is not None or any(
            t.dtype != torch.float32 for t in ts):
        return "dtype"
    if activation != "relu":
        return "activation"
    dp = parents.shape[-1] if parents.dim() == 2 else 0
    w1, w2, w3 = (layer["w"] for layer in layers)
    if (dp not in DPS or tuple(w1.shape) != (dp, HIDDEN[0])
            or tuple(w2.shape) != HIDDEN or tuple(w3.shape) != (HIDDEN[1], 2 * DOUT)
            or stats["mean_y"].numel() != DOUT
            or not all(t.is_contiguous() for t in ts[1:])):
        return "shape"
    if parents.device.type != "cuda" or any(t.device != parents.device
                                            for t in ts[1:]):
        return "device"
    return None


def gauss_mlp(parents: torch.Tensor, net: Dict, stats: Dict,
              min_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loc, scale), each [m, Dout] float32, of a ``gaussian_nn`` node with
    MLP ``net`` and ``stats`` at flat parents [m, dp]: ``vbn_gauss_mlp`` for
    CUDA tensors (the shapes ``refusal`` passes), ``gauss_mlp_plain`` for
    CPU tensors."""
    if parents.device.type != "cuda":
        return gauss_mlp_plain(parents, net, stats, min_scale)
    why = refusal(parents, net, stats, "relu", "float32")
    if why is not None:
        raise ValueError(f"vbn_gauss_mlp does not take this forward: {why}")
    m, dp = parents.shape
    dev = parents.device
    check(parents, "vbn_gauss_mlp parents", torch.float32, (m, dp), dev)
    dout = stats["mean_y"].numel()
    loc = torch.empty((m, dout), dtype=torch.float32, device=dev)
    scale = torch.empty_like(loc)
    ptrs = (ctypes.c_void_p * 10)(*(t.data_ptr() for t in _tensors(net, stats)))
    launch("mlp", "vbn_gauss_mlp", parents.data_ptr(), m, dp, HIDDEN[0],
           HIDDEN[1], dout, ptrs, float(min_scale), loc.data_ptr(),
           scale.data_ptr(), device=dev, key="gauss_mlp")
    MLP["fused"] += 1
    MLP["fused_rows"] += m
    return loc, scale


def gauss_mlp_plain(parents: torch.Tensor, net: Dict, stats: Dict,
                    min_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in torch ops, float32: the standardization
    by a true division; each layer's product a sum over ascending k, each
    multiply-add rounded once (taken in float64 and rounded to float32,
    which meets the kernel's FFMA except on a rare double rounding), the
    bias added after it; ReLU between layers; loc and the softplus floor
    denormalized by a multiply, then an add."""
    layers = net["layers"]
    h = (parents - stats["mean_x"]) / stats["std_x"]
    for i, layer in enumerate(layers):
        w = layer["w"].double()
        acc = torch.zeros((h.shape[0], w.shape[1]), dtype=torch.float32,
                          device=h.device)
        for k in range(w.shape[0]):
            acc = (acc.double() + h[:, k : k + 1].double() * w[k]).float()
        h = acc + layer["b"]
        if i < len(layers) - 1:
            h = torch.relu(h)
    d = stats["mean_y"].numel()
    loc = h[:, :d] * stats["std_y"] + stats["mean_y"]
    scale = (F.softplus(h[:, d:]) + min_scale) * stats["std_y"]
    return loc, scale
