"""The MLP shared by the neural CPD families.

Port of ``vectorizedbayesiannetwork_tpu/models/_mlp.py``: an explicit
parameter tree ``{"layers": [{"w": [in, out], "b": [out]}, ...]}`` (the
JAX layout, so checkpoints load unchanged) and a function that applies it.
Initialization is torch's Linear default, Kaiming-uniform with fan-in
bounds, drawn from the caller's ``torch.Generator``.

``gelu`` is the tanh approximation, as ``jax.nn.gelu`` defaults to.
``compute_dtype="bfloat16"`` feeds each product bf16 inputs and takes a
float32 output, as JAX's ``preferred_element_type=float32``: on the card
``torch.mm(..., out_dtype=torch.float32)``; on the CPU, which has no such
product, the inputs rounded to bf16 and multiplied in float32. Float32
products run at full precision: the port never turns TF32 on. The bf16
product is a ``torch.autograd.Function`` (``BF16Product``) with a float32
backward on the bf16-rounded operands, so HMC and NUTS can differentiate a
bf16 network's log-density on either device (the card's
``torch.mm(..., out_dtype=)`` is not relied on for a backward).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

_ACTIVATIONS = {
    "relu": F.relu,
    "tanh": torch.tanh,
    "gelu": lambda h: F.gelu(h, approximate="tanh"),
    "elu": F.elu,
}


def check_activation(name: str) -> str:
    if name not in _ACTIVATIONS:
        raise ValueError(
            f"Unknown activation {name!r}; expected one of {sorted(_ACTIVATIONS)}"
        )
    return name


def mlp_init(
    gen: torch.Generator,
    input_dim: int,
    hidden_dims: Sequence[int],
    output_dim: int,
    device,
) -> Dict:
    """{'layers': [{'w': [in, out], 'b': [out]}, ...]} on ``device``."""
    dims = [int(input_dim)] + [int(h) for h in hidden_dims] + [int(output_dim)]
    layers = []
    for fan_in, fan_out in zip(dims[:-1], dims[1:]):
        bound = 1.0 / math.sqrt(max(1, fan_in))
        f32 = dict(dtype=torch.float32, device=device)
        layers.append({
            "w": torch.empty((fan_in, fan_out), **f32).uniform_(
                -bound, bound, generator=gen),
            "b": torch.empty((fan_out,), **f32).uniform_(
                -bound, bound, generator=gen),
        })
    return {"layers": layers}


class BF16Product(torch.autograd.Function):
    """``a @ b`` of bf16 operands with a float32 output; the backward
    multiplies the float32 cotangent by the other operand in float32
    (autograd rounds each gradient to its bf16 operand's dtype, as JAX's
    autodiff of ``preferred_element_type=float32`` does)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.is_cuda:
            return torch.mm(a, b, out_dtype=torch.float32)
        return a.float() @ b.float()

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = g @ b.float().T if ctx.needs_input_grad[0] else None
        gb = a.float().T @ g if ctx.needs_input_grad[1] else None
        return ga, gb


def _bf16_product(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 inputs, float32 output (no rounding of the output to bf16)."""
    return BF16Product.apply(h.to(torch.bfloat16), w.to(torch.bfloat16))


def mlp_apply(
    params: Dict,
    x: torch.Tensor,
    activation: str,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """MLP forward on x [..., in] -> [..., out], float32 out.

    ``compute_dtype=torch.bfloat16`` makes each product take bf16 inputs
    (the params stay float32) and give a float32 output.
    """
    act = _ACTIVATIONS[activation]
    layers = params["layers"]
    lead = x.shape[:-1]
    h = x.reshape(-1, x.shape[-1])
    for i, layer in enumerate(layers):
        if compute_dtype is None:
            h = torch.addmm(layer["b"], h, layer["w"])  # bias in the GEMM
        else:
            h = _bf16_product(h, layer["w"]) + layer["b"]
        if i < len(layers) - 1:
            h = act(h)
    return h.reshape(*lead, h.shape[-1])


def resolve_compute_dtype(name: str) -> Optional[torch.dtype]:
    """'float32' -> None (full precision), 'bfloat16' -> torch.bfloat16."""
    name = str(name).lower()
    if name in ("float32", "fp32", "f32"):
        return None
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    raise ValueError(
        f"Unknown compute_dtype {name!r}; expected 'float32' or 'bfloat16'"
    )
