"""Host-side and tensor utilities for the PyTorch port.

Counterpart of ``vectorizedbayesiannetwork_tpu/core/utils.py``: query values
are coerced on the host with numpy and cross to the device once, when a
program runs. Devices are explicit: every entry point that makes a tensor
takes a ``torch.device``.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch


def resolve_verbosity(verbose: Optional[int] = None) -> int:
    """Resolve verbosity from arg or the VBN_VERBOSITY env var (default 0)."""
    if verbose is not None:
        return int(verbose)
    try:
        return int(os.environ.get("VBN_VERBOSITY", ""))
    except ValueError:
        return 0


def resolve_device(device) -> torch.device:
    """``None`` means the card. The CPU is used only when asked for.

    Raises instead of carrying on quietly on the CPU when no card exists.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "vectorizedbayesiannetwork_torch runs on a CUDA device by "
            "default and none is available; pass device='cpu' to run on "
            "the CPU."
        )
    return dev


def ensure_2d_np(x, dtype=np.float32) -> np.ndarray:
    """Coerce to a numpy [B, D] array: scalars -> [1,1], 1-D -> [B,1]."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    arr = np.asarray(x, dtype=dtype)
    if arr.ndim == 0:
        return arr.reshape(1, 1)
    if arr.ndim == 1:
        return arr.reshape(-1, 1)
    if arr.ndim == 2:
        return arr
    raise ValueError(f"Expected scalar/1D/2D value, got shape {arr.shape}")


def df_to_array_dict(df) -> Dict[str, np.ndarray]:
    """DataFrame-like (``.columns`` + ``df[col].to_numpy()``) -> {col: [N,1]}."""
    return {
        col: np.asarray(df[col].to_numpy(), np.float32).reshape(len(df), 1)
        for col in df.columns
    }


def concat_parents(
    data: Mapping[str, np.ndarray], parents
) -> Optional[np.ndarray]:
    """Concatenate parent columns along the feature axis; None for roots."""
    if not parents:
        return None
    return np.concatenate([np.asarray(data[p]) for p in parents], axis=-1)


def infer_batch_size(*mappings: Mapping[str, object]) -> int:
    """Batch size B shared by all evidence/do entries (validated consistent)."""
    b = None
    for mapping in mappings:
        for name, value in (mapping or {}).items():
            rows = int(ensure_2d_np(value).shape[0])
            if b is None:
                b = rows
            elif rows != b:
                raise ValueError(
                    f"Inconsistent batch sizes in query: {name} has "
                    f"{rows}, expected {b}"
                )
    return 1 if b is None else b


def to_plain_dict(obj):
    """Recursively convert arrays to lists for JSON-serializable configs."""
    if isinstance(obj, Mapping):
        return {k: to_plain_dict(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_plain_dict(v) for v in obj)
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    if isinstance(obj, np.ndarray):
        if obj.size > 64:
            return {"shape": list(obj.shape), "dtype": str(obj.dtype)}
        return obj.tolist()
    return obj
