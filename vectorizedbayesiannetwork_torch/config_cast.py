"""Typed coercion of config hyperparameters against declarative kind specs.

Copy of ``vectorizedbayesiannetwork_tpu/config_cast.py``, with the schemas
of all eight CPD families. Users may pass numbers as strings ("1e-3"),
numpy scalars or 0-d arrays; schema-covered keys are cast to Python
ints/floats/bools/lists, unknown keys pass through, and a value that cannot
be interpreted raises ``ValueError``.
"""

from __future__ import annotations

import ast
from typing import Any, Dict

import numpy as np

_TRUTHY = frozenset({"true", "1", "yes"})
_FALSY = frozenset({"false", "0", "no"})


def coerce_scalar(value: Any) -> Any:
    """Unwrap numpy generics and 0-d arrays (numpy or torch) to scalars."""
    if isinstance(value, np.generic):
        return value.item()
    if getattr(value, "ndim", None) == 0 and hasattr(value, "item"):
        return value.item()
    return value


def _bad(key: str, value: Any, kind: str) -> ValueError:
    return ValueError(
        f"Invalid hyperparameter {key}={value!r} (expected {kind})."
    )


def _parse_listish(raw: str) -> Any:
    """A string list literal, or comma-separated fallback ('8,16' -> [8,16])."""
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return [piece.strip() for piece in raw.split(",") if piece.strip()]


def cast_value(value: Any, kind: str, key: str = "?") -> Any:
    """Interpret ``value`` as ``int``/``float``/``bool``/``str``/``list[k]``
    or ``float_or_str``."""
    value = coerce_scalar(value)
    if kind == "str":
        return str(value)
    if kind == "bool":
        if isinstance(value, bool):
            return value
        if isinstance(value, str):
            word = value.strip().lower()
            if word in _TRUTHY:
                return True
            if word in _FALSY:
                return False
        raise _bad(key, value, "bool")
    if kind.startswith("list[") and kind.endswith("]"):
        inner = kind[5:-1]
        if isinstance(value, str):
            value = _parse_listish(value.strip())
        if not isinstance(value, (list, tuple)):
            raise _bad(key, value, "list")
        return [cast_value(item, inner, key) for item in value]
    if kind == "float_or_str":
        # numeric -> float; a non-numeric string names a selection rule
        # (kde bandwidth "scott"); None defers to the constructor.
        if value is None:
            return None
        if isinstance(value, str):
            try:
                return float(value.strip())
            except ValueError:
                return value.strip()
        try:
            return float(value)
        except (TypeError, ValueError) as exc:
            raise _bad(key, value, kind) from exc
    if kind in ("int", "float"):
        if isinstance(value, str):
            try:
                value = float(value.strip())
            except ValueError:
                raise _bad(key, value, kind) from None
        try:
            return int(value) if kind == "int" else float(value)
        except (TypeError, ValueError) as exc:
            raise _bad(key, value, kind) from exc
    raise ValueError(f"Unknown kind spec {kind!r} for hyperparameter {key!r}.")


def coerce_numbers(
    values: Dict[str, Any], schema: Dict[str, str]
) -> Dict[str, Any]:
    """Copy of ``values`` with schema-covered keys cast to type."""
    return {
        key: cast_value(val, schema[key], key) if key in schema else val
        for key, val in values.items()
    }


FIT_SCHEMA: Dict[str, str] = {
    "epochs": "int",
    "batch_size": "int",
    "lr": "float",
    "weight_decay": "float",
    "n_steps": "int",
    "show_progress": "bool",
    "verbosity": "int",
    "max_grad_norm": "float",
}

UPDATE_SCHEMA: Dict[str, str] = {
    "lr": "float",
    "n_steps": "int",
    "batch_size": "int",
    "weight_decay": "float",
    "max_grad_norm": "float",
}

_MLP_KEYS = {"hidden_dims": "list[int]"}
_CATEGORICAL_KEYS = {"n_classes": "int", "parent_n_classes": "list[int]"}

CPD_SCHEMAS: Dict[str, Dict[str, str]] = {
    "gaussian_nn": {**_MLP_KEYS, "min_scale": "float"},
    "softmax_nn": {
        "n_classes": "int",
        **_MLP_KEYS,
        "label_smoothing": "float",
        "min_bin_width": "float",
        "within_bin_scale": "float",
        "within_bin_clip": "bool",
        "debug": "bool",
        "debug_every": "int",
    },
    "mdn": {"n_components": "int", **_MLP_KEYS, "min_scale": "float"},
    "kde": {
        "bandwidth": "float_or_str",
        "parent_bandwidth": "float_or_str",
        "max_points": "int",
        "min_scale": "float",
    },
    "linear_gaussian": {"ridge": "float", "min_scale": "float"},
    "rff_gaussian": {
        "n_features": "int",
        "lengthscale": "float",
        "ridge": "float",
        "min_scale": "float",
        "use_bias": "bool",
    },
    "categorical_table": {
        **_CATEGORICAL_KEYS,
        "alpha": "float",
        "alpha_mode": "str",
        "prior": "str",
    },
    "categorical_embedded_softmax": {
        **_CATEGORICAL_KEYS,
        "embedding_dim": "int",
        **_MLP_KEYS,
        "label_smoothing": "float",
        "max_grad_norm": "float",
    },
}
