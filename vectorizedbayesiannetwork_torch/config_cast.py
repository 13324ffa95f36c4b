"""Typed coercion of config hyperparameters against declarative kind specs.

Copy of ``vectorizedbayesiannetwork_tpu/config_cast.py`` for the CPD
families this port provides. Users may pass numbers as strings ("1e-3"),
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
    """Interpret ``value`` as ``int``/``float``/``bool``/``str``/``list[k]``."""
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

CPD_SCHEMAS: Dict[str, Dict[str, str]] = {
    "linear_gaussian": {"ridge": "float", "min_scale": "float"},
    "categorical_table": {
        "n_classes": "int",
        "parent_n_classes": "list[int]",
        "alpha": "float",
        "alpha_mode": "str",
        "prior": "str",
    },
}
