"""Packaged defaults as Python dicts.

The JAX package reads one YAML file per component
(``vectorizedbayesiannetwork_tpu/configs/``); the machine that runs the
port has no YAML reader, so the resolved defaults of the components this
port provides are held here, with numbers already typed (PyYAML reads
``1e-3`` as a string, which is why ``config_cast.coerce_numbers`` exists;
it still serves strings that users pass). The validation rules match the
JAX package: CPD defaults carry explicit ``fit``/``update`` dicts and no
training keys at top level.
"""

from __future__ import annotations

import copy
from typing import Dict

TRAINING_KEYS = frozenset(
    {"epochs", "lr", "batch_size", "weight_decay", "n_steps", "max_grad_norm"}
)

_CATALOG: Dict[str, Dict[str, Dict]] = {
    "cpds": {
        "categorical_table": {
            "n_classes": 0,
            "alpha": 1.0,
            "alpha_mode": "total_mass",
            "prior": "global",
            "fit": {"epochs": 1, "batch_size": 4096, "lr": 1e-3,
                    "weight_decay": 0.0},
            "update": {"n_steps": 1, "batch_size": 128, "lr": 1e-3,
                       "weight_decay": 0.0},
        },
        "linear_gaussian": {
            "ridge": 1e-6,
            "min_scale": 1e-4,
            "fit": {"epochs": 5, "batch_size": 4096, "lr": 1e-3,
                    "weight_decay": 0.0},
            "update": {"n_steps": 1, "batch_size": 4096, "lr": 1e-3,
                       "weight_decay": 0.0},
        },
    },
    "learning": {"node_wise": {"default_cpd": "gaussian_nn"}},
    "inference": {
        "likelihood_weighting": {
            "n_samples": 1024, "eps": 1e-12, "normalize": True,
        },
        "monte_carlo_marginalization": {"n_samples": 1024},
    },
}


def _lookup(category: str, ref) -> Dict:
    wanted = ref if isinstance(ref, str) else getattr(ref, "name", None)
    if not isinstance(wanted, str):
        raise TypeError("Expected a string name or an object with .name")
    level = _CATALOG[category]
    if wanted not in level:
        raise ValueError(
            f"Unknown {category} config {wanted!r}. Available: {sorted(level)}"
        )
    return copy.deepcopy(level[wanted])


def _forbid_training_keys(params: Dict, what: str) -> None:
    leaked = sorted(TRAINING_KEYS.intersection(params))
    if leaked:
        raise ValueError(
            f"{what} must not include training keys at top level ({leaked}). "
            "Move them under per-CPD 'fit'/'update' dicts."
        )


class Defaults:
    """Read-only facade over the packaged catalog; returns fresh dicts."""

    @staticmethod
    def cpd(ref) -> Dict:
        params = _lookup("cpds", ref)
        _forbid_training_keys(params, "CPD defaults")
        fit, update = params.pop("fit"), params.pop("update")
        return {"cpd": ref if isinstance(ref, str) else ref.name,
                **params, "fit": fit, "update": update}

    @staticmethod
    def learning(ref) -> Dict:
        params = _lookup("learning", ref)
        _forbid_training_keys(params, "node_wise learning defaults")
        return {"name": ref, **params}

    @staticmethod
    def inference(ref) -> Dict:
        return {"name": ref, **_lookup("inference", ref)}


defaults = Defaults()

__all__ = ["Defaults", "defaults", "TRAINING_KEYS"]
