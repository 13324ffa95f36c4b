"""Read-only per-node CPD facade.

Counterpart of ``vectorizedbayesiannetwork_tpu/core/handle.py``: parent
values as a dict (one entry per parent, broadcast over rows) or an array,
sample / log_prob / pdf / forward through the CPD's public API,
``conditional()`` with duck-typed parameter extraction (a CPD may expose
``mixture_params``, ``categorical_probs`` or ``conditional_params`` as
functions of ``(params, flat parents)``; otherwise empirical samples),
``conditional_mean_std``, and summary / export / clone. Tensors live on the
VBN's device; draws come from the VBN's key stream.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional

import torch

from .base import CPDOutput, _as_tensor, _leaves


class CPDHandle:
    def __init__(self, vbn, node: str) -> None:
        if node not in vbn.dag.nodes():
            raise ValueError(f"Unknown node {node!r}")
        self.vbn = vbn
        self.node = node

    @property
    def cpd(self):
        return self.vbn.cpd_spec(self.node)

    @property
    def params(self):
        return self.vbn.params[self.node]

    @property
    def parents(self):
        return self.vbn.dag.parents(self.node)

    def _tensor_2d(self, value) -> torch.Tensor:
        arr = _as_tensor(value, self.vbn.device)
        if arr.ndim > 2:
            raise ValueError(
                f"Expected scalar/1D/2D value, got shape {tuple(arr.shape)}")
        return arr.reshape(-1, 1) if arr.ndim < 2 else arr

    # -- parent coercion -----------------------------------------------------
    def _coerce_parents(self, parents) -> Optional[torch.Tensor]:
        cpd = self.cpd
        if cpd.input_dim == 0:
            return None
        if parents is None:
            raise ValueError(
                f"Node {self.node!r} requires parent values for "
                f"{list(self.parents)}"
            )
        if isinstance(parents, dict):
            cols = []
            for p in self.parents:
                if p not in parents:
                    raise ValueError(f"Missing parent value for {p!r}")
                cols.append(self._tensor_2d(parents[p]))
            b = max(c.shape[0] for c in cols)
            arr = torch.cat([c.expand(b, -1) if c.shape[0] == 1 else c
                             for c in cols], dim=-1)
        else:
            arr = self._tensor_2d(parents)
        if arr.shape[-1] != cpd.input_dim:
            raise ValueError(
                f"Expected parent dim {cpd.input_dim}, got {arr.shape[-1]}"
            )
        return arr

    # -- compute -------------------------------------------------------------
    def sample(self, parents=None, n_samples: int = 100) -> torch.Tensor:
        arr = self._coerce_parents(parents)
        return self.cpd.sample(self.params, self.vbn.next_key().generator, arr,
                               n_samples)

    def conditional_samples(self, parents=None, n_samples: int = 100):
        return self.sample(parents, n_samples)

    def log_prob(self, x, parents=None) -> torch.Tensor:
        arr = self._coerce_parents(parents)
        return self.cpd.log_prob(self.params, x, arr)

    def pdf(self, x, parents=None) -> torch.Tensor:
        return torch.exp(self.log_prob(x, parents))

    def forward(self, parents=None, n_samples: int = 100) -> CPDOutput:
        arr = self._coerce_parents(parents)
        return self.cpd.forward(self.params, self.vbn.next_key().generator, arr,
                                n_samples)

    # -- exact conditional extraction ----------------------------------------
    def conditional(self, parents=None, n_samples: int = 256) -> Dict[str, Any]:
        """Closed-form conditional if the family exposes one, else empirical."""
        cpd = self.cpd
        flat = self._coerce_parents(parents)
        if hasattr(cpd, "mixture_params"):
            logits, loc, scale = cpd.mixture_params(self.params, flat)
            return {
                "type": "mixture_params",
                "log_weights": torch.log_softmax(logits, dim=-1),
                "weights": torch.softmax(logits, dim=-1),
                "loc": loc,
                "scale": scale,
            }
        if hasattr(cpd, "categorical_probs"):
            out = {"type": "categorical_probs",
                   "probs": cpd.categorical_probs(self.params, flat)}
            if hasattr(cpd, "support_values"):
                out["support"] = cpd.support_values(self.params)
            return out
        if hasattr(cpd, "conditional_params"):
            loc, scale = cpd.conditional_params(self.params, flat)
            return {"type": "normal_params", "loc": loc, "scale": scale}
        return {"type": "empirical_samples",
                "samples": self.sample(parents, n_samples)}

    def conditional_mean_std(self, parents=None, n_samples: int = 256):
        cond = self.conditional(parents, n_samples)
        if cond["type"] == "normal_params":
            return cond["loc"], cond["scale"]
        if cond["type"] == "mixture_params":
            w = cond["weights"][..., None]
            mean = (w * cond["loc"]).sum(dim=-2)
            second = (w * (cond["scale"] ** 2 + cond["loc"] ** 2)).sum(dim=-2)
            return mean, torch.sqrt(torch.clamp(second - mean**2, min=1e-12))
        if cond["type"] == "categorical_probs":
            probs = cond["probs"]
            support = cond.get("support")
            if support is None:
                support = torch.arange(probs.shape[-1], dtype=torch.float32,
                                       device=probs.device)
            support = support.float()
            mean = (probs * support).sum(dim=-1, keepdim=True)
            second = (probs * support**2).sum(dim=-1, keepdim=True)
            return mean, torch.sqrt(torch.clamp(second - mean**2, min=1e-12))
        samples = cond["samples"]
        return samples.mean(dim=1), samples.std(dim=1, unbiased=False)

    # -- introspection -------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        cpd = self.cpd
        return {
            "node": self.node,
            "cpd": cpd.registry_key,
            "class": type(cpd).__name__,
            "input_dim": cpd.input_dim,
            "output_dim": cpd.output_dim,
            "parents": list(self.parents),
            "n_parameters": sum(x.numel() for x in _leaves(self.params)),
            "init_kwargs": cpd.get_init_kwargs(),
        }

    def export_config(self) -> Dict[str, Any]:
        return {"cpd": self.cpd.registry_key, **(self.cpd.get_init_kwargs() or {})}

    def state_dict(self) -> Dict[str, Any]:
        return self.params

    def clone_cpd(self):
        """(spec, deep-copied params) for standalone use."""
        return copy.copy(self.cpd), copy.deepcopy(self.params)
