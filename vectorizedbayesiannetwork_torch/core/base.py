"""Core abstractions: Query and the functional CPD contract.

Counterpart of ``vectorizedbayesiannetwork_tpu/core/base.py``. A CPD is a
static, host-side spec object; its tensor state is a plain dict of tensors
(``params``) that lives on one device. Compute methods are functions of
``(params, generator, inputs)`` with an explicit ``torch.Generator``.

Flat primitives that the inference sweep calls on ``[B*S, ...]`` tensors:
  - ``_sample_flat(params, gen, parents2d|None, m) -> [m, Dout]``
  - ``_log_prob_flat(params, x2d, parents2d|None) -> [m]``
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


@dataclass
class Query:
    """Posterior query: evidence conditions; do clamps without likelihood."""

    target: str
    evidence: Dict[str, Any]
    do: Dict[str, Any] = field(default_factory=dict)


class BaseCPD(ABC):
    """Static CPD spec. All array state lives in a params dict."""

    registry_key: str = "?"

    def __init__(
        self, input_dim: int, output_dim: int, *, seed: Optional[int] = None
    ) -> None:
        self.input_dim = int(input_dim)
        self.output_dim = int(output_dim)
        self.seed = 0 if seed is None else int(seed)

    def _static_fields(self) -> tuple:
        return ()

    def static_signature(self) -> tuple:
        return (
            type(self).__name__,
            self.input_dim,
            self.output_dim,
            self._static_fields(),
        )

    @abstractmethod
    def init(self, device: torch.device) -> Params:
        """Create the initial parameter dict on ``device``."""

    @abstractmethod
    def fit(
        self,
        params: Params,
        parents: Optional[np.ndarray],
        x: np.ndarray,
        *,
        device: torch.device,
        **kwargs,
    ) -> Params:
        """Fit from host data; returns new params on ``device``."""

    @abstractmethod
    def _sample_flat(
        self,
        params: Params,
        gen: torch.Generator,
        parents: Optional[torch.Tensor],
        m: int,
    ) -> torch.Tensor:
        """One draw per row: parents [m, Din] or None -> [m, Dout]."""

    @abstractmethod
    def _log_prob_flat(
        self, params: Params, x: torch.Tensor, parents: Optional[torch.Tensor]
    ) -> torch.Tensor:
        """x [m, Dout], parents [m, Din] or None -> [m]."""

    def get_init_kwargs(self) -> Dict[str, Any]:
        return {}

    def get_extra_state(self) -> Optional[Dict[str, Any]]:
        return None

    def set_extra_state(self, state: Optional[Dict[str, Any]]) -> None:
        return None
