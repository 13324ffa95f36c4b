"""Core abstractions: Query and the functional CPD contract.

Counterpart of ``vectorizedbayesiannetwork_tpu/core/base.py``. A CPD is a
static, host-side spec object; its tensor state is a plain dict of tensors
(``params``) that lives on one device. Compute methods are functions of
``(params, source, inputs)`` with an explicit source of randomness.

Flat primitives that the inference sweep calls on ``[B*S, ...]`` tensors:
  - ``_sample_flat(params, src, parents2d|None, m) -> [m, Dout]``
  - ``_log_prob_flat(params, x2d, parents2d|None) -> [m]``

``src`` is either a ``torch.Generator`` (fits, handles, the MCMC chains'
steps) or a ``core.rng.NodeStream``, the node's slice of a sweep's row
stream: then the draw of row b, particle p takes the stream's slots at
counter (p, b, node), so it does not depend on the batch. A CPD draws
through ``core.rng.uniforms`` / ``normals``, which take either; a second
draw of one node starts at ``core.rng.next_slot`` of the first's slots.

and the public ``[B, S, D]`` API over them (``sample``, ``log_prob``,
``forward``) that ``core/handle.py`` calls.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


class CPDOutput(NamedTuple):
    samples: torch.Tensor  # [B, S, Dx]
    log_prob: torch.Tensor  # [B, S]
    pdf: torch.Tensor  # [B, S]


def _as_tensor(value, device) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(value, np.float32), device=device)


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

    # -- level grouping (inference/_sweep.py) -------------------------------
    # Same-signature nodes of a topological level sample as one
    # ``torch.func.vmap``-ed ``_sample_flat`` over their stacked params; a
    # family whose sample cannot run so opts out and samples node by node.
    sample_groupable = True

    # -- read flags (inference/_dynamic_sweep.py) ----------------------------
    # A family whose ``_sample_flat`` and ``_log_prob_flat`` take ``read=``
    # (an ``ops.kde_fused.ReadFlag``: the rows whose results the caller
    # reads) and may skip the others; the mask-dynamic sweep passes one to
    # such a family only.
    takes_read_flag = False

    def _eval_params(self, params: Params) -> Params:
        """The part of ``params`` that ``_sample_flat`` / ``_log_prob_flat``
        read: the optimizer state (``"opt"``, which the neural families keep
        beside their weights) dropped, so the group's trees stack."""
        if isinstance(params, dict) and "opt" in params:
            return {k: v for k, v in params.items() if k != "opt"}
        return params

    def _draws(self) -> Optional[Tuple[Tuple[int, int, bool], ...]]:
        """The ``(k, at, normal)`` draws ``_sample_flat`` makes from a row
        stream, in order (``core.rng.uniforms`` / ``normals`` with ``k``
        values from slot ``at``). A level group makes them ahead, one
        ``vbn_uniforms`` launch each for the whole group, since no kernel
        launches under ``vmap``. None: not declared, and the group samples
        node by node."""
        return None

    def _vmappable(self) -> bool:
        """Whether ``_sample_flat`` and ``_log_prob_flat`` run under
        ``torch.func.vmap`` at this node's settings (a bf16 network's
        product is an autograd Function with no vmap rule)."""
        return True

    @abstractmethod
    def init(self, device: torch.device,
             gen: Optional[torch.Generator] = None) -> Params:
        """Create the initial parameter dict on ``device``; families with
        random initial weights draw them from ``gen`` (the fit's
        generator)."""

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

    def update(
        self,
        params: Params,
        parents: Optional[np.ndarray],
        x: np.ndarray,
        *,
        device: torch.device,
        gen: Optional[torch.Generator] = None,
        **kwargs,
    ) -> Params:
        """Online update from host data; the default refits (closed-form
        CPDs), the gradient CPDs continue training from their ``opt``
        state."""
        return self.fit(params, parents, x, device=device, gen=gen, **kwargs)

    def update_program(self, conf: Dict) -> Optional[Callable]:
        """``fn(params, gen, parents, x, *, device) -> params``, the
        update as a function of fixed-shape inputs that refines no spec
        field, or None when the update needs host work (spec refinement,
        data-dependent shapes). The update policies take this route when
        every node has one (``update/policies.py``); the port runs it
        eagerly like ``update``, but the route still decides the function
        (the KDE program re-subsamples by a fixed-shape Gumbel top-k)."""
        return None

    def update_host_precheck(
        self, params: Params, parents: Optional[np.ndarray], x: np.ndarray
    ) -> None:
        """Host-side (numpy) validation run before the program route;
        raises where the eager ``update`` would."""
        return None

    @abstractmethod
    def _sample_flat(
        self,
        params: Params,
        gen,  # torch.Generator or core.rng.NodeStream
        parents: Optional[torch.Tensor],
        m: int,
    ) -> torch.Tensor:
        """One draw per row: parents [m, Din] or None -> [m, Dout]."""

    @abstractmethod
    def _log_prob_flat(
        self, params: Params, x: torch.Tensor, parents: Optional[torch.Tensor]
    ) -> torch.Tensor:
        """x [m, Dout], parents [m, Din] or None -> [m]."""

    # -- public [B, S, D] API -------------------------------------------------
    def _coerce_parents(self, parents, n_samples: int, device):
        """Parents as ([B*S, Din] or None, B, S): 1-D and 2-D parents are
        one row set broadcast over the S samples, 3-D ones [B, S or 1, Din]."""
        if self.input_dim == 0:
            if parents is None:
                return None, 1, n_samples
            arr = _as_tensor(parents, device)
            return None, int(arr.shape[0]) if arr.ndim >= 1 else 1, n_samples
        if parents is None:
            raise ValueError("parents cannot be None when input_dim > 0")
        arr = _as_tensor(parents, device)
        if arr.ndim == 1:
            arr = arr.reshape(-1, 1)
        if arr.ndim == 2:
            arr = arr[:, None, :].expand(-1, n_samples, -1)
        if arr.ndim != 3:
            raise ValueError(f"Expected parents 1D/2D/3D, got {tuple(arr.shape)}")
        if arr.shape[1] != n_samples:
            if arr.shape[1] != 1:
                raise ValueError(
                    f"parents sample axis {arr.shape[1]} != n_samples {n_samples}"
                )
            arr = arr.expand(-1, n_samples, -1)
        if arr.shape[-1] != self.input_dim:
            raise ValueError(
                f"Expected parent dim {self.input_dim}, got {arr.shape[-1]}"
            )
        b, s, d = arr.shape
        return arr.reshape(b * s, d), b, s

    def sample(self, params: Params, gen: torch.Generator, parents,
               n_samples: int) -> torch.Tensor:
        """[B, S, Dout] draws given parents (see ``_coerce_parents``)."""
        flat, b, s = self._coerce_parents(parents, n_samples, gen.device)
        return self._sample_flat(params, gen, flat, b * s).reshape(
            b, s, self.output_dim)

    def log_prob(self, params: Params, x, parents) -> torch.Tensor:
        """[B, S] log-densities of x [B, S, Dout] (or [B, Dout], S = 1)."""
        dev = next(_leaves(params), torch.empty(0)).device
        arr = _as_tensor(x, dev)
        if arr.ndim <= 2:
            arr = (arr.reshape(1, 1) if arr.ndim == 0 else
                   arr.reshape(-1, 1) if arr.ndim == 1 else arr)[:, None, :]
        b, s, d = arr.shape
        if d != self.output_dim:
            raise ValueError(f"Expected x dim {self.output_dim}, got {d}")
        flat, _, _ = self._coerce_parents(parents, s, dev)
        return self._log_prob_flat(params, arr.reshape(b * s, d), flat
                                   ).reshape(b, s)

    def forward(self, params: Params, gen: torch.Generator, parents,
                n_samples: int) -> CPDOutput:
        samples = self.sample(params, gen, parents, n_samples)
        log_prob = self.log_prob(params, samples, parents)
        return CPDOutput(samples, log_prob, torch.exp(log_prob))

    def get_init_kwargs(self) -> Dict[str, Any]:
        return {}

    def get_extra_state(self) -> Optional[Dict[str, Any]]:
        return None

    def set_extra_state(self, state: Optional[Dict[str, Any]]) -> None:
        return None


def _leaves(tree):
    """The tensors of a nested dict/list of params, depth first."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree
