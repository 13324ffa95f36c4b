"""Stacked-weight ancestral sweep for all-linear-Gaussian networks.

Counterpart of ``vectorizedbayesiannetwork_tpu/inference/_gaussian_sweep.py``
and the Gaussian twin of ``_discrete_sweep.py``: when every node is a
``linear_gaussian`` with ``output_dim`` 1, the whole DAG is one Python loop
over topological order on stacked padded parameters:

  * each node's weights padded to ``[N, Pmax]`` (absent parents weigh 0),
    its bias, and ``scale = sqrt(max(var, min_scale^2))``;
  * a step gathers the parents' values, computes ``loc = w . parents + b``,
    draws the Gaussian, clamps evidence and do values, and adds the
    log-weights.

The JAX form draws its whole ``eps [B, S, N]`` at once; here a step takes
its ``[B, S]`` from the call's row stream (node i, slots 0 and 1: at 96
rows, 2^14 particles and 2048 nodes the whole field alone would be 12.9
GB), drawn ahead a chunk of nodes a ``vbn_uniforms`` launch
(``core/rng.py::ChunkedDraws``, at most 256 MB). ``noise`` takes the JAX
package's ``[B, S, N]`` draws instead. The state is node-major ``[N, B,
S]`` and is returned as its ``[B, S, N]`` view.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.plan import InferencePlan
from ..core.rng import ChunkedDraws
from ..ops.gauss import LOG_2PI


def gaussian_sweep_supported(plan: InferencePlan, cpds: Sequence) -> bool:
    from ..models.linear_gaussian import LinearGaussianCPD

    return all(
        isinstance(cpd, LinearGaussianCPD) and cpd.output_dim == 1
        for cpd in cpds
    )


def _stacked_params(plan: InferencePlan, cpds: Sequence, params_tuple,
                    pmax: int):
    """(weights [N, Pmax], bias [N], scale [N]) on the params' device."""
    w_rows, biases, scales = [], [], []
    for cpd, params in zip(cpds, params_tuple):
        w = params["weight"][:, 0].float()  # [Din]
        w_rows.append(torch.nn.functional.pad(w, (0, pmax - w.shape[0])))
        biases.append(params["bias"][0].float())
        scales.append(torch.sqrt(torch.clamp(params["var"][0].float(),
                                             min=cpd.min_scale ** 2)))
    return torch.stack(w_rows), torch.stack(biases), torch.stack(scales)


def gaussian_sweep_trace(
    plan: InferencePlan,
    cpds: Sequence,
    params_tuple: Tuple,
    stream,  # core.rng.RowStream, or None with ``noise``
    fixed: torch.Tensor,  # [B, total_dim]
    n_samples: int,
    *,
    weighted: bool = False,
    ev_mask_arr=None,  # [B, N] runtime evidence mask (overrides the plan)
    fx_mask_arr=None,  # [B, N] runtime evidence|do mask
    tgt_mask_arr=None,  # [B, N] one-hot target -> extra lp_tgt output
    noise: Optional[torch.Tensor] = None,  # [B, S, N] standard normals
) -> Tuple[torch.Tensor, ...]:
    """Drop-in stacked-weight replacement for ``sweep_trace`` (same
    contract): ``(packed [B, S, N], log_weights [B, S])``, and with
    ``tgt_mask_arr`` a third output, each row's target log-density at its
    final value. With ``ev_mask_arr``/``fx_mask_arr`` the masks are per
    row (mask-dynamic sweeps)."""
    dev = fixed.device
    n = plan.n_nodes
    b, s = fixed.shape[0], n_samples
    if noise is not None and tuple(noise.shape) != (b, s, n):
        raise ValueError(f"noise {tuple(noise.shape)} != {(b, s, n)}")
    pmax = max(max((len(p) for p in plan.parent_idx), default=0), 1)
    parent_ids = np.zeros((n, pmax), np.int64)
    for i, pidx in enumerate(plan.parent_idx):
        parent_ids[i, : len(pidx)] = pidx
    parent_ids = torch.as_tensor(parent_ids, device=dev)
    weights, bias, scale = _stacked_params(plan, cpds, params_tuple, pmax)
    log_scale = torch.log(scale)
    if ev_mask_arr is not None:
        ev_mask = (ev_mask_arr > 0).T  # [N, B] node-major
        fx_mask = (fx_mask_arr > 0).T
    else:
        ev_mask = torch.as_tensor(np.asarray(plan.evidence_mask, bool),
                                  device=dev)[:, None]
        fx_mask = torch.as_tensor(
            np.asarray([plan.is_fixed(i) for i in range(n)], bool),
            device=dev)[:, None]
    tg_mask = None if tgt_mask_arr is None else (tgt_mask_arr > 0).T
    fixed = fixed.float()

    ahead = None if noise is not None else ChunkedDraws(stream, n, normal=True)
    states = torch.empty((n, b, s), dtype=torch.float32, device=dev)
    logw = torch.zeros((b, s), dtype=torch.float32, device=dev)
    lpt = torch.zeros((b, s), dtype=torch.float32, device=dev)
    for i in range(n):
        k = len(plan.parent_idx[i])
        if k:
            pvals = states.index_select(0, parent_ids[i, :k])  # [k, B, S]
            loc = (pvals * weights[i, :k, None, None]).sum(0) + bias[i]
        else:
            loc = bias[i].expand(b, s)
        eps = noise[..., i] if noise is not None else ahead(i).reshape(b, s)
        sampled = loc + scale[i] * eps
        value = torch.where(fx_mask[i][:, None], fixed[:, i][:, None], sampled)
        states[i] = value
        if weighted or tg_mask is not None:
            z = (value - loc) / scale[i]
            lp = -0.5 * (z * z + LOG_2PI) - log_scale[i]
            if weighted:
                logw = logw + torch.where(ev_mask[i][:, None], lp, 0.0)
            if tg_mask is not None:
                lpt = lpt + torch.where(tg_mask[i][:, None], lp, 0.0)
    packed = states.permute(1, 2, 0)
    if tg_mask is not None:
        return packed, logw, lpt
    return packed, logw
