"""Data-parallel fit steps: row-sharded sufficient statistics and gradients.

Port of ``vectorizedbayesiannetwork_tpu/parallel/train.py``. The JAX steps
take row-sharded global arrays and let XLA turn every sum over rows into a
psum over the mesh; here every rank passes its own row block
(``shard_rows``) and the sums over rows are ``all_reduce``-d over both mesh
axes. Params and optimizer state stay replicated: every rank computes the
same update from the same reduced statistics.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models._optim import adam_init, adam_step, tree_leaves, tree_unflatten
from .mesh import DATA_AXIS, PARTICLE_AXIS, active_mesh, all_reduce, constrain_rows


def _mesh_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` summed over every rank of the mesh."""
    return all_reduce(all_reduce(t, mesh, PARTICLE_AXIS), mesh, DATA_AXIS)


def shard_rows(mesh, *arrays):
    """This rank's row block of each [N, D] array, as float32 tensors on
    the mesh's device type: block ``di * n_particle + pi``, the JAX
    ``P(('data', 'particle'), None)`` order. N must split evenly."""
    dev = torch.device(mesh.device_type)
    with active_mesh(mesh):
        out = tuple(constrain_rows(torch.as_tensor(np.asarray(a, np.float32),
                                                   device=dev)).contiguous()
                    for a in arrays)
    return out if len(out) > 1 else out[0]


def linear_gaussian_fit_step(mesh, parents: torch.Tensor, x: torch.Tensor,
                             ridge: float = 1e-6) -> Dict[str, torch.Tensor]:
    """Closed-form ridge fit of this rank's rows with every other rank's.

    The local Gram matrix and right-hand side are summed over the mesh,
    then the small solve is replicated. The residual variance is taken
    over all rows as ``jnp.var`` takes it: the global mean first, then the
    mean of the squared deviations."""
    n = x.new_tensor([float(x.shape[0])])
    xa = torch.cat([parents, torch.ones_like(x[:, :1])], dim=1)
    din = parents.shape[1]
    reg = ridge * torch.eye(din + 1, dtype=x.dtype, device=x.device)
    reg[din, din] = 0.0  # bias not regularized
    gram = _mesh_sum(xa.T @ xa, mesh) + reg
    rhs = _mesh_sum(xa.T @ x, mesh)
    theta = torch.linalg.solve(gram, rhs)
    resid = x - xa @ theta
    n_tot = _mesh_sum(n, mesh)
    mean = _mesh_sum(resid.sum(dim=0), mesh) / n_tot
    var = _mesh_sum(((resid - mean) ** 2).sum(dim=0), mesh) / n_tot
    return {"weight": theta[:-1], "bias": theta[-1],
            "var": torch.clamp(var, min=1e-6)}


def gaussian_nn_dp_step(
    mesh,
    cpd,
    net,
    opt: Optional[Dict],
    parents: torch.Tensor,
    x: torch.Tensor,
    *,
    lr: float = 1e-3,
    weight_decay: float = 0.0,
) -> Tuple[Dict, Dict]:
    """One data-parallel Adam step of a ``gaussian_nn`` CPD's net on the
    mean NLL over the global batch: each rank's gradient of its rows' mean
    NLL is weighted by its share of the rows and summed over the mesh."""
    if opt is None:
        opt = adam_init(net)
    leaves = [t.detach().clone().requires_grad_(True) for t in tree_leaves(net)]
    with torch.enable_grad():
        loss = cpd._nll(tree_unflatten(net, leaves), parents, x)
        grads = torch.autograd.grad(loss, leaves)
    n = x.new_tensor(float(x.shape[0]))
    share = n / _mesh_sum(n, mesh)
    grads = [_mesh_sum(g * share, mesh) for g in grads]
    return adam_step(net, tree_unflatten(net, grads), opt, lr, weight_decay)
