"""Mask-dynamic exact conditioning for all-linear-Gaussian networks.

Port of ``vectorizedbayesiannetwork_tpu/inference/_lg_exact.py``. When
every node is a scalar linear-Gaussian CPD the joint is Gaussian, and any
``p(target | evidence, do(...))`` is an exact Gaussian computed in closed
form from the fitted params. One function per network answers every query
skeleton, batched over query rows (n = #nodes):

- structural system ``x = c + Bx + eps``, B strictly lower-triangular in
  topological order, assembled from each node's (weight, bias, var);
- do() surgery per row (intervened rows of B zeroed, bias pinned to the
  value, noise 1e-12), then ``A = (I - B)^-1`` by one batched unit
  lower-triangular solve, ``mu = A c``, ``Sigma = A diag(d) A^T``;
- evidence conditioning per row through the masked system
  ``K = (e e^T) * Sigma + diag(1 - e + 1e-9 e)``: one batched solve with
  two right-hand sides gives the conditional mean and the target variance
  without a row-dependent submatrix.

Everything is float32. The JAX package asks for ``Precision.HIGHEST`` in
its products; the PyTorch counterpart is full float32 matmuls on the card,
which is PyTorch's default (``torch.backends.cuda.matmul.allow_tf32`` is
False unless a caller turns it on); the tests and ``chip_smoke.py`` set it
off explicitly.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core.plan import InferencePlan


def lg_exact_supported(plan: InferencePlan, cpds: Sequence) -> bool:
    from ..models.linear_gaussian import LinearGaussianCPD

    return all(
        isinstance(c, LinearGaussianCPD) and plan.node_dims[i] == 1
        for i, c in enumerate(cpds)
    )


def make_lg_exact_fn(plan: InferencePlan, cpds: Sequence):
    """``fn(params_tuple, packed_in) -> (moments [B, 2],)``, ``packed_in``
    the (fixed, ev_mask, do_mask, target_idx) tensors of
    ``pack_dynamic_inputs``."""
    n = plan.n_nodes
    # node i's j-th weight lands at B[i, parent_j], in this order
    rows = [i for i in range(n) for _ in plan.parent_idx[i]]
    cols = [p for i in range(n) for p in plan.parent_idx[i]]
    min_var = np.float32([c.min_scale**2 for c in cpds])

    def fn(params_tuple, packed_in):
        fixed, ev_mask, do_mask, target_idx = packed_in
        b, dev = fixed.shape[0], fixed.device
        eye = torch.eye(n, dtype=torch.float32, device=dev)
        bmat = torch.zeros((n, n), dtype=torch.float32, device=dev)
        if rows:
            bmat[rows, cols] = torch.cat(
                [params_tuple[i]["weight"][:, 0] for i in range(n)])
        c = torch.cat([params_tuple[i]["bias"][:1] for i in range(n)])
        d = torch.maximum(torch.cat([params_tuple[i]["var"][:1]
                                     for i in range(n)]),
                          torch.as_tensor(min_var, device=dev))

        # per-row do() surgery
        offs = torch.as_tensor(plan.node_offsets, device=dev)
        vals = fixed[:, offs]  # [B, n]
        dob = do_mask > 0
        bb = bmat[None] * (1.0 - do_mask)[:, :, None]
        cb = torch.where(dob, vals, c[None, :])
        db = torch.where(dob, torch.full_like(vals, 1e-12), d[None, :])
        a = torch.linalg.solve_triangular(
            eye[None] - bb, eye.expand(b, n, n), upper=False,
            unitriangular=True)  # [B, n, n]
        mu = torch.einsum("bij,bj->bi", a, cb)
        sigma = torch.einsum("bik,bk,bjk->bij", a, db, a)

        # evidence conditioning: K_ij = e_i e_j Sigma_ij + delta_ij
        # (m_i + 1e-9 e_i)
        e = ev_mask
        k = sigma * (e[:, :, None] * e[:, None, :]) + eye[None] * (
            (1.0 - e) + 1e-9 * e)[:, :, None]
        tgt = torch.nn.functional.one_hot(target_idx.long(), n).float()
        st = torch.einsum("bij,bj->bi", sigma, tgt)  # Sigma[:, t]
        gh = torch.linalg.solve(
            k, torch.stack([e * (vals - mu), e * st], dim=-1))  # [B, n, 2]
        mean_all = mu + torch.einsum("bij,bj->bi", sigma, e * gh[..., 0])
        var_t = (tgt * st).sum(1) - (st * (e * gh[..., 1])).sum(1)
        mean_t = (tgt * mean_all).sum(1)

        # a target clamped by evidence or do: the value, std 0
        fx_t = (tgt * torch.maximum(ev_mask, do_mask)).sum(1) > 0
        mean_t = torch.where(fx_t, (tgt * vals).sum(1), mean_t)
        std_t = torch.where(fx_t, torch.zeros_like(var_t),
                            torch.sqrt(torch.clamp(var_t, min=1e-12)))
        return (torch.stack([mean_t, std_t], dim=1),)

    return fn
