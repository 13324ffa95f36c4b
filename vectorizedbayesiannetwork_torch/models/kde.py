"""Conditional Gaussian-KDE CPD.

Port of ``vectorizedbayesiannetwork_tpu/models/kde.py``: the CPD stores up
to ``max_points`` (parents, target) pairs in fixed ``max_points``-row
arrays with a validity mask; the log-density is a parent-kernel-weighted
logsumexp over the stored points, and a draw picks a support point by
parent-softmax weighting, then adds bandwidth noise (the JAX package draws
the pick as a Gumbel-argmax; ``vbn_kde_pick`` by inverse CDF on one
uniform a row, the same distribution).
``bandwidth="scott"`` resolves Scott-rule bandwidths on the host at fit
time, in numpy float32 as the JAX package does, so both packages resolve
the same bandwidths from the same data.

The log-density goes through ``ops/kde_kernel.py``'s dispatch to the
wrappers of ``ops/kde_fused.py``: their CUDA kernels on the card, their
plain versions on the CPU. A pick of up to 32 parent features runs
``kde_pick`` (``vbn_kde_pick`` on the card, its plain version on the CPU,
on the same Philox uniforms); a node with more than 32 parent features
picks through the chunked torch form (``kde_sample_indices``) on a
uniform of the row stream, as the JAX package sends such picks to XLA.

A fit with more than ``max_points`` rows keeps a uniform subset drawn with
``torch.randperm`` from the fit's generator: the same distribution as the
JAX package's ``jax.random.permutation``, not the same subset.

``update`` appends the new rows to the stored ones and stores them all
while they fit in ``max_points``, else a uniform subset (``_pack``);
``update_program`` keeps the ``max_points`` rows' shape and re-subsamples
the stored and new rows by a Gumbel top-k over the valid ones: the same
distribution (a uniform subset, all of them when they fit), the rows in
another order. Neither re-resolves the bandwidths.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.base import BaseCPD, Params
from ..core.registry import register_cpd
from ..core.rng import NodeStream, normals, uniforms
from ..ops.kde_fused import _DIRECT_D, RowMap, kde_pick, pick_key, seed_key
from ..ops.kde_kernel import kde_log_prob, kde_sample_indices


@register_cpd("kde")
class KDECPD(BaseCPD):
    # the pick's in-kernel stream is keyed by the node (NodeStream.seed):
    # the level-grouped sweep samples KDE nodes one by one, as the JAX
    # package's does
    sample_groupable = False
    # the pick and the log-density retire the rows nobody reads
    # (ops/kde_fused.py, the read flag)
    takes_read_flag = True

    def _vmappable(self) -> bool:
        """No: the pick and the log-density are hand-kernel launches on the
        card, and no kernel launches under ``torch.func.vmap`` (the JAX
        package vmaps its KDE evidence nodes; here they score one by
        one)."""
        return False

    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        *,
        seed: Optional[int] = None,
        bandwidth="scott",
        parent_bandwidth=None,
        max_points: int = 1000,
        min_scale: float = 1e-3,
        **_ignored,
    ) -> None:
        super().__init__(input_dim, output_dim, seed=seed)
        self._bw_mode = str(bandwidth) if isinstance(bandwidth, str) else None
        if self._bw_mode is not None and self._bw_mode != "scott":
            raise ValueError(
                f"Unknown bandwidth rule {bandwidth!r}; use a float or 'scott'."
            )
        self.bandwidth = 1.0 if self._bw_mode else float(bandwidth)
        self._p_bw_follows = parent_bandwidth is None
        self.parent_bandwidth = (
            self.bandwidth if self._p_bw_follows else float(parent_bandwidth)
        )
        self.max_points = int(max_points)
        self.min_scale = float(min_scale)

    def get_init_kwargs(self):
        return {
            "bandwidth": self._bw_mode or self.bandwidth,
            "parent_bandwidth": (
                None if self._p_bw_follows else self.parent_bandwidth
            ),
            "max_points": self.max_points,
            "min_scale": self.min_scale,
        }

    def get_extra_state(self):
        # resolved bandwidths survive save/load (the rule ran at fit time)
        return {
            "bandwidth": self.bandwidth,
            "parent_bandwidth": self.parent_bandwidth,
        }

    def set_extra_state(self, state) -> None:
        if not state:
            return
        self.bandwidth = float(state.get("bandwidth", self.bandwidth))
        self.parent_bandwidth = float(
            state.get("parent_bandwidth", self.parent_bandwidth)
        )

    def _resolve_bandwidths(self, parents, x: np.ndarray) -> None:
        """Scott rule: bw = mean-dim sigma * n_eff^(-1/(d+4)), d the joint
        (parents + target) dimension."""
        if self._bw_mode is None:
            return
        x_np = np.asarray(x, np.float32).reshape(x.shape[0], -1)
        n_eff = max(2, min(x_np.shape[0], self.max_points))
        d = self.input_dim + self.output_dim
        rate = float(n_eff) ** (-1.0 / (d + 4))
        sig_y = float(np.mean(np.std(x_np, axis=0))) or 1.0
        self.bandwidth = max(sig_y * rate, 1e-3)
        if parents is not None and self.input_dim:
            p_np = np.asarray(parents, np.float32)
            p_np = p_np.reshape(p_np.shape[0], -1)
            sig_p = float(np.mean(np.std(p_np, axis=0))) or 1.0
            self.parent_bandwidth = max(sig_p * rate, 1e-3)
        else:
            self.parent_bandwidth = self.bandwidth

    def _static_fields(self) -> tuple:
        return (self.bandwidth, self.parent_bandwidth, self.max_points,
                self.min_scale)

    # -- lifecycle ----------------------------------------------------------
    def init(self, device, gen=None) -> Params:
        f32 = dict(dtype=torch.float32, device=device)
        m = self.max_points
        return {
            "data_p": torch.zeros((m, self.input_dim), **f32),
            "data_x": torch.zeros((m, self.output_dim), **f32),
            "valid": torch.zeros((m,), **f32),
        }

    def _pack(self, gen: Optional[torch.Generator], parents, x, device):
        """Subsample to max_points into fixed-shape arrays + mask."""
        f32 = dict(dtype=torch.float32, device=device)
        x = torch.as_tensor(np.asarray(x, np.float32), **f32)
        x = x.reshape(x.shape[0], -1)
        n = x.shape[0]
        if parents is None:
            parents = torch.zeros((n, 0), **f32)
        else:
            parents = torch.as_tensor(np.asarray(parents, np.float32), **f32)
            parents = parents.reshape(-1, parents.shape[-1])
        if parents.shape[0] != n:
            raise ValueError("parents and x must have the same number of rows")
        m = self.max_points
        if n > m:
            if gen is None:
                raise ValueError(
                    f"{n} rows > max_points {m}: the subsample needs a generator"
                )
            idx = torch.randperm(n, generator=gen, device=gen.device)[:m]
            idx = idx.to(device)
            parents, x, n = parents[idx], x[idx], m
        pad = m - n
        return {
            "data_p": torch.cat([parents, torch.zeros((pad, self.input_dim), **f32)]),
            "data_x": torch.cat([x, torch.zeros((pad, self.output_dim), **f32)]),
            "valid": torch.cat([torch.ones((n,), **f32), torch.zeros((pad,), **f32)]),
        }

    def fit(self, params, parents, x, *, device, gen=None, **_training) -> Params:
        """Resolve the bandwidths, then store (a uniform subset of) the
        rows; ``gen`` draws the subset when there are more than
        ``max_points``. Training keys are accepted and unused."""
        self._resolve_bandwidths(parents, np.asarray(x))
        return self._pack(gen, parents, x, device)

    def update(self, params, parents, x, *, device, gen=None, **_training):
        n_old = int(params["valid"].sum().item())
        x = np.asarray(x, np.float32).reshape(-1, self.output_dim)
        xs = np.concatenate([params["data_x"][:n_old].cpu().numpy(), x])
        if not self.input_dim:
            return self._pack(gen, None, xs, device)
        p = np.asarray(parents, np.float32).reshape(x.shape[0], -1)
        ps = np.concatenate([params["data_p"][:n_old].cpu().numpy(), p])
        return self._pack(gen, ps, xs, device)

    def update_program(self, conf):
        """The fixed-shape update: a Gumbel top-k over the stored and new
        rows, the invalid ones last."""

        def fn(params, gen, parents, x, *, device):
            f32 = dict(dtype=torch.float32, device=device)
            x = torch.as_tensor(np.asarray(x, np.float32), **f32)
            x = x.reshape(x.shape[0], -1)
            n_new = x.shape[0]
            p = (torch.zeros((n_new, 0), **f32) if parents is None else
                 torch.as_tensor(np.asarray(parents, np.float32), **f32
                                 ).reshape(n_new, -1))
            pool_p = torch.cat([params["data_p"], p])
            pool_x = torch.cat([params["data_x"], x])
            pool_v = torch.cat([params["valid"], torch.ones((n_new,), **f32)])
            u = torch.clamp(torch.rand(pool_v.shape, generator=gen,
                                       device=device),
                            min=float(np.finfo(np.float32).tiny))
            g = torch.where(pool_v > 0, -torch.log(-torch.log(u)), -1e30)
            idx = torch.topk(g, self.max_points).indices
            return {"data_p": pool_p[idx], "data_x": pool_x[idx],
                    "valid": pool_v[idx]}

        return fn

    # -- kernels ----------------------------------------------------------
    def _y_scale(self) -> float:
        return max(float(self.bandwidth), 1e-3) + self.min_scale

    def _p_scale(self) -> float:
        return max(float(self.parent_bandwidth), 1e-3) + self.min_scale

    @staticmethod
    def _log_mask(params: Params) -> torch.Tensor:
        # a soft mask, log(1e-20), not -inf: the JAX package's choice, kept
        # so both packages give the same log-densities
        return torch.log(torch.clamp(params["valid"], min=1e-20))

    def _log_prob_flat(self, params, x, parents, read=None):
        return kde_log_prob(
            x,
            parents if self.input_dim else None,
            params["data_x"],
            params["data_p"],
            self._log_mask(params),
            self._y_scale(),
            self._p_scale(),
            read,
        )

    def _sample_flat(self, params, gen, parents, m, read=None):
        """The pick, then Gaussian noise at the bandwidth. Up to 32 parent
        features the pick is ``kde_pick``'s inverse CDF on its own Philox
        stream, keyed by the node's seed at the rows' global flat rows on a
        row stream (a ``pick_key`` from a generator), and skips the rows
        ``read`` does not read (their draws are then noise about 0); past
        32 the chunked pick on slot 0. The noise takes the slots from 4
        on."""
        log_mask = self._log_mask(params)
        data_x = params["data_x"]
        dev = data_x.device
        if self.input_dim <= _DIRECT_D:
            if isinstance(gen, NodeStream):
                st = gen.stream
                key = seed_key(gen.seed, dev)
                rows = RowMap.of(st.row0, st.particle0, st.s, st.n_particles)
            else:
                key, rows = pick_key(gen, dev), RowMap()
            selected = kde_pick(
                key, parents.contiguous() if self.input_dim else None,
                params["data_p"], data_x, log_mask, self._p_scale(), m,
                rows=rows, read=read,
            )
        else:
            idx = kde_sample_indices(
                uniforms(gen, m, 1, dev)[:, 0], parents, params["data_p"],
                log_mask, self._p_scale(), m,
            )
            selected = data_x[idx]
        noise = normals(gen, m, selected.shape[1], dev, at=4,
                        dtype=selected.dtype)
        return selected + noise * (max(self.bandwidth, 1e-3) + self.min_scale)
