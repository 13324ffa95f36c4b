"""Records of the linear-Gaussian sweep kernels.

``vbn_lg_sweep`` (``ops/sweep.py``) and ``vbn_lg_scan``
(``ops/sweep_scan.py``) walk the same records (``csrc/lg_walk.cuh``): one
per node {out slot, parent start, bias, sigma} and one per parent {slot,
weight}, with the value-scratch slots given by liveness, and a pair of
density constants per node. Both wrappers keep their parameters as
[N, dmax + 2] rows ``[w_0 .. w_{dmax-1}, bias, sigma]`` (flat for the
scan) and their parent lists as ``pids`` [N][pmax], padded with 0 where a
node has fewer parents (pmax == dmax).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.profiling import BUILDS, spanned

_HALF_LOG_2PI = 0.9189385332046727  # log(2 pi) / 2


@functools.lru_cache(maxsize=64)
def lg_slot_map(pids):
    """The LG kernel's value-scratch slots, given by liveness: a node that
    some later node reads holds a slot from its draw to its last reader,
    and a slot freed by a node's last read serves the next node that needs
    one (the node drawn at that step included: it reads its parents before
    it writes). Every other node writes one shared trash slot, the last.
    The padded parent id 0 counts as a read, as in
    ``ops/sweep_scan.py::_compaction``, so the map holds for any weights.
    Returns (smap [N], pid_slots [N, pmax] the parents' slots, n_slots)."""
    n = len(pids)
    last = {}
    for i, row_p in enumerate(pids):
        for p in row_p:
            last[int(p)] = i
    owner_end, free, smap, top = {}, [], np.zeros((n,), np.int32), 0
    for i in range(n):
        for slot in owner_end.pop(i, []):  # slots whose last reader is i
            free.append(slot)
        if last.get(i, -1) > i:
            if free:
                smap[i] = free.pop()
            else:
                smap[i], top = top, top + 1
            owner_end.setdefault(last[i], []).append(int(smap[i]))
        else:
            smap[i] = -1
    smap[smap < 0] = top
    pid_slots = np.asarray([[smap[int(p)] for p in row_p] for row_p in pids],
                           np.int32)
    return smap, pid_slots, top + 1


@functools.lru_cache(maxsize=64)
def _lg_slots(pids, device: torch.device):
    """(smap [N + 1], the parent slots [N * pmax]) of ``lg_slot_map`` on
    ``device``, int32 (smap's last entry 0: the end record's)."""
    smap, pid_slots, _n = lg_slot_map(pids)
    return (torch.tensor(smap.tolist() + [0], dtype=torch.int32, device=device),
            torch.as_tensor(pid_slots.reshape(-1), device=device))


@spanned("vbn.tables")
def lg_records(ptab_flat: torch.Tensor, struct):
    """The LG kernel's records, built on the parameter rows' device without
    a host sync: (rec [N + 1, 4] int32 {out slot, parent start, bias,
    sigma}, bias and sigma as float bits, rec[N, 1] = P; par [N * pmax, 2]
    int32 {slot, weight bits}). The first P entries of ``par`` are each
    node's parents whose weight is not 0, in node order and row order; a
    padded slot has weight 0 and, with a parent of fitted weight exactly 0,
    is left out, as the plain version skips both products."""
    BUILDS["tables"] += 1
    pids, pmax, dmax = struct
    n = len(pids)
    smap, slots = _lg_slots(pids, ptab_flat.device)
    rows = ptab_flat.view(n, dmax + 2)
    w = rows[:, :pmax].contiguous()
    keep = (w != 0).view(-1)
    order = torch.sort((~keep).to(torch.int32), stable=True).indices
    par = torch.stack([slots, w.view(torch.int32).view(-1)], 1)[order]
    start = torch.zeros((n + 1,), dtype=torch.int64, device=ptab_flat.device)
    start[1:] = torch.cumsum(keep.view(n, pmax).sum(1), 0)
    rec = torch.zeros((n + 1, 4), dtype=torch.int32, device=ptab_flat.device)
    rec[:, 0] = smap
    rec[:, 1] = start
    rec[:n, 2:] = rows[:, dmax:].contiguous().view(torch.int32)
    return rec, par.contiguous()


@spanned("vbn.tables")
def lg_densities(ptab_flat: torch.Tensor, struct) -> torch.Tensor:
    """[N, 2] float32 {1 / sigma, log(sigma) + log(2 pi) / 2} of each
    node, in torch ops on the parameter rows' device: the LG kernels' log
    density of a weighted node is -zz^2 / 2 - the second with
    zz = (v - loc) * the first."""
    BUILDS["tables"] += 1
    _pids, _pmax, dmax = struct
    sigma = ptab_flat.view(-1, dmax + 2)[:, dmax + 1]
    return torch.stack([1.0 / sigma, torch.log(sigma) + _HALF_LOG_2PI],
                       1).contiguous()


def lg_resident_bytes(struct) -> int:
    """Bytes of the LG kernel's records: 16 a node and the end record, 8
    for each of the N * pmax parent entries."""
    n, pmax = len(struct[0]), struct[1]
    return 16 * (n + 1) + 8 * n * pmax
