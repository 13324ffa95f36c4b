"""Mask-dynamic scan sweeps: one kernel per network for every query shape.

Port of ``vectorizedbayesiannetwork_tpu/ops/sweep_scan_pallas.py``. The
query's structure (evidence/do flags, clamped values, target node) is data
per query row, so one launch serves any mix of queries on a network of up
to 1500 nodes. Two CUDA kernels (``csrc/sweep_scan.cu``):

- ``vbn_cat_scan`` replaces ``sweep_scan_pallas.py:210 _scan_kernel``;
- ``vbn_lg_scan`` replaces ``sweep_scan_pallas.py:978 _lg_scan_kernel``.

Each is bound by operations on an H100; the source note in
``csrc/sweep_scan.cu`` says how its design follows from that.

Beside each kernel sits a plain PyTorch version with the same signature,
external uniforms included (``categorical_sweep_scan_plain``,
``lg_sweep_scan_plain``). The wrappers (``categorical_sweep_scan``,
``lg_sweep_scan``) take the plain version only for tensors on the CPU; for
a CUDA tensor they launch the kernel or raise. ``LAUNCHES`` (shared with
``ops/sweep.py``) counts the launches under ``"categorical_scan"`` and
``"lg_scan"``.

Uniforms: ``u_ext`` is ``[B, N, S]`` (categorical) or ``[B, 2N, S]`` (LG),
the JAX layouts; without it both the kernels and the plain versions draw
Philox-4x32-10 with counter (particle, row, node, 0), the stream of
``ops/sweep.py``, so a static plan draws the same classes on both kernels.

Not ported, by design:

- ``_shard_scan_sweep`` / ``_shard_lg_scan``: mesh work, ROADMAP queue 1
  item 14;
- ``_run_chunked`` / ``_chunk_cap``: they split batches whose ``[N*B]``
  query prefetch would overflow the TPU's 1 MB of SMEM. A CUDA block reads
  its own row from global memory, so on one card ``fits`` is always true
  and no batch is split;
- ``_pick_tm`` and the ``VBN_SCAN_GATHER`` / ``VBN_SCAN_BRANCHLESS`` /
  ``VBN_SCAN_TM_CAP`` flags: TPU schedule probes. The behaviour held
  against is the default row walk.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from ..core.rng import philox_uniforms
from .sweep import (
    _HALF_LOG_2PI,
    LAUNCHES,
    _check,
    _combine_reduction,
    _outputs,
    _parse_want,
    _ppt,
    _ptr,
    _reduce_plain,
)

_MAX_C = 128  # classes per node (the pmf histogram's width in the JAX kernel)
_MAX_NODES = 1500
_EV_BIT = 1 << 16
_DO_BIT = 1 << 17
# A block's opt-in shared memory on an H100 (232,448 B); the launchers ask
# the device for its own limit, the gates use this one.
_SMEM_OPTIN = 232448
# The table joins the block's shared memory only while the block stays
# below this, so that two blocks still fit on an SM (228 KB each).
_TABLE_SMEM_CAP = 100 * 1024
_THREADS = (128, 64, 32)  # block sizes tried, largest first


# ---------------------------------------------------------------------------
# Gates
# ---------------------------------------------------------------------------


def _a16(n: int) -> int:
    return (n + 15) & ~15


def _cat_scan_smem(n, n_par, n_slots, threads, k, table_len) -> int:
    """Shared-memory bytes of ``vbn_cat_scan`` (``cat_scan_smem`` in
    ``csrc/sweep_scan.cu``): meta, the row's packed words, the uint8 value
    scratch, the reduction array (k = 0: none), the table (0: global)."""
    at = _a16(4 * (4 * n + 1 + 2 * n_par)) + _a16(4 * n) + _a16(n_slots * threads)
    if k:
        at += _a16(4 * (k + 1) * threads)
    return at + 4 * table_len


def _lg_scan_smem(n, pmax, n_slots, threads, red: bool) -> int:
    """Shared-memory bytes of ``vbn_lg_scan`` (``lg_scan_smem``)."""
    at = _a16(4 * n * (1 + pmax)) + 2 * _a16(4 * n) + _a16(4 * n * (pmax + 2))
    at += _a16(4 * n_slots * threads)
    return at + (_a16(16 * threads) if red else 0)


def _cat_layout(n, n_par, n_slots, k, table_len, limit=_SMEM_OPTIN):
    """(threads, table in shared memory) for ``vbn_cat_scan``, or None when
    not even 32 threads fit ``limit``."""
    for t in _THREADS:
        base = _cat_scan_smem(n, n_par, n_slots, t, k, 0)
        if base <= limit:
            return t, base + 4 * table_len <= min(limit, _TABLE_SMEM_CAP)
    return None


def _lg_threads(n, pmax, n_slots, red, limit=_SMEM_OPTIN):
    for t in _THREADS:
        if _lg_scan_smem(n, pmax, n_slots, t, red) <= limit:
            return t
    return None


def scan_sweep_reason(plan, cpds, n_samples: int):
    """None when the categorical scan kernel applies, else the first
    failing condition. The JAX gate's conditions, with its SMEM budget
    replaced by the card's shared memory: the table may stay in global
    memory, the value scratch and metadata may not."""
    from ..models.categorical_table import CategoricalTableCPD

    if plan.n_nodes > _MAX_NODES:
        return f"n_nodes {plan.n_nodes} > {_MAX_NODES}"
    if n_samples % 1024 != 0:
        return f"n_samples {n_samples} not a multiple of 1024"
    for i, cpd in enumerate(cpds):
        name = plan.topo_order[i]
        if not isinstance(cpd, CategoricalTableCPD):
            return f"node {name!r} is {type(cpd).__name__}, not categorical_table"
        if cpd.output_dim != 1:
            return f"node {name!r} has output_dim {cpd.output_dim} != 1"
        if cpd.n_classes <= 0:
            return f"node {name!r} lacks a declared class support"
        if cpd.input_dim > 0 and cpd.parent_n_classes is None:
            return f"node {name!r} lacks declared parent_n_classes"
        if cpd.input_dim > 0 and cpd.parent_cards is None:
            return f"node {name!r} is not fitted yet"
        c = cpd.resolved_classes
        if not 1 <= c <= _MAX_C:
            return f"node {name!r} has {c} classes > {_MAX_C}"
    struct = scan_struct_for(plan, cpds)
    _meta, n_par, n_slots = _cat_meta_host(struct)
    if _cat_layout(plan.n_nodes, n_par, n_slots, struct[7], 0) is None:
        need = _cat_scan_smem(plan.n_nodes, n_par, n_slots, 32, struct[7], 0)
        return (
            f"value scratch and metadata need {need} B of shared memory at "
            f"32 threads > {_SMEM_OPTIN} B"
        )
    return None


def lg_scan_reason(plan, cpds, n_samples: int):
    from ..models.linear_gaussian import LinearGaussianCPD

    if plan.n_nodes > _MAX_NODES:
        return f"n_nodes {plan.n_nodes} > {_MAX_NODES}"
    if n_samples % 1024 != 0:
        return f"n_samples {n_samples} not a multiple of 1024"
    for i, cpd in enumerate(cpds):
        name = plan.topo_order[i]
        if not isinstance(cpd, LinearGaussianCPD):
            return f"node {name!r} is {type(cpd).__name__}, not linear_gaussian"
        if cpd.output_dim != 1:
            return f"node {name!r} has output_dim {cpd.output_dim} != 1"
        if cpd.input_dim != len(plan.parent_idx[i]):
            return f"node {name!r} has multi-dim parents (w table misaligns)"
    pids, pmax, _dmax = lg_scan_struct_for(plan, cpds)
    n_slots = _compaction(pids)[2]
    if _lg_threads(plan.n_nodes, pmax, n_slots, True) is None:
        need = _lg_scan_smem(plan.n_nodes, pmax, n_slots, 32, True)
        return (
            f"value scratch and metadata need {need} B of shared memory at "
            f"32 threads > {_SMEM_OPTIN} B"
        )
    return None


# ---------------------------------------------------------------------------
# Host structure
# ---------------------------------------------------------------------------


def _scan_structure(plan, cpds):
    """Host-side metadata arrays (numpy): eoff, rows, cards, pids,
    strides, total entries, pmax."""
    n = plan.n_nodes
    pmax = max(max((len(p) for p in plan.parent_idx), default=0), 1)
    eoff = np.zeros((n,), np.int32)
    rows = np.zeros((n,), np.int32)
    cards = np.zeros((n,), np.int32)
    pids = np.zeros((n, pmax), np.int32)
    strides = np.zeros((n, pmax), np.int32)
    at = 0
    for i, cpd in enumerate(cpds):
        eoff[i] = at
        rows[i] = int(cpd._parent_states)
        cards[i] = int(cpd.resolved_classes)
        at += rows[i] * cards[i]
        p = plan.parent_idx[i]
        pids[i, : len(p)] = p
        strides[i, : len(p)] = [int(s) for s in cpd._strides]
    return eoff, rows, cards, pids, strides, int(at), int(pmax)


def scan_struct_for(plan, cpds):
    """Hashable structure for ``categorical_sweep_scan``: (eoff, rows,
    cards, pids, strides, total_entries, pmax, cmax)."""
    eoff, rows, cards, pids, strides, total_e, pmax = _scan_structure(plan, cpds)
    return (
        tuple(eoff.tolist()),
        tuple(rows.tolist()),
        tuple(cards.tolist()),
        tuple(map(tuple, pids.tolist())),
        tuple(map(tuple, strides.tolist())),
        total_e,
        pmax,
        int(max(cards.tolist())),
    )


@functools.lru_cache(maxsize=64)
def _compaction(pids):
    """Value-scratch compaction: only nodes that some node reads back get a
    slot (the padded parent id 0 counts, as in the JAX kernel), every other
    node writes one shared trash slot. Returns (smap [N] slot per node,
    pid_slots [N, pmax] parent ids as slots, n_slots)."""
    referenced = sorted({int(p) for row_p in pids for p in row_p})
    slot_of = {nid: k for k, nid in enumerate(referenced)}
    smap = np.full((len(pids),), len(referenced), np.int32)
    for nid, k in slot_of.items():
        smap[nid] = k
    pid_slots = np.asarray(
        [[slot_of.get(int(p), 0) for p in row_p] for row_p in pids], np.int32
    )
    return smap, pid_slots, len(referenced) + 1


def _flat_counts(cpds, params_tuple):
    """All nodes' count tables, row-major, concatenated flat [E + 8] (the
    JAX layout, whose trailing zero pad the CUDA kernel does not read)."""
    blocks = [p["counts"][0].reshape(-1) for p in params_tuple]
    blocks.append(torch.zeros((8,), dtype=torch.float32,
                              device=blocks[0].device))
    return torch.cat(blocks).float()


def lg_scan_struct_for(plan, cpds):
    """(pids [N][pmax] 0-padded, pmax, dmax); pmax == dmax."""
    pmax = max(max((len(p) for p in plan.parent_idx), default=0), 1)
    n = plan.n_nodes
    pids = np.zeros((n, pmax), np.int32)
    for i in range(n):
        pids[i, : len(plan.parent_idx[i])] = plan.parent_idx[i]
    return (tuple(map(tuple, pids.tolist())), pmax, pmax)


def lg_ptab_flat(cpds, params_tuple, dmax: int):
    """[N * (dmax + 2)] flat rows: w_0..w_{dmax-1}, bias, sigma, with
    sigma = sqrt(max(var, min_scale^2))."""
    rows = []
    for cpd, params in zip(cpds, params_tuple):
        w = params["weight"][:, 0]
        sigma = torch.sqrt(
            torch.clamp(params["var"][0], min=float(cpd.min_scale) ** 2)
        )
        rows.append(
            torch.cat(
                [
                    torch.nn.functional.pad(w, (0, dmax - w.shape[0])),
                    params["bias"],
                    sigma[None],
                ]
            )
        )
    return torch.cat(rows).float()


def _csr(struct):
    """Parent lists without padding: (pstart [N+1], pid [P], stride [P]).
    Real strides are >= 1; padded entries have stride 0."""
    _eoff, _rows, _cards, pids, strides = struct[:5]
    pstart, plist, pstride = [0], [], []
    for row_p, row_s in zip(pids, strides):
        for p, st in zip(row_p, row_s):
            if st:
                plist.append(int(p))
                pstride.append(int(st))
        pstart.append(len(plist))
    return pstart, plist, pstride


@functools.lru_cache(maxsize=64)
def _cat_meta_host(struct):
    """(meta list eoff|card|smap|pstart|pslot|pstride, n_par, n_slots)."""
    eoff, _rows, cards, pids = struct[:4]
    smap, _ps, n_slots = _compaction(pids)
    pstart, plist, pstride = _csr(struct)
    pslot = [int(smap[p]) for p in plist]
    meta = list(eoff) + list(cards) + smap.tolist() + pstart + pslot + pstride
    return meta, len(plist), n_slots


@functools.lru_cache(maxsize=64)
def _cat_meta(struct, device: torch.device) -> torch.Tensor:
    return torch.tensor(_cat_meta_host(struct)[0], dtype=torch.int32,
                        device=device)


@functools.lru_cache(maxsize=64)
def _lg_meta(pids, device: torch.device) -> torch.Tensor:
    """smap [N] | parent slot ids [N * pmax] (int32)."""
    smap, pid_slots, _n = _compaction(pids)
    return torch.tensor(
        smap.tolist() + pid_slots.reshape(-1).tolist(), dtype=torch.int32,
        device=device,
    )


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the kernels' twins; the CPU path)
# ---------------------------------------------------------------------------


def _node_uniforms(u_ext, seed, i, b, s, words, row0, device):
    """[B, words, S] uniforms of node i: the u_ext rows or the Philox
    stream (counter = particle, row0 + row, node, 0)."""
    if u_ext is not None:
        return u_ext[:, words * i : words * (i + 1)]
    return philox_uniforms(seed, b, 1, s, words, device, row0=row0, node0=i)


def categorical_sweep_scan_plain(
    seed: int,
    packed: torch.Tensor,  # [B, N] int32: value | ev << 16 | do << 17
    tgt_idx: torch.Tensor,  # [B] int32 per-row target node
    flat_counts: torch.Tensor,  # [E (+ pad)] float32
    struct,
    n_samples: int,
    u_ext: Optional[torch.Tensor] = None,  # [B, N, S] float32
    want=("logw",),
    row0: int = 0,
):
    """Same contract as ``categorical_sweep_scan``, in torch ops. ``row0``
    offsets the Philox row counter, so a slice of a batch's rows draws
    what those rows draw in the whole batch."""
    eoff, rows, cards, pids, _strides, _te, _pmax, cmax = struct
    b, n = packed.shape
    s = n_samples
    dev = packed.device
    want_logw, want_tgt, want_lpt, red_kind, red_src = _parse_want(want)
    need_logw = want_logw or red_src == "logw"
    need_lpt = want_lpt or red_src == "lpt"
    pk = packed.long()
    fixed = pk & 0xFFFF
    evm = (pk >> 16) & 1
    fxm = (pk >> 16) & 3
    tgt = tgt_idx.long()
    # host copies of the per-row masks decide which work a node needs
    fx_h, ev_h, tg_h = (fxm > 0).cpu(), (evm > 0).cpu(), tgt.cpu()
    pstart, plist, pstride = _csr(struct)
    referenced = set(plist)
    vals = {}
    logw = torch.zeros((b, s), dtype=torch.float32, device=dev)
    lpt = torch.zeros((b, s), dtype=torch.float32, device=dev)
    tval = torch.zeros((b, s), dtype=torch.int64, device=dev)
    for i in range(n):
        c = cards[i]
        tbl = flat_counts[eoff[i] : eoff[i] + rows[i] * c].view(rows[i], c)
        ps = range(pstart[i], pstart[i + 1])
        if len(ps):
            pidx = sum(vals[plist[q]] * pstride[q] for q in ps)
            rws = tbl[pidx]  # [B, S, c]
        else:
            rws = tbl[0].expand(b, s, c)
        total = rws[..., 0]
        for j in range(1, c):
            total = total + rws[..., j]
        fx_i = fx_h[:, i]
        clamped = torch.clamp(fixed[:, i : i + 1], max=c - 1).expand(b, s)
        if bool(fx_i.all()):
            val = clamped
        else:
            u = _node_uniforms(u_ext, seed, i, b, s, 1, row0, dev)[:, 0]
            thresh = u * total
            cum = rws[..., 0]
            walk = torch.zeros((b, s), dtype=torch.int64, device=dev)
            for j in range(1, c):
                walk = walk + (cum <= thresh).long()
                cum = cum + rws[..., j]
            val = torch.where(fx_i.to(dev)[:, None], clamped, walk)
        if i in referenced:
            vals[i] = val
        is_t = tg_h == i
        ev_w = need_logw and bool(ev_h[:, i].any())
        if ev_w or (need_lpt and bool(is_t.any())):
            cnt_sel = rws.gather(-1, val[..., None])[..., 0]
            prob = cnt_sel / torch.clamp(total, min=1e-12)
            lp = torch.log(torch.clamp(prob, min=1e-12))
            if ev_w:
                logw = logw + torch.where(evm[:, i : i + 1] > 0, lp, 0.0)
            if need_lpt:
                lpt = torch.where(is_t.to(dev)[:, None], lp, lpt)
        if bool(is_t.any()):
            tval = torch.where(is_t.to(dev)[:, None], val, tval)
    red = None
    if red_kind is not None:
        src = logw if red_src == "logw" else lpt
        red = _reduce_plain(red_kind, src, tval, cmax if red_kind == "pmf" else 3)
    return (
        logw if want_logw else None,
        tval.float() if want_tgt else None,
        lpt if want_lpt else None,
        red,
    )


def lg_sweep_scan_plain(
    seed: int,
    fixed_vals: torch.Tensor,  # [B, N] float32 clamped values
    flags: torch.Tensor,  # [B, N] int32: ev | do << 1
    tgt_idx: torch.Tensor,  # [B] int32
    ptab_flat: torch.Tensor,  # [N * (dmax + 2)] float32
    struct,
    n_samples: int,
    u_ext: Optional[torch.Tensor] = None,  # [B, 2N, S] float32
    want=("logw",),
    row0: int = 0,
):
    """Same contract as ``lg_sweep_scan``, in torch ops."""
    pids, pmax, dmax = struct
    b, n = fixed_vals.shape
    s = n_samples
    dev = fixed_vals.device
    want_logw, want_tgt, want_lpt, red_kind, red_src = _parse_want(want)
    if red_kind == "pmf":
        raise ValueError("pmf reduction undefined for continuous LG targets")
    need_logw = want_logw or red_src == "logw"
    need_lpt = want_lpt or red_src == "lpt"
    width = dmax + 2
    ptab = ptab_flat.view(n, width)
    w_h = ptab_flat.cpu().tolist()
    fl = flags.long()
    fx_h, ev_h, tg_h = (fl > 0).cpu(), (fl & 1 > 0).cpu(), tgt_idx.long().cpu()
    referenced = {int(p) for row_p in pids for p in row_p}
    two_pi = torch.tensor(2.0 * np.pi, dtype=torch.float32, device=dev)
    vals = {}
    logw = torch.zeros((b, s), dtype=torch.float32, device=dev)
    lpt = torch.zeros((b, s), dtype=torch.float32, device=dev)
    tval = torch.zeros((b, s), dtype=torch.float32, device=dev)
    for i in range(n):
        loc = ptab[i, dmax].expand(b, s)
        for k in range(pmax):
            # a padded slot has weight 0: gated, as in the kernels
            if w_h[i * width + k] != 0.0:
                loc = loc + vals[pids[i][k]] * ptab[i, k]
        sigma = ptab[i, dmax + 1]
        fx_i = fx_h[:, i]
        fixed_i = fixed_vals[:, i : i + 1].expand(b, s)
        if bool(fx_i.all()):
            val = fixed_i
        else:
            u = _node_uniforms(u_ext, seed, i, b, s, 2, row0, dev)
            z = torch.sqrt(-2.0 * torch.log(u[:, 0])) * torch.cos(two_pi * u[:, 1])
            val = torch.where(fx_i.to(dev)[:, None], fixed_i, loc + sigma * z)
        if i in referenced:
            vals[i] = val
        is_t = tg_h == i
        ev_w = need_logw and bool(ev_h[:, i].any())
        if ev_w or (need_lpt and bool(is_t.any())):
            zz = (val - loc) / sigma
            lp = -0.5 * zz * zz - torch.log(sigma) - _HALF_LOG_2PI
            if ev_w:
                logw = logw + torch.where(ev_h[:, i].to(dev)[:, None], lp, 0.0)
            if need_lpt:
                lpt = torch.where(is_t.to(dev)[:, None], lp, lpt)
        if bool(is_t.any()):
            tval = torch.where(is_t.to(dev)[:, None], val, tval)
    red = None
    if red_kind is not None:
        src = logw if red_src == "logw" else lpt
        red = _reduce_plain(red_kind, src, tval, 3)
    return (
        logw if want_logw else None,
        tval if want_tgt else None,
        lpt if want_lpt else None,
        red,
    )


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/sweep_scan.cu), launched through ctypes
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("sweep_scan")
    lib.vbn_smem_optin.argtypes = [_I]
    lib.vbn_smem_optin.restype = _I
    lib.vbn_cat_scan_smem_bytes.argtypes = [_I] * 6
    lib.vbn_cat_scan_smem_bytes.restype = ctypes.c_size_t
    lib.vbn_lg_scan_smem_bytes.argtypes = [_I] * 5
    lib.vbn_lg_scan_smem_bytes.restype = ctypes.c_size_t
    lib.vbn_cat_scan.argtypes = (
        [_P, _I, _I, _I, _P, _I, _I, _P, _P, _P, ctypes.c_uint64]
        + [_I] * 12 + [_P] * 5
    )
    lib.vbn_cat_scan.restype = _I
    lib.vbn_lg_scan.argtypes = (
        [_P, _I, _I, _I, _P, _P, _P, _P, _P, ctypes.c_uint64]
        + [_I] * 11 + [_P] * 5
    )
    lib.vbn_lg_scan.restype = _I
    return lib


@functools.lru_cache(maxsize=8)
def _smem_limit(device_index: int) -> int:
    v = _lib().vbn_smem_optin(device_index)
    if v <= 0:
        raise RuntimeError("cannot read the device's shared-memory limit")
    return v


def _launch_cat_scan(seed, packed, tgt_idx, flat_counts, struct, s, u_ext,
                     want):
    n, b = len(struct[0]), packed.shape[0]
    total_e, cmax = struct[5], struct[7]
    _check(packed, "packed", torch.int32, (b, n))
    _check(tgt_idx, "tgt_idx", torch.int32, (b,))
    if flat_counts.dim() != 1 or flat_counts.shape[0] < total_e:
        raise ValueError(f"flat_counts must be 1-D with >= {total_e} entries")
    _check(flat_counts, "flat_counts", torch.float32, tuple(flat_counts.shape))
    if u_ext is not None:
        _check(u_ext, "u_ext", torch.float32, (b, n, s))
    if s % 1024 != 0:
        raise ValueError(f"n_samples {s} not a multiple of 1024")
    want_logw, want_tgt, want_lpt, red_kind, red_src = _parse_want(want)
    k = {"pmf": cmax, "mom": 3}.get(red_kind, 0)
    _meta, n_par, n_slots = _cat_meta_host(struct)
    dev = packed.device
    layout = _cat_layout(n, n_par, n_slots, k, total_e,
                         limit=_smem_limit(dev.index or 0))
    if layout is None:
        raise ValueError("vbn_cat_scan: the plan does not fit shared memory")
    threads, tbl_in_smem = layout
    ppt = _ppt(s, threads)
    nblk = s // (threads * ppt)
    outs = _outputs(b, s, nblk, k, want, dev)
    meta = _cat_meta(struct, dev)
    with torch.cuda.device(dev):
        rc = _lib().vbn_cat_scan(
            meta.data_ptr(), n, n_par, n_slots,
            flat_counts.data_ptr(), total_e, int(tbl_in_smem),
            packed.data_ptr(), tgt_idx.data_ptr(), _ptr(u_ext),
            seed & ((1 << 64) - 1), b, s, threads, ppt,
            int(want_logw or red_src == "logw"),
            int(want_lpt or red_src == "lpt"),
            int(want_logw), int(want_tgt), int(want_lpt),
            {"pmf": 1, "mom": 2}.get(red_kind, 0), int(red_src == "lpt"), k,
            *[_ptr(o) for o in outs],
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"vbn_cat_scan launch failed: CUDA error {rc}")
    LAUNCHES["categorical_scan"] += 1
    logw, tgt, lpt, part = outs
    red = _combine_reduction(part, k) if part is not None else None
    return logw, tgt, lpt, red


def _launch_lg_scan(seed, fixed_vals, flags, tgt_idx, ptab_flat, struct, s,
                    u_ext, want):
    pids, pmax, dmax = struct
    n, b = len(pids), fixed_vals.shape[0]
    _check(fixed_vals, "fixed_vals", torch.float32, (b, n))
    _check(flags, "flags", torch.int32, (b, n))
    _check(tgt_idx, "tgt_idx", torch.int32, (b,))
    _check(ptab_flat, "ptab_flat", torch.float32, (n * (dmax + 2),))
    if u_ext is not None:
        _check(u_ext, "u_ext", torch.float32, (b, 2 * n, s))
    if s % 1024 != 0:
        raise ValueError(f"n_samples {s} not a multiple of 1024")
    if pmax != dmax:
        raise ValueError(f"struct pmax {pmax} != dmax {dmax}")
    want_logw, want_tgt, want_lpt, red_kind, red_src = _parse_want(want)
    if red_kind == "pmf":
        raise ValueError("pmf reduction undefined for continuous LG targets")
    n_slots = _compaction(pids)[2]
    dev = fixed_vals.device
    threads = _lg_threads(n, pmax, n_slots, red_kind is not None,
                          limit=_smem_limit(dev.index or 0))
    if threads is None:
        raise ValueError("vbn_lg_scan: the plan does not fit shared memory")
    ppt = _ppt(s, threads)
    nblk = s // (threads * ppt)
    outs = _outputs(b, s, nblk, 3, want, dev)
    meta = _lg_meta(pids, dev)
    with torch.cuda.device(dev):
        rc = _lib().vbn_lg_scan(
            meta.data_ptr(), n, pmax, n_slots, ptab_flat.data_ptr(),
            fixed_vals.data_ptr(), flags.data_ptr(), tgt_idx.data_ptr(),
            _ptr(u_ext), seed & ((1 << 64) - 1), b, s, threads, ppt,
            int(want_logw or red_src == "logw"),
            int(want_lpt or red_src == "lpt"),
            int(want_logw), int(want_tgt), int(want_lpt),
            2 if red_kind == "mom" else 0, int(red_src == "lpt"),
            *[_ptr(o) for o in outs],
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"vbn_lg_scan launch failed: CUDA error {rc}")
    LAUNCHES["lg_scan"] += 1
    logw, tgt, lpt, part = outs
    red = _combine_reduction(part, 3) if part is not None else None
    return logw, tgt, lpt, red


def categorical_sweep_scan(
    seed: int,
    packed: torch.Tensor,  # [B, N] int32: value | ev << 16 | do << 17
    tgt_idx: torch.Tensor,  # [B] int32
    flat_counts: torch.Tensor,  # [E (+ pad)] float32
    struct,  # scan_struct_for(plan, cpds)
    n_samples: int,
    u_ext: Optional[torch.Tensor] = None,  # [B, N, S] float32
    want=("logw",),
):
    """Returns ``(log_w, target_vals, lp_tgt, red)`` per the ``want``
    contract of ``ops/sweep.py``; ``red`` is ``(sums [B, K], m [B])`` with
    K = the network's largest class count (pmf) or 3 (moments).

    CUDA tensors launch ``vbn_cat_scan``; CPU tensors run the plain
    version."""
    if packed.is_cuda:
        return _launch_cat_scan(seed, packed, tgt_idx, flat_counts, struct,
                                n_samples, u_ext, want)
    return categorical_sweep_scan_plain(
        seed, packed, tgt_idx, flat_counts, struct, n_samples, u_ext=u_ext,
        want=want,
    )


def lg_sweep_scan(
    seed: int,
    fixed_vals: torch.Tensor,  # [B, N] float32
    flags: torch.Tensor,  # [B, N] int32: ev | do << 1
    tgt_idx: torch.Tensor,  # [B] int32
    ptab_flat: torch.Tensor,  # [N * (dmax + 2)] float32
    struct,  # lg_scan_struct_for(plan, cpds)
    n_samples: int,
    u_ext: Optional[torch.Tensor] = None,  # [B, 2N, S] float32
    want=("logw",),
):
    """Returns ``(log_w, target_vals, lp_tgt, red)``; ``red`` is the
    weighted-moments summary (sum_w, sum_wx, sum_wx2) and its shift.

    CUDA tensors launch ``vbn_lg_scan``; CPU tensors run the plain
    version."""
    if fixed_vals.is_cuda:
        return _launch_lg_scan(seed, fixed_vals, flags, tgt_idx, ptab_flat,
                               struct, n_samples, u_ext, want)
    return lg_sweep_scan_plain(
        seed, fixed_vals, flags, tgt_idx, ptab_flat, struct, n_samples,
        u_ext=u_ext, want=want,
    )


# ---------------------------------------------------------------------------
# Program-level raw functions for the mask-dynamic and large static paths
# ---------------------------------------------------------------------------


def _always_fits(_b: int) -> bool:
    return True


def pack_rows(fixed_vals, ev_mask, do_mask, cards) -> torch.Tensor:
    """[B, N] int32 packed words for ``categorical_sweep_scan``: each
    clamped value rounded and clipped to its node's classes, then
    | ev << 16 | do << 17."""
    top = torch.tensor([float(c) - 1.0 for c in cards], device=fixed_vals.device)
    fixed_i = torch.clamp(torch.round(torch.nan_to_num(fixed_vals)), min=0.0)
    fixed_i = torch.minimum(fixed_i, top).to(torch.int32)
    return (
        fixed_i
        | torch.where(ev_mask > 0, _EV_BIT, 0).to(torch.int32)
        | torch.where(do_mask > 0, _DO_BIT, 0).to(torch.int32)
    ).contiguous()


def lg_rows(fixed_vals, ev_mask, do_mask):
    """(fixed [B, N] float32, flags [B, N] int32 ev | do << 1) for
    ``lg_sweep_scan``."""
    fixed = torch.nan_to_num(fixed_vals.float()).contiguous()
    flags = (
        torch.where(ev_mask > 0, 1, 0) | torch.where(do_mask > 0, 2, 0)
    ).to(torch.int32).contiguous()
    return fixed, flags


def make_scan_sweep_fn(plan, cpds, n_samples: int, want=("logw",)):
    """Return ``raw(params_tuple, seed, fixed [B, N] f32, ev [B, N],
    do [B, N], tgt [B]) -> (logw, tgt, lpt, red)`` on the family-matched
    scan kernel, or None when neither gate admits the plan. ``raw.fits(b)``
    is always true on one card (see the module note)."""
    if scan_sweep_reason(plan, cpds, n_samples) is not None:
        return _make_lg_scan_fn(plan, cpds, n_samples, want)
    struct = scan_struct_for(plan, cpds)

    def raw(params_tuple, seed, fixed_vals, ev_mask, do_mask, tgt_idx):
        return categorical_sweep_scan(
            seed, pack_rows(fixed_vals, ev_mask, do_mask, struct[2]),
            tgt_idx.to(torch.int32).contiguous(),
            _flat_counts(cpds, params_tuple), struct, n_samples, want=want,
        )

    raw.fits = _always_fits
    return raw


def _make_lg_scan_fn(plan, cpds, n_samples, want):
    if lg_scan_reason(plan, cpds, n_samples) is not None:
        return None
    if any(w.startswith("pmf_") for w in want):
        # a class histogram over a continuous LG target is a binning
        # question, not a kernel reduction (the JAX refusal, :1284-1288)
        return None
    struct = lg_scan_struct_for(plan, cpds)

    def raw(params_tuple, seed, fixed_vals, ev_mask, do_mask, tgt_idx):
        fixed, flags = lg_rows(fixed_vals, ev_mask, do_mask)
        return lg_sweep_scan(
            seed, fixed, flags, tgt_idx.to(torch.int32).contiguous(),
            lg_ptab_flat(cpds, params_tuple, struct[2]), struct, n_samples,
            want=want,
        )

    raw.fits = _always_fits
    return raw
