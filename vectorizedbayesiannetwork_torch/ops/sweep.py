"""Fused ancestral sweeps with in-kernel posterior reductions.

Port of ``vectorizedbayesiannetwork_tpu/ops/sweep_pallas.py``. Two CUDA
kernels (``csrc/sweep.cu``) run a whole topological sweep per particle and,
in reduction mode, fold the particles into per-block partials, so only
``[B, nblk, K + 1]`` floats leave the kernel instead of ``[B, S]`` streams:

- ``vbn_cat_sweep`` replaces ``sweep_pallas.py:207 _sweep_kernel``;
- ``vbn_lg_sweep`` replaces ``sweep_pallas.py:514 _lg_sweep_kernel``.

Each is bound by operations on an H100 (a Philox call and a short walk per
particle and node; the bytes moved are kilobytes in and megabytes out); the
source note in ``csrc/sweep.cu`` says how its design follows from that.

Beside each kernel sits a plain PyTorch version with the same signature,
external uniforms included (``categorical_sweep_plain``,
``lg_sweep_plain``). The wrappers (``categorical_sweep_fused``,
``lg_sweep_fused``) take the plain version only for tensors on the CPU; for
a CUDA tensor they launch the kernel or raise. ``LAUNCHES`` counts the
kernel launches of each wrapper.

Uniforms: ``u_ext`` is ``[B, N, S]`` (categorical) or ``[B, 2N, S]`` (LG,
rows 2i and 2i+1 the Box-Muller pair), the JAX layout. Without it both the
kernels and the plain versions draw Philox-4x32-10 from ``seed``
(``core.rng.philox_uniforms``), so the in-kernel random mode is comparable
bit for bit too.

Reductions return ``(sums [B, K], m [B])``: ``sums`` are the class
histogram (K = the target's classes) or the moments (sum w, sum w x,
sum w x^2; K = 3) of ``w = exp(src - m)``, where ``m`` is the row's max of
``src`` (logw or lpt). The JAX kernels pad ``sums`` to 128 lanes; the port
returns the K lanes that carry data.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from ..core.rng import philox_uniforms

_MAX_C = 32  # classes per node
_MAX_ROWS_X_C = 2048  # CPT rows x classes per node
_MAX_NODES = 80
_THREADS = 128  # threads per block (VBN_THREADS in csrc/sweep.cu)
_SMEM_LIMIT = 200 * 1024  # keep the CPT in shared memory below this
_HALF_LOG_2PI = 0.9189385332046727

# Kernel launches by wrapper; the scan kernels (ops/sweep_scan.py) count here
# too, so one reset covers every kernel of a served batch.
LAUNCHES = {"categorical": 0, "lg": 0, "categorical_scan": 0, "lg_scan": 0}


# ---------------------------------------------------------------------------
# want-flag parsing: which outputs a program needs.
#   "logw"     [B, S] evidence log-weights
#   "tgt"      [B, S] target values (implicit unless a reduction is asked)
#   "lpt"      [B, S] target log-density
#   "pmf_logw" [B, C] weighted class histogram, weights = exp(logw)  (LW)
#   "pmf_lpt"  [B, C] weighted class histogram, weights = exp(lpt)   (MCM)
#   "mom_logw" [B, 3] weighted (sum_w, sum_wx, sum_wx2), w = exp(logw)
#   "mom_lpt"  same with w = exp(lpt)
# ---------------------------------------------------------------------------


def _parse_want(want):
    red = next((w for w in want if w.startswith(("pmf_", "mom_"))), None)
    red_kind = red.split("_")[0] if red else None  # "pmf" | "mom" | None
    red_src = red.split("_")[1] if red else None  # "logw" | "lpt" | None
    want_logw = "logw" in want
    want_lpt = "lpt" in want
    want_tgt = ("tgt" in want) or (red is None)
    return want_logw, want_tgt, want_lpt, red_kind, red_src


def categorical_sweep_reason(plan, cpds, n_samples: int):
    """None when the fused kernel applies, else the first failing condition."""
    from ..models.categorical_table import CategoricalTableCPD

    if plan.n_nodes > _MAX_NODES:
        return f"n_nodes {plan.n_nodes} > {_MAX_NODES}"
    if n_samples % 1024 != 0:
        return f"n_samples {n_samples} not a multiple of 1024"
    for i, cpd in enumerate(cpds):
        name = plan.topo_order[i]
        if not isinstance(cpd, CategoricalTableCPD):
            return f"node {name!r} is {type(cpd).__name__}, not categorical_table"
        if cpd.output_dim != 1 or cpd.n_classes <= 0:
            return f"node {name!r} has output_dim {cpd.output_dim} != 1"
        if cpd.input_dim > 0 and cpd.parent_n_classes is None:
            return f"node {name!r} lacks declared parent_n_classes"
        if cpd.input_dim > 0 and cpd.parent_cards is None:
            return f"node {name!r} is not fitted yet"
        c = cpd.resolved_classes
        if not 1 <= c <= _MAX_C:
            return f"node {name!r} has {c} classes > {_MAX_C}"
        if cpd._parent_states * c > _MAX_ROWS_X_C:
            return (
                f"node {name!r} CPT {cpd._parent_states}x{c} rows*classes "
                f"> {_MAX_ROWS_X_C}"
            )
    return None


def plan_tuple_for(plan, cpds):
    """((n_nodes, parent_idx, ev_mask, do_mask, target_idx, offs, pstates,
    cards, strides), total_rows, cmax): the hashable plan structure."""
    offs, at = [], 0
    for cpd in cpds:
        offs.append(at)
        at += cpd._parent_states
    cards = tuple(int(c.resolved_classes) for c in cpds)
    return (
        (
            plan.n_nodes,
            tuple(tuple(p) for p in plan.parent_idx),
            tuple(bool(m) for m in plan.evidence_mask),
            tuple(bool(m) for m in plan.do_mask),
            plan.target_idx,
            tuple(offs),
            tuple(int(c._parent_states) for c in cpds),
            cards,
            tuple(tuple(int(s) for s in c._strides) for c in cpds),
        ),
        at,
        max(cards),
    )


def _stacked_counts(cpds, params_tuple, total_rows: int, cmax: int):
    """[total_rows, cmax] float32: every node's count rows, zero-padded."""
    blocks = []
    for params in params_tuple:
        cnt = params["counts"][0]  # [P, C]
        blocks.append(
            torch.nn.functional.pad(cnt, (0, cmax - cnt.shape[1]))
        )
    return torch.cat(blocks, dim=0).contiguous()


def lg_sweep_reason(plan, cpds, n_samples: int):
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
    return None


def lg_plan_tuple_for(plan, cpds):
    dmax = max((len(p) for p in plan.parent_idx), default=0)
    return (
        (
            plan.n_nodes,
            tuple(tuple(p) for p in plan.parent_idx),
            tuple(bool(m) for m in plan.evidence_mask),
            tuple(bool(m) for m in plan.do_mask),
            plan.target_idx,
        ),
        max(dmax, 1),
    )


def lg_param_table(cpds, params_tuple, dmax: int, min_scales):
    """[N, dmax + 2] rows: [w_0..w_{din-1}, 0pad, bias, sigma]."""
    rows = []
    for params, ms in zip(params_tuple, min_scales):
        w = params["weight"][:, 0]
        sigma = torch.sqrt(torch.clamp(params["var"][0], min=ms**2))
        rows.append(
            torch.cat(
                [
                    torch.nn.functional.pad(w, (0, dmax - w.shape[0])),
                    params["bias"],
                    sigma[None],
                ]
            )
        )
    return torch.stack(rows).contiguous()


# ---------------------------------------------------------------------------
# Reductions
# ---------------------------------------------------------------------------


def _reduce_plain(red_kind, src, tgt, k: int):
    """Row reduction over all S particles, accumulated in float64."""
    m = src.max(dim=1).values
    e = torch.exp(src.double() - m.double()[:, None])
    if red_kind == "pmf":
        sums = torch.zeros(
            (src.shape[0], k), dtype=torch.float64, device=src.device
        ).scatter_add_(1, tgt.long(), e)
    else:
        x = tgt.double()
        sums = torch.stack([e.sum(1), (e * x).sum(1), (e * x * x).sum(1)], 1)
    return sums.float(), m


def _combine_reduction(partials: torch.Tensor, k: int):
    """[B, nblk, K + 1] block partials -> (sums [B, K], m [B])."""
    mt = partials[..., k]
    m = mt.max(dim=1).values
    sums = (torch.exp(mt - m[:, None])[..., None] * partials[..., :k]).sum(1)
    return sums, m


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the kernels' twins; the CPU path)
# ---------------------------------------------------------------------------


def categorical_sweep_plain(
    seed: int,
    fixed_idx: torch.Tensor,  # [B, N] int32 evidence/do class values
    stacked_counts: torch.Tensor,  # [total_rows, Cmax] float32
    plan_tuple,
    n_samples: int,
    u_ext: Optional[torch.Tensor] = None,  # [B, N, S] float32
    want=("logw", "lpt"),
):
    """Same contract as ``categorical_sweep_fused``, in torch ops."""
    (n_nodes, parent_idx, ev_mask, do_mask, target_idx, offs, pstates,
     cards, strides) = plan_tuple
    b, s = fixed_idx.shape[0], n_samples
    dev = fixed_idx.device
    if u_ext is None:
        u_ext = philox_uniforms(seed, b, n_nodes, s, 1, dev)
    want_logw, want_tgt, want_lpt, red_kind, red_src = _parse_want(want)
    need_logw = want_logw or red_src == "logw"
    need_lpt = want_lpt or red_src == "lpt"
    vals = [None] * n_nodes
    logw = torch.zeros((b, s), dtype=torch.float32, device=dev)
    lpt = torch.zeros((b, s), dtype=torch.float32, device=dev)
    for i in range(n_nodes):
        c = cards[i]
        tbl = stacked_counts[offs[i] : offs[i] + pstates[i], :c]
        if parent_idx[i]:
            pidx = sum(
                vals[p] * strides[i][k] for k, p in enumerate(parent_idx[i])
            )
            rows = tbl[pidx]  # [B, S, c]
        else:
            rows = tbl[0].expand(b, s, c)
        total = rows[..., 0]
        for j in range(1, c):
            total = total + rows[..., j]
        if ev_mask[i] or do_mask[i]:
            val = fixed_idx[:, i : i + 1].long().expand(b, s)
        else:
            thresh = u_ext[:, i] * total
            cum = rows[..., 0]
            val = torch.zeros((b, s), dtype=torch.int64, device=dev)
            for j in range(1, c):
                val = val + (cum <= thresh).long()
                cum = cum + rows[..., j]
        vals[i] = val
        if (ev_mask[i] and need_logw) or (i == target_idx and need_lpt):
            cnt_sel = rows.gather(-1, val[..., None])[..., 0]
            prob = cnt_sel / torch.clamp(total, min=1e-12)
            lp = torch.log(torch.clamp(prob, min=1e-12))
            if ev_mask[i] and need_logw:
                logw = logw + lp
            if i == target_idx and need_lpt:
                lpt = lp
    tgt = vals[target_idx]
    red = None
    if red_kind is not None:
        src = logw if red_src == "logw" else lpt
        k = cards[target_idx] if red_kind == "pmf" else 3
        red = _reduce_plain(red_kind, src, tgt, k)
    return (
        logw if want_logw else None,
        tgt.float() if want_tgt else None,
        lpt if want_lpt else None,
        red,
    )


def lg_sweep_plain(
    seed: int,
    fixed_vals: torch.Tensor,  # [B, N] float32 evidence/do values
    param_table: torch.Tensor,  # [N, dmax + 2]
    plan_tuple,
    dmax: int,
    n_samples: int,
    u_ext: Optional[torch.Tensor] = None,  # [B, 2N, S] float32
    want=("logw", "lpt"),
):
    """Same contract as ``lg_sweep_fused``, in torch ops."""
    n_nodes, parent_idx, ev_mask, do_mask, target_idx = plan_tuple
    b, s = fixed_vals.shape[0], n_samples
    dev = fixed_vals.device
    if u_ext is None:
        u_ext = philox_uniforms(seed, b, n_nodes, s, 2, dev)
    want_logw, want_tgt, want_lpt, red_kind, red_src = _parse_want(want)
    need_logw = want_logw or red_src == "logw"
    need_lpt = want_lpt or red_src == "lpt"
    two_pi = torch.tensor(2.0 * np.pi, dtype=torch.float32, device=dev)
    vals = [None] * n_nodes
    logw = torch.zeros((b, s), dtype=torch.float32, device=dev)
    lpt = torch.zeros((b, s), dtype=torch.float32, device=dev)
    for i in range(n_nodes):
        loc = param_table[i, dmax].expand(b, s)
        for k, p in enumerate(parent_idx[i]):
            loc = loc + vals[p] * param_table[i, k]
        sigma = param_table[i, dmax + 1]
        if ev_mask[i] or do_mask[i]:
            val = fixed_vals[:, i : i + 1].expand(b, s)
        else:
            u1, u2 = u_ext[:, 2 * i], u_ext[:, 2 * i + 1]
            z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(two_pi * u2)
            val = loc + sigma * z
        vals[i] = val
        if (ev_mask[i] and need_logw) or (i == target_idx and need_lpt):
            zz = (val - loc) / sigma
            lp = -0.5 * zz * zz - torch.log(sigma) - _HALF_LOG_2PI
            if ev_mask[i] and need_logw:
                logw = logw + lp
            if i == target_idx and need_lpt:
                lpt = lp
    tgt = vals[target_idx]
    red = None
    if red_kind is not None:
        src = logw if red_src == "logw" else lpt
        red = _reduce_plain(red_kind, src, tgt, 3)
    return (
        logw if want_logw else None,
        tgt.contiguous() if want_tgt else None,
        lpt if want_lpt else None,
        red,
    )


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/sweep.cu), launched through ctypes
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("sweep")
    lib.vbn_cat_smem_bytes.argtypes = [_I, _I, _I, _I]
    lib.vbn_cat_smem_bytes.restype = ctypes.c_size_t
    lib.vbn_cat_sweep.argtypes = (
        [_P, _I, _I, _I, _P, _I, _I, _I, _P, _P, ctypes.c_uint64]
        + [_I] * 11 + [_P] * 5
    )
    lib.vbn_cat_sweep.restype = _I
    lib.vbn_lg_sweep.argtypes = (
        [_P, _I, _I, _I, _P, _I, _P, _P, ctypes.c_uint64]
        + [_I] * 10 + [_P] * 5
    )
    lib.vbn_lg_sweep.restype = _I
    return lib


def _ppt(n_samples: int, threads: int = _THREADS) -> int:
    """Particles per thread: a block spans threads * ppt particles."""
    return 16 if n_samples % (threads * 16) == 0 else 8


@functools.lru_cache(maxsize=64)
def _cat_meta(plan_struct, device: torch.device) -> torch.Tensor:
    """off[N] card[N] flags[N] pstart[N+1] plist[P] pstride[P] (int32)."""
    (n, parent_idx, ev_mask, do_mask, _t, offs, _ps, cards,
     strides) = plan_struct
    flags = [int(e) | (int(d) << 1) for e, d in zip(ev_mask, do_mask)]
    pstart = np.cumsum([0] + [len(p) for p in parent_idx]).tolist()
    plist = [p for ps in parent_idx for p in ps]
    pstride = [s for ss in strides for s in ss]
    meta = list(offs) + list(cards) + flags + pstart + plist + pstride
    return torch.tensor(meta, dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=64)
def _lg_meta(plan_struct, device: torch.device) -> torch.Tensor:
    """flags[N] pstart[N+1] plist[P] (int32)."""
    n, parent_idx, ev_mask, do_mask, _t = plan_struct
    flags = [int(e) | (int(d) << 1) for e, d in zip(ev_mask, do_mask)]
    pstart = np.cumsum([0] + [len(p) for p in parent_idx]).tolist()
    plist = [p for ps in parent_idx for p in ps]
    return torch.tensor(flags + pstart + plist, dtype=torch.int32,
                        device=device)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(t, name, dtype, shape):
    if not t.is_cuda or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected a CUDA {dtype} tensor of shape {tuple(shape)}, "
            f"got {t.device} {t.dtype} {tuple(t.shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _outputs(b, s, nblk, k, want, device):
    want_logw, want_tgt, want_lpt, red_kind, red_src = _parse_want(want)
    f32 = dict(dtype=torch.float32, device=device)
    return (
        torch.empty((b, s), **f32) if want_logw else None,
        torch.empty((b, s), **f32) if want_tgt else None,
        torch.empty((b, s), **f32) if want_lpt else None,
        torch.empty((b, nblk, k + 1), **f32) if red_kind else None,
    )


def _launch_categorical(seed, fixed_idx, counts, plan_struct, s, u_ext, want):
    n = plan_struct[0]
    b = fixed_idx.shape[0]
    target, pstates, cards = plan_struct[4], plan_struct[6], plan_struct[7]
    total_rows, cmax = sum(pstates), counts.shape[1]
    _check(fixed_idx, "fixed_idx", torch.int32, (b, n))
    if cmax < max(cards):
        raise ValueError(f"stacked_counts has {cmax} < {max(cards)} columns")
    _check(counts, "stacked_counts", torch.float32, (total_rows, cmax))
    if u_ext is not None:
        _check(u_ext, "u_ext", torch.float32, (b, n, s))
    if s % 1024 != 0:
        raise ValueError(f"n_samples {s} not a multiple of 1024")
    want_logw, want_tgt, want_lpt, red_kind, red_src = _parse_want(want)
    ppt = _ppt(s)
    nblk = s // (_THREADS * ppt)
    k = cards[target] if red_kind == "pmf" else 3
    outs = _outputs(b, s, nblk, k, want, fixed_idx.device)
    meta = _cat_meta(plan_struct, fixed_idx.device)
    n_par = sum(len(p) for p in plan_struct[1])
    lib = _lib()
    table_len = total_rows * cmax
    smem = lib.vbn_cat_smem_bytes(n, n_par, k if red_kind else 0, table_len)
    with torch.cuda.device(fixed_idx.device):
        rc = lib.vbn_cat_sweep(
            meta.data_ptr(), n, n_par, target,
            counts.data_ptr(), table_len, cmax, int(smem <= _SMEM_LIMIT),
            fixed_idx.data_ptr(), _ptr(u_ext), seed & ((1 << 64) - 1),
            b, s, ppt,
            int(want_logw or red_src == "logw"),
            int(want_lpt or red_src == "lpt"),
            int(want_logw), int(want_tgt), int(want_lpt),
            {"pmf": 1, "mom": 2}.get(red_kind, 0), int(red_src == "lpt"), k,
            *[_ptr(o) for o in outs],
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"vbn_cat_sweep launch failed: CUDA error {rc}")
    LAUNCHES["categorical"] += 1
    logw, tgt, lpt, part = outs
    red = _combine_reduction(part, k) if part is not None else None
    return logw, tgt, lpt, red


def _launch_lg(seed, fixed_vals, ptab, plan_tuple, dmax, s, u_ext, want):
    n = plan_tuple[0]
    b = fixed_vals.shape[0]
    _check(fixed_vals, "fixed_vals", torch.float32, (b, n))
    _check(ptab, "param_table", torch.float32, (n, dmax + 2))
    if u_ext is not None:
        _check(u_ext, "u_ext", torch.float32, (b, 2 * n, s))
    if s % 1024 != 0:
        raise ValueError(f"n_samples {s} not a multiple of 1024")
    want_logw, want_tgt, want_lpt, red_kind, red_src = _parse_want(want)
    if red_kind == "pmf":
        raise ValueError("pmf reduction undefined for continuous LG targets")
    ppt = _ppt(s)
    nblk = s // (_THREADS * ppt)
    outs = _outputs(b, s, nblk, 3, want, fixed_vals.device)
    meta = _lg_meta(plan_tuple, fixed_vals.device)
    n_par = sum(len(p) for p in plan_tuple[1])
    lib = _lib()
    with torch.cuda.device(fixed_vals.device):
        rc = lib.vbn_lg_sweep(
            meta.data_ptr(), n, n_par, plan_tuple[4],
            ptab.data_ptr(), dmax,
            fixed_vals.data_ptr(), _ptr(u_ext), seed & ((1 << 64) - 1),
            b, s, ppt,
            int(want_logw or red_src == "logw"),
            int(want_lpt or red_src == "lpt"),
            int(want_logw), int(want_tgt), int(want_lpt),
            2 if red_kind == "mom" else 0, int(red_src == "lpt"),
            *[_ptr(o) for o in outs],
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"vbn_lg_sweep launch failed: CUDA error {rc}")
    LAUNCHES["lg"] += 1
    logw, tgt, lpt, part = outs
    red = _combine_reduction(part, 3) if part is not None else None
    return logw, tgt, lpt, red


def categorical_sweep_fused(
    seed: int,
    fixed_idx: torch.Tensor,  # [B, N] int32 evidence/do class values
    stacked_counts: torch.Tensor,  # [total_rows, Cmax]
    plan_tuple,  # the plan structure, plan_tuple_for(...)[0]
    n_samples: int,
    u_ext: Optional[torch.Tensor] = None,  # [B, N, S] float32
    want=("logw", "lpt"),
):
    """Returns ``(log_w, target_vals, lp_tgt, red)``, each None unless
    requested via ``want``; ``red`` is ``(sums [B, K], m [B])``.

    CUDA tensors launch ``vbn_cat_sweep``; CPU tensors run the plain
    version."""
    if fixed_idx.is_cuda:
        return _launch_categorical(
            seed, fixed_idx, stacked_counts, plan_tuple, n_samples, u_ext, want
        )
    return categorical_sweep_plain(
        seed, fixed_idx, stacked_counts, plan_tuple, n_samples,
        u_ext=u_ext, want=want,
    )


def lg_sweep_fused(
    seed: int,
    fixed_vals: torch.Tensor,  # [B, N] float32 evidence/do values
    param_table: torch.Tensor,  # [N, dmax + 2]
    plan_tuple,
    dmax: int,
    n_samples: int,
    u_ext: Optional[torch.Tensor] = None,  # [B, 2N, S] float32
    want=("logw", "lpt"),
):
    """Returns ``(log_w, target_vals, lp_tgt, red)``; ``red`` is the
    weighted-moments summary (sum_w, sum_wx, sum_wx2) and its shift.

    CUDA tensors launch ``vbn_lg_sweep``; CPU tensors run the plain
    version."""
    if fixed_vals.is_cuda:
        return _launch_lg(
            seed, fixed_vals, param_table, plan_tuple, dmax, n_samples,
            u_ext, want,
        )
    return lg_sweep_plain(
        seed, fixed_vals, param_table, plan_tuple, dmax, n_samples,
        u_ext=u_ext, want=want,
    )


# ---------------------------------------------------------------------------
# Program-level builder shared by the LW / MCM static paths
# ---------------------------------------------------------------------------


def make_fused_sweep_fn(plan, cpds, n_samples: int, want=("logw", "lpt")):
    """Return ``raw(params_tuple, seed, fixed) -> (logw, tgt, lpt, red)``
    using the family-matched fused kernel, or None when unsupported.
    ``fixed`` is the packed [B, total_dim] float32 evidence/do tensor
    (total_dim == n_nodes under both gates). ``want`` drops unneeded
    outputs; "pmf_*"/"mom_*" reduce the posterior in the kernel."""
    if categorical_sweep_reason(plan, cpds, n_samples) is None:
        plan_struct, total_rows, cmax = plan_tuple_for(plan, cpds)
        hi = [float(c.resolved_classes - 1) for c in cpds]

        def raw_cat(params_tuple, seed, fixed_vals):
            top = torch.tensor(hi, device=fixed_vals.device)
            fixed_i = torch.clamp(
                torch.round(torch.nan_to_num(fixed_vals)), min=0.0
            )
            fixed_i = torch.minimum(fixed_i, top).to(torch.int32)
            counts = _stacked_counts(cpds, params_tuple, total_rows, cmax)
            return categorical_sweep_fused(
                seed, fixed_i, counts, plan_struct, n_samples, want=want
            )

        return raw_cat

    lg_ok = lg_sweep_reason(plan, cpds, n_samples) is None
    if lg_ok and not any(w.startswith("pmf_") for w in want):
        # A class histogram over a continuous LG target is a binning
        # question, not a kernel reduction: refused, so the caller's
        # stream path serves it.
        plan_struct, dmax = lg_plan_tuple_for(plan, cpds)
        min_scales = tuple(float(c.min_scale) for c in cpds)

        def raw_lg(params_tuple, seed, fixed_vals):
            ptab = lg_param_table(cpds, params_tuple, dmax, min_scales)
            return lg_sweep_fused(
                seed, fixed_vals.float().contiguous(), ptab, plan_struct,
                dmax, n_samples, want=want,
            )

        return raw_lg
    return None
