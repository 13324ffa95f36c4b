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
a CUDA tensor they launch the kernel or raise, through
``ops/_launch.py``, which counts each launch in ``LAUNCHES``.

Uniforms: ``u_ext`` is ``[B, N, S]`` (categorical) or ``[B, 2N, S]`` (LG,
rows 2i and 2i+1 the Box-Muller pair), the JAX layout. Without it both the
kernels and the plain versions draw Philox-4x32-10 from ``seed``
(``core.rng.philox_uniforms``), so the in-kernel random mode is comparable
bit for bit too. Each sweep draws the grouped stream of its scan kernel
(``grouped=True``), so on a static plan the two draw the same values: the
categorical sweep ``vbn_cat_scan``'s (one call per four nodes), the LG
sweep ``vbn_lg_scan``'s (one call per two nodes, counter (particle, row,
node >> 1, 3)).

Reductions return ``(sums [B, K], m [B])``: ``sums`` are the class
histogram (K = the target's classes) or the moments (sum w, sum w x,
sum w x^2; K = 3) of ``w = exp(src - m)``, where ``m`` is the row's max of
``src`` (logw or lpt). The JAX kernels pad ``sums`` to 128 lanes; the port
returns the K lanes that carry data.

Under a ('data', 'particle') mesh (``make_fused_sweep_fn(mesh=)``) each
rank launches the kernel on its block of rows and particles and the
reductions combine over 'particle' (``_shard_sweep``, which serves the scan
kernels of ``ops/sweep_scan.py`` too).

The gate verdict: each build of a raw function (``make_fused_sweep_fn``
here, ``make_scan_sweep_fn`` in ``ops/sweep_scan.py``; the port builds one
a call, having no program cache) prints one line under
``VBN_SWEEP_LOG`` or ``VBN_VERBOSITY>=1`` (``gate_log``, the JAX
``_gate_log`` of ``sweep_pallas.py:702``, its fields in its order:
target, n_nodes, n_samples, mesh, path, reason). The port names its own
routes in ``path``; a JAX path maps so (``JAX_PATHS``):

- ``pallas-categorical`` -> ``cuda-categorical``;
- ``pallas-linear-gaussian`` -> ``cuda-linear-gaussian``;
- ``xla`` -> ``torch`` (the torch-op sweeps of ``inference/_sweep.py``);
- ``pallas-scan-categorical`` -> ``cuda-scan-categorical``;
- ``pallas-scan-linear-gaussian`` -> ``cuda-scan-linear-gaussian``;
- ``xla-scan`` -> ``torch-scan`` (``inference/_dynamic_sweep.py``).

A ``cuda-*`` path runs the kernel on the card and its plain version on
the CPU. Where the JAX builder refuses a meshed batch that does not split
(path ``xla``), the port serves it whole on every rank on the kernel and
prints the kernel's path with the reason and ``served whole``.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np
import torch

from ..core.rng import philox_uniforms
from ..utils.profiling import BUILDS, counter, spanned, wait
from ._launch import check, launch
from .cat_tables import cum_tables, padded_layout
from .lg_records import _HALF_LOG_2PI, lg_densities, lg_records, lg_slot_map

_MAX_C = 32  # classes per node
_MAX_ROWS_X_C = 2048  # CPT rows x classes per node
_MAX_NODES = 80
_THREADS = 128  # threads per block (VBN_THREADS in csrc/sweep.cu)

# the JAX builders' gate-log paths -> the port's
JAX_PATHS = {
    "pallas-categorical": "cuda-categorical",
    "pallas-linear-gaussian": "cuda-linear-gaussian",
    "xla": "torch",
    "pallas-scan-categorical": "cuda-scan-categorical",
    "pallas-scan-linear-gaussian": "cuda-scan-linear-gaussian",
    "xla-scan": "torch-scan",
}


def gate_log(plan, n_samples, mesh, path, reason=None):
    """One-line gate verdict of a build, behind ``VBN_VERBOSITY>=1`` or
    ``VBN_SWEEP_LOG`` (any value), as the JAX ``_gate_log`` prints it."""
    from ..core.utils import resolve_verbosity
    from ..parallel.mesh import DATA_AXIS, PARTICLE_AXIS, mesh_shape

    if not (resolve_verbosity() >= 1 or os.environ.get("VBN_SWEEP_LOG")):
        return
    tgt = plan.topo_order[plan.target_idx]
    shape = (dict(zip((DATA_AXIS, PARTICLE_AXIS), mesh_shape(mesh)))
             if mesh is not None else None)
    msg = (
        f"[fused-sweep] target={tgt!r} n_nodes={plan.n_nodes} "
        f"n_samples={n_samples} mesh={shape} path={path}"
    )
    if reason:
        msg += f" reason={reason}"
    print(msg, flush=True)


def shard_refusal(mesh, b: int, n_samples: int, grid: int = 1):
    """Why a meshed batch of ``b`` rows of ``n_samples`` particles does not
    split over ``mesh`` (the first failing condition), or None: rows over
    'data', particles over 'particle', and the shard's particles on the
    kernels' ``grid``."""
    from ..parallel.mesh import mesh_shape

    nd, npart = mesh_shape(mesh)
    if b % nd:
        return f"batch {b} not divisible by data axis {nd}"
    if n_samples % npart:
        return f"n_samples {n_samples} not divisible by particle axis {npart}"
    if (n_samples // npart) % grid:
        return (f"n_samples {n_samples} over particle axis {npart} is not a "
                f"multiple of {grid}")
    return None


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


@spanned("vbn.tables")
def _stacked_counts(cpds, params_tuple, total_rows: int, cmax: int):
    """[total_rows, cmax] float32: every node's count rows, zero-padded."""
    BUILDS["tables"] += 1
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


@spanned("vbn.tables")
def lg_param_table(cpds, params_tuple, dmax: int, min_scales):
    """[N, dmax + 2] rows: [w_0..w_{din-1}, 0pad, bias, sigma]."""
    BUILDS["tables"] += 1
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
    """Same contract as ``categorical_sweep_fused``, in torch ops, drawing
    the kernel's grouped Philox stream without ``u_ext``."""
    (n_nodes, parent_idx, ev_mask, do_mask, target_idx, offs, pstates,
     cards, strides) = plan_tuple
    b, s = fixed_idx.shape[0], n_samples
    dev = fixed_idx.device
    if u_ext is None:
        u_ext = philox_uniforms(seed, b, n_nodes, s, 1, dev, grouped=True)
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
    """Same contract as ``lg_sweep_fused``, in torch ops, drawing the
    kernel's grouped Philox stream (two nodes a call) without ``u_ext``.
    A parent of weight exactly 0 is skipped, as the kernel's records leave
    it out."""
    n_nodes, parent_idx, ev_mask, do_mask, target_idx = plan_tuple
    b, s = fixed_vals.shape[0], n_samples
    dev = fixed_vals.device
    if u_ext is None:
        u_ext = philox_uniforms(seed, b, n_nodes, s, 2, dev, grouped=True)
    want_logw, want_tgt, want_lpt, red_kind, red_src = _parse_want(want)
    need_logw = want_logw or red_src == "logw"
    need_lpt = want_lpt or red_src == "lpt"
    two_pi = torch.tensor(2.0 * np.pi, dtype=torch.float32, device=dev)
    w_h = param_table.cpu().tolist()
    vals = [None] * n_nodes
    logw = torch.zeros((b, s), dtype=torch.float32, device=dev)
    lpt = torch.zeros((b, s), dtype=torch.float32, device=dev)
    for i in range(n_nodes):
        loc = param_table[i, dmax].expand(b, s)
        for k, p in enumerate(parent_idx[i]):
            if w_h[i][k] != 0.0:
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
# CUDA kernels (csrc/sweep.cu), launched through ops/_launch.py
# ---------------------------------------------------------------------------


def _ppt(n_samples: int, threads: int = _THREADS) -> int:
    """Particles per thread: a block spans threads * ppt particles."""
    return 16 if n_samples % (threads * 16) == 0 else 8


def _lg_ppt(n_samples: int) -> int:
    """Particles per thread of ``vbn_lg_sweep``: 64 where S allows it, so a
    block's row copy and fold are spread over 8192 particles (faster than
    16 on the flagship's B = 1024, S = 2^20 on an H100), else ``_ppt``'s."""
    return 64 if n_samples % (_THREADS * 64) == 0 else _ppt(n_samples)


def _a16(n: int) -> int:
    return (n + 15) & ~15


def _cat_sweep_smem(n, n_slots, k) -> int:
    """Shared-memory bytes of ``vbn_cat_sweep`` (``cat_sweep_smem``): the
    row's packed words, the byte value scratch, the reduction array (k = 0:
    none)."""
    at = _a16(4 * n) + _a16(n_slots * _THREADS)
    return at + (_a16(4 * (k + 1) * _THREADS) if k else 0)


def table_layout(plan_struct, cmax: int):
    """The padded-table layout (``ops/cat_tables.py``) of the stacked
    counts: node i's rows start at row ``offs_i`` of the [rows, cmax]
    table, ``cmax`` floats apart."""
    n, offs, pstates, cards = (plan_struct[0], plan_struct[5], plan_struct[6],
                               plan_struct[7])
    return pstates, cards, tuple(o * cmax for o in offs), (cmax,) * n


@functools.lru_cache(maxsize=64)
def _cat_meta_host(plan_struct):
    """The categorical kernel's plan metadata (the layout of
    ``ops/sweep_scan.py::_cat_meta_host``): rec [N + 1, 4] {off, card, slot,
    pstart} with rec[N] = (0, 0, 0, P), par [max(P, 1), 2] {slot, stride},
    n_slots, the node flags [N] (ev << 16 | do << 17) and the live-group
    mask (bit g: group g has a node to draw). Only parents get a scratch
    slot; the other nodes share one trash slot."""
    (n, parent_idx, ev_mask, do_mask, _t, _offs, _ps, cards,
     strides) = plan_struct
    referenced = sorted({p for ps in parent_idx for p in ps})
    slot_of = {p: k for k, p in enumerate(referenced)}
    off = padded_layout(*table_layout(plan_struct, max(cards)))[0]
    rec = np.zeros((n + 1, 4), np.int32)
    par, at = [], 0
    for i in range(n):
        rec[i] = (off[i], cards[i], slot_of.get(i, len(referenced)), at)
        par += [[slot_of[p], st] for p, st in zip(parent_idx[i], strides[i])]
        at += len(parent_idx[i])
    rec[n, 3] = at
    flags = np.asarray([(int(e) << 16) | (int(d) << 17)
                        for e, d in zip(ev_mask, do_mask)], np.int32)
    glive = 0
    for i in range(n):
        if not (ev_mask[i] or do_mask[i]):
            glive |= 1 << (i >> 2)
    return (rec, np.asarray(par or [[0, 0]], np.int32), len(referenced) + 1,
            flags, glive)


@functools.lru_cache(maxsize=64)
def _cat_meta(plan_struct, device: torch.device):
    """(rec, par, node flags) of ``_cat_meta_host`` on ``device``."""
    rec, par, _n_slots, flags, _glive = _cat_meta_host(plan_struct)
    return tuple(torch.as_tensor(a, device=device) for a in (rec, par, flags))


def lg_struct(plan_struct, dmax: int):
    """The records' structure (``ops/lg_records.py``) of an LG plan:
    (pids [N][dmax] padded with 0, pmax, dmax), ``lg_scan_struct_for``'s
    for the same plan."""
    pids = tuple(tuple(p) + (0,) * (dmax - len(p)) for p in plan_struct[1])
    return pids, dmax, dmax


@functools.lru_cache(maxsize=64)
def _lg_flags_host(plan_struct):
    """(node flags [N] int32 ev | do << 1, live-pair mask: bit p set when
    pair p has a node to draw) of an LG plan."""
    n, _parents, ev_mask, do_mask, _t = plan_struct
    flags = np.asarray([int(e) | (int(d) << 1)
                        for e, d in zip(ev_mask, do_mask)], np.int32)
    plive = 0
    for i in range(n):
        if flags[i] == 0:
            plive |= 1 << (i >> 1)
    return flags, plive


@functools.lru_cache(maxsize=64)
def _lg_flags(plan_struct, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_lg_flags_host(plan_struct)[0], device=device)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _outputs(b, s, nblk, k, want, device):
    want_logw, want_tgt, want_lpt, red_kind, red_src = _parse_want(want)
    f32 = dict(dtype=torch.float32, device=device)
    return (
        torch.empty((b, s), **f32) if want_logw else None,
        torch.empty((b, s), **f32) if want_tgt else None,
        torch.empty((b, s), **f32) if want_lpt else None,
        torch.empty((b, nblk, k + 1), **f32) if red_kind else None,
    )


@spanned("vbn.kernel.categorical")
def _launch_categorical(seed, fixed_idx, counts, plan_struct, s, u_ext, want):
    n = plan_struct[0]
    b = fixed_idx.shape[0]
    target, pstates, cards = plan_struct[4], plan_struct[6], plan_struct[7]
    total_rows, cmax = sum(pstates), counts.shape[1]
    dev = fixed_idx.device
    check(fixed_idx, "fixed_idx", torch.int32, (b, n), dev)
    if cmax < max(cards):
        raise ValueError(f"stacked_counts has {cmax} < {max(cards)} columns")
    check(counts, "stacked_counts", torch.float32, (total_rows, cmax), dev)
    if u_ext is not None:
        check(u_ext, "u_ext", torch.float32, (b, n, s), dev)
    if s % 1024 != 0:
        raise ValueError(f"n_samples {s} not a multiple of 1024")
    want_logw, want_tgt, want_lpt, red_kind, red_src = _parse_want(want)
    ppt = _ppt(s)
    nblk = s // (_THREADS * ppt)
    k = cards[target] if red_kind == "pmf" else 3
    outs = _outputs(b, s, nblk, k, want, dev)
    n_slots, _flags, glive = _cat_meta_host(plan_struct)[2:]
    rec, par, flags = _cat_meta(plan_struct, dev)
    ctab, lpt = cum_tables(counts.view(-1), table_layout(plan_struct, cmax))
    launch("sweep", "vbn_cat_sweep",
           rec.data_ptr(), par.data_ptr(), n, n_slots, target,
           ctab.data_ptr(), lpt.data_ptr(), flags.data_ptr(), glive,
           fixed_idx.data_ptr(), _ptr(u_ext), seed & ((1 << 64) - 1),
           b, s, ppt,
           int(want_logw or red_src == "logw"),
           int(want_lpt or red_src == "lpt"),
           int(want_logw), int(want_tgt), int(want_lpt),
           {"pmf": 1, "mom": 2}.get(red_kind, 0), int(red_src == "lpt"), k,
           *[_ptr(o) for o in outs], device=dev, key="categorical")
    logw, tgt, lpt, part = outs
    red = _combine_reduction(part, k) if part is not None else None
    return logw, tgt, lpt, red


@spanned("vbn.kernel.lg")
def _launch_lg(seed, fixed_vals, ptab, plan_tuple, dmax, s, u_ext, want):
    n = plan_tuple[0]
    b = fixed_vals.shape[0]
    dev = fixed_vals.device
    check(fixed_vals, "fixed_vals", torch.float32, (b, n), dev)
    check(ptab, "param_table", torch.float32, (n, dmax + 2), dev)
    if u_ext is not None:
        check(u_ext, "u_ext", torch.float32, (b, 2 * n, s), dev)
    if s % 1024 != 0:
        raise ValueError(f"n_samples {s} not a multiple of 1024")
    want_logw, want_tgt, want_lpt, red_kind, red_src = _parse_want(want)
    if red_kind == "pmf":
        raise ValueError("pmf reduction undefined for continuous LG targets")
    ppt = _lg_ppt(s)
    nblk = s // (_THREADS * ppt)
    outs = _outputs(b, s, nblk, 3, want, dev)
    struct = lg_struct(plan_tuple, dmax)
    n_slots = lg_slot_map(struct[0])[2]
    _flags, plive = _lg_flags_host(plan_tuple)
    rec, par = lg_records(ptab.view(-1), struct)
    dens = lg_densities(ptab.view(-1), struct)
    launch("sweep", "vbn_lg_sweep",
           rec.data_ptr(), par.data_ptr(), dens.data_ptr(), n, n_slots,
           plan_tuple[4],
           _lg_flags(plan_tuple, dev).data_ptr(), plive,
           fixed_vals.data_ptr(), _ptr(u_ext), seed & ((1 << 64) - 1),
           b, s, ppt,
           int(want_logw or red_src == "logw"),
           int(want_lpt or red_src == "lpt"),
           int(want_logw), int(want_tgt), int(want_lpt),
           2 if red_kind == "mom" else 0, int(red_src == "lpt"),
           *[_ptr(o) for o in outs], device=dev, key="lg")
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
# Sharding over the ('data', 'particle') mesh
# ---------------------------------------------------------------------------


def _combine_particle_shards(sums, m, mesh):
    """(sums, m) of every particle shard -> the rows' combined pair: the
    shifted sums are linear in exp(-m), so scaling each shard's by
    exp(m - max m) and summing is exact. A shard whose m is -inf (no
    weight) adds zero, so a row with no weight on any shard sums to zeros
    (no exp(-inf - -inf))."""
    import torch.distributed as dist

    from ..parallel.mesh import PARTICLE_AXIS, all_reduce

    mg = all_reduce(m, mesh, PARTICLE_AXIS, dist.ReduceOp.MAX)
    scale = torch.where(torch.isneginf(m), 0.0, torch.exp(m - mg))
    return all_reduce(sums * scale[:, None], mesh, PARTICLE_AXIS), mg


def _shard_sweep(mesh, n_samples, call, seed, rows, u_ext=None, log=None):
    """``call(seed, *rows, u_ext, s)`` over the mesh, as the JAX package's
    ``_shard_sweep`` (``sweep_pallas.py:720``) and the scan forms'
    ``_shard_scan_sweep`` / ``_shard_lg_scan`` run it under ``shard_map``.

    Each rank runs its block of the query rows (over 'data') at
    ``s_loc = n_samples / n_particle`` particles with the seed folded by its
    shard index ``di * n_particle + pi`` (``core.rng.fold``); ``u_ext`` is
    then the rank's own uniform block (``[B_l, N or 2N, s_loc]``). The
    reductions combine over 'particle'; every output is gathered, so each
    rank returns the global ``[B, S]`` streams and ``[B, K]`` rows.

    A batch the shard gates refuse (B % n_data, n_samples % n_particle, or
    s_loc off the kernels' 1024 grid: the plan's gates passed at
    ``n_samples``, and of their conditions only that one depends on S) is
    served whole on every rank, exactly as with no mesh; ``u_ext`` is then
    the global block, and ``log(reason)`` prints the gate line."""
    from ..parallel.mesh import block, gather_blocks, mesh_coords, mesh_shape
    from ..core.rng import mix64

    nd, npart = mesh_shape(mesh)
    b = rows[0].shape[0]
    refused = None if mesh is None else shard_refusal(mesh, b, n_samples,
                                                      1024)
    if mesh is None or refused:
        if refused and log is not None:
            log(f"{refused}: served whole")
        return call(seed, *rows, u_ext, n_samples)
    di, pi = mesh_coords(mesh)
    local = tuple(block(r, nd, di).contiguous() for r in rows)
    logw, tgt, lpt, red = call(mix64(seed, di * npart + pi), *local, u_ext,
                               n_samples // npart)
    streams = [None if t is None else gather_blocks(t, mesh)
               for t in (logw, tgt, lpt)]
    if red is not None:
        sums, m = _combine_particle_shards(*red, mesh)
        red = (gather_blocks(sums, mesh, dims=(0,)),
               gather_blocks(m, mesh, dims=(0,)))
    return (*streams, red)


TRACES = counter("TRACES", ("sharded", "whole"))


def shard_trace(mesh, trace, draw, n_samples, rows, gather=True):
    """``trace(stream, *rows)`` of a torch-op sweep (``inference/_sweep.py``,
    ``_dynamic_sweep.py``, either form) over the mesh, its outputs [B, S,
    ...] tensors gathered so every rank returns the global ones (``rows``:
    [B, ...] inputs, or None).

    Each rank sweeps its block of the query rows ``rows`` (over 'data') at
    ``s_loc = n_samples / n_particle`` particles on the row stream of
    ``draw`` with ``row0 = di * B_l`` and ``particle0 = pi * s_loc``: the
    counters of the unmeshed particles, so the gathered stream is the
    unmeshed stream bit for bit and every reduction after it runs
    unchanged. A rank holds [N, B_l, s_loc] state. With no mesh, or a batch
    the gates refuse (B % n_data, n_samples % n_particle), the sweep runs
    whole on every rank, as ``_shard_sweep`` serves it. ``TRACES`` counts
    the meshed calls by how they ran ("sharded" / "whole"). With
    ``gather=False`` a sharded call returns this rank's blocks (the chain
    samplers run their chains on them)."""
    from ..core.rng import RowStream
    from ..parallel.mesh import block, gather_blocks, mesh_coords, mesh_shape

    nd, npart = mesh_shape(mesh)
    b = rows[0].shape[0]
    if mesh is None or shard_refusal(mesh, b, n_samples):
        if mesh is not None:
            TRACES["whole"] += 1
        return trace(RowStream(draw, b, n_samples), *rows)
    TRACES["sharded"] += 1
    di, pi = mesh_coords(mesh)
    b_l, s_l = b // nd, n_samples // npart
    stream = RowStream(draw, b_l, s_l, row0=di * b_l, particle0=pi * s_l,
                       n_particles=n_samples, n_rows=b)
    local = tuple(None if r is None else block(r, nd, di).contiguous()
                  for r in rows)
    out = trace(stream, *local)
    return tuple(gather_blocks(t, mesh) for t in out) if gather else out


# ---------------------------------------------------------------------------
# Program-level builder shared by the LW / MCM static paths
# ---------------------------------------------------------------------------


@spanned("vbn.build")
def make_fused_sweep_fn(plan, cpds, n_samples: int, want=("logw", "lpt"),
                        mesh=None):
    """Return ``raw(params_tuple, seed, fixed, u_ext=None) -> (logw, tgt,
    lpt, red)`` using the family-matched fused kernel, or None when
    unsupported. ``fixed`` is the packed [B, total_dim] float32 evidence/do
    tensor (total_dim == n_nodes under both gates). ``want`` drops unneeded
    outputs; "pmf_*"/"mom_*" reduce the posterior in the kernel.

    With ``mesh`` the kernel runs sharded (``_shard_sweep``): rows over
    'data', particles over 'particle'. The JAX function's ``batch=`` gate is
    taken per call, from the rows the raw is given. A raw built counts in
    ``BUILDS["fn"]``."""
    reason = categorical_sweep_reason(plan, cpds, n_samples)
    if reason is None:
        plan_struct, total_rows, cmax = plan_tuple_for(plan, cpds)
        hi = [float(c.resolved_classes - 1) for c in cpds]

        def raw_cat(params_tuple, seed, fixed_vals, u_ext=None):
            wait(fixed_vals.device)
            top = torch.tensor(hi, device=fixed_vals.device)
            fixed_i = torch.clamp(
                torch.round(torch.nan_to_num(fixed_vals)), min=0.0
            )
            fixed_i = torch.minimum(fixed_i, top).to(torch.int32)
            counts = _stacked_counts(cpds, params_tuple, total_rows, cmax)

            def call(sd, fx, u, s):
                return categorical_sweep_fused(sd, fx, counts, plan_struct, s,
                                               u_ext=u, want=want)

            return _shard_sweep(mesh, n_samples, call, seed,
                                (fixed_i,), u_ext, log=functools.partial(
                                    gate_log, plan, n_samples, mesh,
                                    "cuda-categorical"))

        gate_log(plan, n_samples, mesh, "cuda-categorical")
        BUILDS["fn"] += 1
        return raw_cat

    lg_reason = lg_sweep_reason(plan, cpds, n_samples)
    if lg_reason is None and any(w.startswith("pmf_") for w in want):
        # A class histogram over a continuous LG target is a binning
        # question, not a kernel reduction: refused, so the caller's
        # stream path serves it.
        lg_reason = "pmf reduction undefined for continuous LG targets"
    if lg_reason is None:
        plan_struct, dmax = lg_plan_tuple_for(plan, cpds)
        min_scales = tuple(float(c.min_scale) for c in cpds)

        def raw_lg(params_tuple, seed, fixed_vals, u_ext=None):
            ptab = lg_param_table(cpds, params_tuple, dmax, min_scales)

            def call(sd, fx, u, s):
                return lg_sweep_fused(sd, fx, ptab, plan_struct, dmax, s,
                                      u_ext=u, want=want)

            return _shard_sweep(mesh, n_samples, call, seed,
                                (fixed_vals.float().contiguous(),), u_ext,
                                log=functools.partial(
                                    gate_log, plan, n_samples, mesh,
                                    "cuda-linear-gaussian"))

        gate_log(plan, n_samples, mesh, "cuda-linear-gaussian")
        BUILDS["fn"] += 1
        return raw_lg
    gate_log(plan, n_samples, mesh, "torch",
             f"categorical: {reason}; linear_gaussian: {lg_reason}")
    return None
