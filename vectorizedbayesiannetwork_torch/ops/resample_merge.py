"""Systematic and multinomial resample-gather as a sorted merge, on CUDA.

Port of ``vectorizedbayesiannetwork_tpu/ops/resample_pallas.py``.
Systematic resampling merges two sorted sequences, the particle CDF
``cum`` and the stratified positions ``u_j = (j + u0)/S``, so ancestors are
nondecreasing in ``j``: ancestor = ``searchsorted(cum, u_j, 'right')``,
with ``u_j`` clamped to ``1 - 2^-24`` so it always lands on a real
particle. Multinomial resampling rides the same merge with sorted uniform
order statistics (normalized partial sums of S+1 Exp(1) draws). Per
resampling event the path launches one hand-written CUDA merge kernel
(``csrc/resample.cu``), besides the cumsum of ``ops/scan.py``:

- ``vbn_srg`` replaces ``resample_pallas.py:472 _srg_kernel`` (systematic
  positions computed in the kernel, in the JAX float32 order);
- ``vbn_spg`` replaces ``resample_pallas.py:531 _spg_kernel`` (positions
  read from ``pos``; S_out may differ from S_in).

``resample_pallas.py:250 _prebuild_kernel`` builds, per 512-entry window,
a search header and a copy of the values transposed to 8 sublanes, because
the TPU's vector unit resolves a rank by in-register lane gathers of 8
candidates at a time. A CUDA thread indexes shared memory directly, so the
Hopper merge needs no transposed CDF and no transposed values, only each
output tile's window pointer (``_window_pointers`` of
``resample_pallas.py:83``), and it derives those itself at each run's
start from a coarse sample of the window lasts (``tile_pointer`` in
``csrc/resample.cu``). ``vbn_cum_index`` is that routine's own entry
point, launched only to hold it against ``cum_index_plain``: it writes
each window's last CDF entry (``lasts [B, S/512]``) and each query's
window pointer (``ptrs [B, K]``).

All three are bound by bytes. ``vbn_srg`` and ``vbn_spg`` are one
template, ``merge_kernel``, built against the latency of its chain of
dependent loads (pointers, CDF window, search, values): a block owns a run
of consecutive tiles of one row (the grid sized from the SM count, one
wave), derives the run's pointers, stages the CDF windows (and, for
D <= 4, their values) in a ring of four shared windows with ``cp.async``,
prefetching the next tile's windows while it resolves the current one, so
a run reads each window once; each thread resolves four positions by their
own searches of the staged pair, and a position outside the pair takes an
exact search in global memory (the source note of ``csrc/resample.cu`` has
the details, ``tests/test_torch_resample.py`` a numpy model of the
pointers and the schedule). The wrappers (``cum_index``, ``srg``, ``spg``,
and ``cumsum_rows`` of ``ops/scan.py``) launch their kernel for CUDA
tensors and raise on what it does not take; for CPU tensors they run the
plain versions (``cum_index_plain``, ``srg_plain``, ``spg_plain``), which
compute the same function in torch ops (``torch.searchsorted`` and a
gather, the ``_xla`` references of the JAX module). ``LAUNCHES``
(``ops/_launch.py``) counts ``"cumsum"``, ``"cum_index"``, ``"srg"`` and
``"spg"``.

``norm_cum`` departs from the JAX ``_norm_cum`` in one point. For
S <= 2^20 the JAX function rounds the normalized weights to multiples of
2^-23 before its cumsum, so that any summation order gives the same CDF
and its TPU cumsum can skip the monotone pass. That rounding sends every
weight below 2^-24 to zero: at S = 2^20 a particle whose weight is under
1/16 of the uniform 1/S can never be drawn, which biases the posterior
(``tests/test_torch_resample.py`` shows the dropped mass). The port takes
the JAX branch for S > 2^20 at every S: the cumsum's monotone pass, no
rounding. On weights that are already such multiples, summing to 1, the
two agree bit for bit, which is how the tests hold the port to the JAX
kernels. Randomness (``u0`` [B, 1] or the Exp(1) draws
``e`` [B, S+1]) comes from an explicit argument or the caller's
``torch.Generator``.

Not ported: the ``VBN_SRG_PREBUILD``/``VBN_SRG_TPI``/``VBN_SRG_ABLATE`` and
``VBN_RESAMPLE_PALLAS`` probes and switches, ``_tiles_per_instance`` and
``_srg_ablate`` (TPU schedule experiments and cost ablations; here the
grid is sized from the card), and the in-register layout helpers
(``_hier_header``, ``_hier_vrows``, ``_build_block``) that the transposed
layout needed. The mesh resampler is ``ops/resample_distributed.py``; its
ring picks each visiting window through ``sorted_gather``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.profiling import spanned
from ._build import load
from ._launch import check, launch
from .scan import cumsum_rows

T = 512  # output positions per tile
W = 512  # CDF entries per window
POS_MAX = float(np.float32(1.0 - 2.0**-24))  # largest float32 below 1.0


def srg_supported(s: int, d: int) -> bool:
    """Static-shape gate of the merge kernels, the JAX gate as it is: a
    window pair needs two windows (S >= 1024), tiles need S % 512 == 0, and
    1 <= D <= 512 columns."""
    return s >= 2 * W and s % T == 0 and 1 <= d <= 512


def norm_cum(weights: torch.Tensor) -> torch.Tensor:
    """Normalized inclusive CDF [B, S] of nonnegative weights, shared by the
    kernels and the plain versions: the cumsum's monotone pass, then a
    division by the last entry (``_norm_cum``'s branch for S > 2^20,
    resample_pallas.py:137-143, taken at every S; see the module note)."""
    cum = cumsum_rows(weights.float().contiguous(), monotone=True)
    return cum / torch.clamp(cum[:, -1:], min=1e-20)


def _clamp_pos(u: torch.Tensor) -> torch.Tensor:
    return torch.clamp(u.float(), 0.0, POS_MAX)


def systematic_positions(u0: torch.Tensor, s: int, step: int = 1):
    """[B, S / step] positions ``min(j * (1/S) + u0 * (1/S), 1 - 2^-24)``
    for j = 0, step, 2 step, ... < S, in the kernel's float32 order (two
    roundings, no fused multiply-add); ``step`` = 512 gives each tile's
    first position."""
    inv_s = float(np.float32(1.0 / s))
    j = torch.arange(0, s, step, dtype=torch.float32, device=u0.device)
    u = j[None, :] * inv_s + u0.float().reshape(-1, 1) * inv_s
    return torch.clamp(u, max=POS_MAX)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the kernels' twins; the CPU path)
# ---------------------------------------------------------------------------


def cum_index_plain(cum: torch.Tensor, queries: torch.Tensor):
    """(lasts [B, S/W], ptrs [B, K] int32): each window's last CDF entry,
    and for each query (clamped to [0, 1 - 2^-24]) the window of its first
    ancestor, ``#{w : lasts[w] <= q}`` clamped to S/W - 2 so the window
    pair stays inside the CDF (``_window_pointers``; the CDF is
    nondecreasing, so a sorted search gives that count)."""
    lasts = cum[:, W - 1 :: W].contiguous()
    q = _clamp_pos(queries).contiguous()
    p = torch.searchsorted(lasts, q, right=True)
    return lasts, torch.clamp(p, max=lasts.shape[1] - 2).to(torch.int32)


def _search_gather(cum, u, values):
    idx = torch.searchsorted(cum.contiguous(), u.contiguous(), right=True)
    idx = torch.clamp(idx, 0, cum.shape[1] - 1)
    return values.gather(1, idx[..., None].expand(-1, -1, values.shape[-1]))


def srg_plain(u0: torch.Tensor, cum: torch.Tensor, values: torch.Tensor):
    """Systematic resample-gather on a normalized CDF -> [B, S, D]:
    ``values[searchsorted(cum, min((j + u0)/S, 1 - 2^-24), 'right')]``
    (``systematic_resample_gather_xla`` after its ``_norm_cum``)."""
    s = cum.shape[1]
    return _search_gather(cum, systematic_positions(u0, s), values)


def spg_plain(cum: torch.Tensor, pos: torch.Tensor, values: torch.Tensor):
    """Inverse-CDF pick for sorted positions -> [B, S_out, D]
    (``sorted_gather_xla``)."""
    return _search_gather(cum, _clamp_pos(pos), values)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/resample.cu), launched through ops/_launch.py
# ---------------------------------------------------------------------------


def _need_gate(s: int, d: int) -> None:
    if not srg_supported(s, d):
        raise ValueError(
            f"merge kernels need S >= {2 * W}, S % {T} == 0 and 1 <= D <= 512;"
            f" got S={s}, D={d}"
        )


@spanned("vbn.kernel.cum_index")
def _launch_cum_index(cum, queries):
    b, s = cum.shape
    _need_gate(s, 1)
    dev = cum.device
    check(cum, "cum", torch.float32, (b, s), dev)
    k = queries.shape[1]
    check(queries, "queries", torch.float32, (b, k), dev, strided=True)
    lasts = torch.empty((b, s // W), dtype=torch.float32, device=dev)
    ptrs = torch.empty((b, k), dtype=torch.int32, device=dev)
    launch("resample", "vbn_cum_index", cum.data_ptr(), b, s,
           queries.data_ptr(), queries.stride(0), queries.stride(1), k,
           lasts.data_ptr(), ptrs.data_ptr(), device=dev, key="cum_index")
    return lasts, ptrs


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x``, or a copy of it where its data does not start on 16 bytes:
    the merge kernel stages the CDF and the values with 16-byte
    ``cp.async``."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def merge_grid(b: int, s_out: int, d: int, systematic: bool = True):
    """(runs a row, tiles a run, block slots of the card) of the merge
    kernel's launch for B rows of S_out positions and D columns, as
    ``vbn_srg`` / ``vbn_spg`` size it on the current CUDA device."""
    import ctypes

    grid = (ctypes.c_int * 3)()
    rc = load("resample").vbn_merge_grid(b, s_out, d, int(systematic), grid)
    if rc != 0:
        raise RuntimeError(f"vbn_merge_grid failed: CUDA error {rc}")
    return tuple(grid)


@spanned("vbn.kernel.srg")
def _launch_srg(u0, cum, values):
    b, s = cum.shape
    d = values.shape[-1]
    _need_gate(s, d)
    dev = cum.device
    check(cum, "cum", torch.float32, (b, s), dev)
    check(values, "values", torch.float32, (b, s, d), dev)
    check(u0, "u0", torch.float32, (b, 1), dev)
    cum, values = _aligned(cum), _aligned(values)
    out = torch.empty_like(values)
    launch("resample", "vbn_srg", cum.data_ptr(), b, s, u0.data_ptr(),
           float(np.float32(1.0 / s)), values.data_ptr(), d, out.data_ptr(),
           device=dev, key="srg")
    return out


@spanned("vbn.kernel.spg")
def _launch_spg(cum, pos, values):
    b, s_in = cum.shape
    s_out, d = pos.shape[1], values.shape[-1]
    _need_gate(s_in, d)
    if s_out < T or s_out % T:
        raise ValueError(f"spg needs S_out % {T} == 0 and S_out >= {T}; "
                         f"got {s_out}")
    dev = cum.device
    check(cum, "cum", torch.float32, (b, s_in), dev)
    check(pos, "pos", torch.float32, (b, s_out), dev)
    check(values, "values", torch.float32, (b, s_in, d), dev)
    cum, values = _aligned(cum), _aligned(values)
    out = torch.empty((b, s_out, d), dtype=torch.float32, device=dev)
    launch("resample", "vbn_spg", cum.data_ptr(), b, s_in, pos.data_ptr(),
           s_out, values.data_ptr(), d, out.data_ptr(), device=dev, key="spg")
    return out


# ---------------------------------------------------------------------------
# Wrappers: the kernel for CUDA tensors, the plain version for CPU tensors
# ---------------------------------------------------------------------------


def cum_index(cum: torch.Tensor, queries: torch.Tensor):
    """(lasts [B, S/W], ptrs [B, K]): ``vbn_cum_index`` (the merge's
    pointer routine on its own) or ``cum_index_plain``. ``queries`` may be
    a strided view."""
    if cum.is_cuda:
        return _launch_cum_index(cum, queries)
    return cum_index_plain(cum, queries)


def srg(u0, cum, values):
    """Systematic resample-gather on a normalized CDF -> [B, S, D]:
    ``vbn_srg`` or ``srg_plain``."""
    if cum.is_cuda:
        return _launch_srg(u0, cum, values)
    return srg_plain(u0, cum, values)


def spg(cum, pos, values):
    """Sorted-position gather on a normalized CDF -> [B, S_out, D]:
    ``vbn_spg`` or ``spg_plain``."""
    if cum.is_cuda:
        return _launch_spg(cum, pos, values)
    return spg_plain(cum, pos, values)


def systematic_resample_gather(
    weights: torch.Tensor,  # [B, S] nonnegative, need not be normalized
    values: torch.Tensor,  # [B, S, D]
    *,
    u0: Optional[torch.Tensor] = None,  # [B, 1] in [0, 1)
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Systematic resampling of ``values`` by ``weights`` -> [B, S, D]:
    one cumsum and one merge launch on the card."""
    if u0 is None:
        u0 = torch.rand((weights.shape[0], 1), generator=generator, device=weights.device)
    u0 = u0.float().contiguous()
    return srg(u0, norm_cum(weights), values.float().contiguous())


def systematic_resample_gather_plain(weights, values, *, u0):
    """The same in plain torch ops on ``norm_cum``'s CDF
    (``systematic_resample_gather_xla``)."""
    return srg_plain(u0.float(), norm_cum(weights), values.float())


def sorted_gather(cum: torch.Tensor, pos: torch.Tensor, values: torch.Tensor):
    """Inverse-CDF pick for sorted positions -> [B, S_out, D]:
    ``values[searchsorted(cum, clip(pos, 0, 1 - 2^-24), 'right')]``. The
    CDF is nondecreasing and normalized (last entry 1.0)."""
    return spg(cum.float().contiguous(), pos.float().contiguous(),
               values.float().contiguous())


def multinomial_resample_gather(
    weights: torch.Tensor,
    values: torch.Tensor,
    *,
    e: Optional[torch.Tensor] = None,  # [B, S + 1] Exp(1) draws
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """i.i.d. multinomial resampling via sorted uniform order statistics.

    Normalized partial sums of S+1 iid Exp(1) draws are the order
    statistics of S iid U(0, 1) draws, so picks through the merge give a
    multiset of ancestors distributed as ``torch.multinomial`` draws (only
    the particle order differs, and resampled particles are exchangeable).
    Two cumsum launches and one merge launch on the card."""
    b, s = weights.shape
    cum = norm_cum(weights)
    if e is None:
        e = torch.empty((b, s + 1), device=weights.device).exponential_(
            generator=generator
        )
    c = cumsum_rows(e.float().contiguous(), monotone=True)
    pos = c[:, :s] / torch.clamp(c[:, -1:], min=1e-20)
    return sorted_gather(cum, pos, values)
