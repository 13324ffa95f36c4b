"""Kernel-density (KDE) log-densities and support picks on hand-written
CUDA kernels.

Port of ``vectorizedbayesiannetwork_tpu/ops/kde_pallas.py``. Four CUDA
entry points (``csrc/kde.cu``) replace its four TPU kernels:

- ``vbn_kde_root`` replaces ``kde_pallas.py:147 _kde_root_kernel_direct``:
  a root node's masked ``lse_n(log N(x_m - t_n; 0, h_y) + log_mask_n)``
  (the caller subtracts ``log n_eff``), Dx <= 32;
- ``vbn_kde_cond`` replaces ``kde_pallas.py:106 _kde_cond_kernel_direct``:
  the conditional ``lse_n(kp + ky) - lse_n(kp)``, max(Dx, Dp) <= 32;
- ``vbn_kde_cond_wide`` replaces ``kde_pallas.py:72 _kde_cond_kernel``: the
  same beyond 32 features, its cross terms on the tensor cores in 3xTF32
  on data centred on the support's mean, where the TPU kernel ran a bf16x3
  cross-term GEMM;
- ``vbn_kde_pick`` replaces ``kde_pallas.py:390 _kde_pick_kernel`` and
  ``:412 _kde_pick_kernel_extg``: one draw per query row from the
  categorical with weights ``mask_n exp(-|p_m - dp_n|^2 / 2h_p^2)``, then
  ``data_x[n*]``.

The log-densities are bound by operations (an exp per pair and
logsumexp), not bytes; the source note says what the designs do about
that.

Beside each wrapper sits a plain PyTorch version with the same signature
(``kde_root_plain``, ``kde_cond_plain`` for both conditional kernels,
``kde_pick_plain``), which walks the query rows ``_CHUNK`` at a time, so no
[M, N] tensor is ever whole. The wrappers launch the kernel for CUDA
tensors and raise on what it does not take; for CPU tensors they run the
plain version, which is how the CPU serves every KDE log-density
(``ops/kde_kernel.py``). ``LAUNCHES`` (``ops/_launch.py``) counts the
launches under ``"kde_root"``, ``"kde_cond"``, ``"kde_cond_wide"`` and
``"kde_pick"``, and those that carried a read flag (below) under
``"kde_root.flagged"``, ``"kde_cond.flagged"`` and ``"kde_pick.flagged"``.

The read flag. ``kde_root``, ``kde_cond`` and ``kde_pick`` take ``read``
(a ``ReadFlag``): the query rows whose results the caller reads, one
float a query row of the launch's rows (``s_loc`` launch rows a query
row), nonzero where read. The per-node dynamic sweep passes each node's
evidence mask column to its log-density and its free (neither evidence
nor do) column to its pick, since it keeps nothing else of them. Every
unread row comes back 0, and each read row is what the launch without a
flag gives, bit for bit: the kernels retire whole blocks none of whose
rows is read, and the plain versions zero the unread rows. The root pick
and the Gumbel pick take no flag (the wrapper drops it on both devices,
so they score every row), nor does ``kde_cond_wide``.

The pick has two routes. The served one draws by inverse CDF on one
uniform a row: with ``s_n = -|p - dp_n|^2 inv2p + log_mask_n`` and
``w_n = exp(s_n - max s)``, the first n whose running sum of w exceeds
``t = u * sum w``. The uniform comes from a 64-bit Philox key held in a
device tensor (``key``, int64 [2]: its low and high 32-bit words), so
drawing it costs no host sync: counter (g, g >> 32, 0, 2), word 0,
clamped below 1, where g is the row's global flat row in its batch
(``RowMap``: a mesh rank's block of rows and particles draws the unmeshed
uniforms; an unmeshed call's g is the row) (``pick_uniforms`` rebuilds it
in torch ops). A sweep's key is its node's own seed on the row stream
(``core/rng.py::NodeStream.seed``); a caller with a ``torch.Generator``
draws one (``pick_key``). The sums are taken
to better than float32 on both sides (float64 here, float-float or
float64 in the kernel), so the order of the additions does not decide a
pick; the kernel's terms (``__expf`` against a lazily moved reference)
still round apart from ``torch.exp``'s, so on a rare row, where t lies
within that rounding of a running sum, the two pick neighbours in the
walk. The JAX kernel draws the same categorical as a Gumbel-argmax over
all N points, so the two packages agree in distribution, not pick by
pick. The other route takes the Gumbel field from outside (``gumbel``
[M, N], the JAX kernels' test hook) and keeps the Gumbel-argmax, the
first index on ties: there kernel, plain version and JAX kernel pick the
same point.

One departure from the JAX kernel: its uniform ``((bits >> 8) + 0.5) *
2^-24`` rounds to exactly 1.0 in float32 for the top 24-bit value, where
``-log(-log u)`` is +inf and the pick takes that point whatever its mask
says: once in 2^24 pairs. The port's uniforms are clamped to 1 - 2^-24,
the largest float32 below 1 (``clamped_uniform``).

Not ported: the TPU layout work (``_tile_rows``, the 128-lane feature
padding, the ``[D, N]`` support transposes, the one-hot GEMM that copies
the picked rows) and the backend switch (``pallas_available`` and its
``VBN_KDE_PALLAS`` flag): the tensor's device chooses.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.rng import U_MAX, philox4x32_10, uniform_from_bits
from ..utils.profiling import annotate, wait
from ._build import load
from ._launch import check, launch

_DIRECT_D = 32  # feature-count cutoff of the direct kernels (kde_pallas.py:103)
_ROOT_CDF_MAX = 16384  # the root pick's CDF in shared memory (csrc/kde.cu)
_CHUNK = 4096  # query rows per tile of a plain version or chunked form


def kernel_consts(d: int, scale: float):
    """(1 / 2h^2, -d (log sqrt(2 pi) + log h)) as float32, the values every
    kernel and plain version uses."""
    inv2 = 1.0 / (2.0 * scale * scale)
    const = -d * (0.5 * math.log(2.0 * math.pi) + math.log(scale))
    return np.float32(inv2), np.float32(const)


LOG2E = 1.4426950408889634


def direct_consts(d: int, scale: float):
    """(sqrt(log2(e) / 2h^2), log2(e) * const) as float32: ``kernel_consts``
    in the base-2 domain of ``vbn_kde_root`` and ``vbn_kde_cond``, which
    scale the coordinates by the first (so a squared difference is already
    the base-2 exponent's) and stage the second with the mask."""
    inv2, const = kernel_consts(d, scale)
    return (np.float32(np.sqrt(np.float64(inv2) * LOG2E)),
            np.float32(np.float64(const) * LOG2E))


def sq_dist(q: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """sum_d (q_md - t_nd)^2 -> [M, N], one feature after another, each
    step rounded on its own (the kernels' order, no fused multiply-add)."""
    sq = torch.zeros((q.shape[0], data.shape[0]), dtype=torch.float32,
                     device=q.device)
    for d in range(q.shape[1]):
        diff = q[:, d : d + 1] - data[None, :, d]
        sq = sq + diff * diff
    return sq


def _lse_rows(a: torch.Tensor) -> torch.Tensor:
    """Row logsumexp [M, N] -> [M], with the JAX kernels' guard
    ``max(mx, -1e30)`` (``kde_pallas.py:63-69``)."""
    mx = torch.clamp(a.max(dim=1, keepdim=True).values, min=-1e30)
    return (mx + torch.log(torch.exp(a - mx).sum(dim=1, keepdim=True)))[:, 0]


def _chunked(fn, m: int, *arrays):
    """``fn`` over ``_CHUNK``-row tiles of the leading axis, concatenated."""
    if m <= _CHUNK:
        return fn(*arrays)
    return torch.cat([fn(*(a[i : i + _CHUNK] for a in arrays))
                      for i in range(0, m, _CHUNK)])


class ReadFlag(NamedTuple):
    """The query rows of a launch whose results the caller reads: launch
    row r is read when ``flag[r // s_loc]`` is nonzero. ``flag`` is a
    float32 [M / s_loc] vector of any stride (a column of a [B, n_nodes]
    mask, read in place)."""

    flag: torch.Tensor
    s_loc: int


def _zero_unread(out: torch.Tensor, read: Optional[ReadFlag]) -> torch.Tensor:
    """``out`` [M, ...] with the rows ``read`` does not read set to 0."""
    if read is None:
        return out
    keep = (read.flag != 0)[:, None].expand(-1, read.s_loc).reshape(-1)
    return torch.where(keep.reshape((-1,) + (1,) * (out.dim() - 1)), out, 0.0)


def kde_root_plain(x, data_x, log_mask, y_scale: float,
                   read: Optional[ReadFlag] = None) -> torch.Tensor:
    """``lse_n(-|x_m - t_n|^2 / 2h^2 + const + log_mask_n)`` -> [M], 0 on
    the rows ``read`` does not read."""
    inv2y, const_y = kernel_consts(x.shape[1], y_scale)

    def tile(xt):
        return _lse_rows(-sq_dist(xt, data_x) * inv2y + const_y
                         + log_mask[None, :])

    return _zero_unread(_chunked(tile, x.shape[0], x), read)


def kde_cond_plain(x, p, data_x, data_p, log_mask, y_scale: float,
                   p_scale: float,
                   read: Optional[ReadFlag] = None) -> torch.Tensor:
    """``lse_n(kp + ky) - lse_n(kp)`` -> [M], any feature counts; 0 on
    the rows ``read`` does not read."""
    inv2y, const_y = kernel_consts(x.shape[1], y_scale)
    inv2p, const_p = kernel_consts(p.shape[1], p_scale)

    def tile(xt, pt):
        ky = -sq_dist(xt, data_x) * inv2y + const_y
        kp = -sq_dist(pt, data_p) * inv2p + const_p + log_mask[None, :]
        return _lse_rows(kp + ky) - _lse_rows(kp)

    return _zero_unread(_chunked(tile, x.shape[0], x, p), read)


def pick_key(gen: torch.Generator, device) -> torch.Tensor:
    """A 64-bit Philox key from ``gen`` as an int64 [2] device tensor (its
    low and high 32-bit words), drawn without a host sync."""
    return torch.randint(0, 1 << 32, (2,), dtype=torch.int64, generator=gen,
                         device=device)


def seed_key(seed: int, device) -> torch.Tensor:
    """The int64 [2] key tensor of a 64-bit seed, written element by
    element; on a CUDA device each write copies a host scalar and waits
    for the stream."""
    wait(device)
    key = torch.empty((2,), dtype=torch.int64, device=device)
    key[0] = int(seed) & 0xFFFFFFFF
    key[1] = (int(seed) >> 32) & 0xFFFFFFFF
    return key


class RowMap(NamedTuple):
    """A launch's rows in the global flat order of their batch: row r is
    ``base + (r // s_loc) * stride + r % s_loc``. One rank of a mesh
    holding particles ``[p0, p0 + s_loc)`` of rows ``[r0, ...)`` of a batch
    of S particles a row has base ``r0 * S + p0`` and stride S."""

    base: int = 0
    s_loc: int = 1
    stride: int = 1

    @staticmethod
    def of(row0: int, particle0: int, s_loc: int, n_particles: int):
        return RowMap(row0 * n_particles + particle0, s_loc, n_particles)


_IDENTITY = RowMap()


def clamped_uniform(bits: torch.Tensor) -> torch.Tensor:
    """The pick's uniform from 32-bit Philox words: ``uniform_from_bits``
    clamped to ``U_MAX``, so it never reaches 1."""
    return torch.clamp(uniform_from_bits(bits), max=U_MAX)


def _key_seed(key: torch.Tensor) -> int:
    k = key.tolist()
    return (int(k[0]) & 0xFFFFFFFF) | ((int(k[1]) & 0xFFFFFFFF) << 32)


def pick_uniforms(key: torch.Tensor, m: int, row0: int = 0,
                  rows: RowMap = _IDENTITY) -> torch.Tensor:
    """The pick kernel's per-row uniforms [m] for query rows ``row0 ..
    row0 + m - 1`` of a launch whose rows ``rows`` maps to their global
    flat rows g: Philox-4x32-10 with the key's two words, counter (g,
    g >> 32, 0, 2), word 0, clamped to ``U_MAX``."""
    i64 = dict(dtype=torch.int64, device=key.device)
    r = torch.arange(row0, row0 + m, **i64)
    g = rows.base + torch.div(r, rows.s_loc, rounding_mode="floor") \
        * rows.stride + r % rows.s_loc
    zero = torch.zeros_like(g)
    word = philox4x32_10(g & 0xFFFFFFFF, g >> 32, zero, zero + 2,
                         _key_seed(key))[0]
    return clamped_uniform(word)


def inverse_cdf_pick(scores: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Index [M] of the first n whose running sum of ``exp(s_n - max s)``
    (float32 terms, summed in float64) exceeds ``u * sum``, per row of
    ``scores`` [M or 1, N]; 0 where every weight is 0."""
    mx = torch.clamp(scores.max(dim=1, keepdim=True).values,
                     min=float(np.finfo(np.float32).min))
    cum = torch.cumsum(torch.exp(scores - mx).double(), dim=1)
    n = cum.shape[1]
    if cum.shape[0] == 1:  # one CDF for every row
        cum = cum[0]
        t = u.double() * cum[-1]
    else:
        t = (u.double() * cum[:, -1])[:, None].contiguous()
    idx = torch.searchsorted(cum, t, right=True).reshape(-1)
    return torch.where(idx >= n, 0, idx)


def kde_pick_plain(key, parents, data_p, data_x, log_mask, p_scale: float,
                   m: int, gumbel: Optional[torch.Tensor] = None,
                   rows: RowMap = _IDENTITY, read: Optional[ReadFlag] = None):
    """Parent-weighted support pick -> picked ``data_x`` rows [m, Dx]: by
    inverse CDF on ``pick_uniforms(key, m, rows=rows)``, or the
    Gumbel-argmax over ``gumbel`` [m, N] when given; 0 on the rows
    ``read`` does not read."""
    root = parents is None or parents.shape[1] == 0
    inv2p, _ = kernel_consts(0 if root else parents.shape[1], p_scale)
    u = pick_uniforms(key, m, rows=rows) if gumbel is None else None

    def tile(r0):
        r1 = min(r0 + _CHUNK, m)
        if root:
            scores = log_mask[None, :]
        else:
            scores = -sq_dist(parents[r0:r1], data_p) * inv2p + log_mask[None, :]
        if gumbel is not None:
            return data_x[torch.argmax(scores + gumbel[r0:r1], dim=1)]
        return data_x[inverse_cdf_pick(scores, u[r0:r1])]

    return _zero_unread(torch.cat([tile(r0) for r0 in range(0, m, _CHUNK)]),
                        read)


def _support(x, data_x, log_mask, what: str):
    """(m, n, dx) after the checks every KDE launch shares."""
    if x.dim() != 2 or data_x.dim() != 2:
        raise ValueError(f"{what}: expected [M, D] queries and [N, D] support")
    m, dx = x.shape
    n = data_x.shape[0]
    if m < 1 or n < 1 or dx < 1:
        raise ValueError(f"{what}: empty input (M={m}, N={n}, D={dx})")
    if m >= 1 << 31 or n >= 1 << 31:
        raise ValueError(f"{what}: M={m} or N={n} passes 2^31")
    check(x, f"{what} x", torch.float32, (m, dx), x.device)
    check(data_x, f"{what} data_x", torch.float32, (n, dx), x.device)
    check(log_mask, f"{what} log_mask", torch.float32, (n,), x.device)
    return m, n, dx


def _read_args(read: Optional[ReadFlag], m: int, device, what: str):
    """(pointer, stride, s_loc) of a launch's read flag; (None, 0, 1)
    without one."""
    if read is None:
        return None, 0, 1
    flag, s_loc = read
    if s_loc < 1 or m % s_loc:
        raise ValueError(f"{what} read: s_loc={s_loc} does not divide M={m}")
    check(flag, f"{what} read", torch.float32, (m // s_loc,), device,
          strided=True)
    return flag.data_ptr(), flag.stride(0), int(s_loc)


def kde_root(x, data_x, log_mask, y_scale: float,
             read: Optional[ReadFlag] = None) -> torch.Tensor:
    """Root KDE log-sum [M] (before ``- log n_eff``), 0 on the rows
    ``read`` does not read. CUDA tensors launch ``vbn_kde_root``; CPU
    tensors run ``kde_root_plain``."""
    if not x.is_cuda:
        return kde_root_plain(x, data_x, log_mask, y_scale, read)
    with annotate("vbn.kernel.kde_root"):
        m, n, dx = _support(x, data_x, log_mask, "kde_root")
        if dx > _DIRECT_D:
            raise ValueError(f"kde_root: Dx={dx} > {_DIRECT_D}")
        sy, cy = direct_consts(dx, y_scale)
        out = torch.empty((m,), dtype=torch.float32, device=x.device)
        launch("kde", "vbn_kde_root", x.data_ptr(), data_x.data_ptr(),
               log_mask.data_ptr(), m, n, dx, float(sy), float(cy),
               *_read_args(read, m, x.device, "kde_root"), out.data_ptr(),
               device=x.device, key="kde_root", flagged=read is not None)
        return out


def _launch_cond(entry: str, x, p, data_x, data_p, log_mask, y_scale,
                 p_scale, wide: bool,
                 read: Optional[ReadFlag] = None) -> torch.Tensor:
    m, n, dx = _support(x, data_x, log_mask, entry)
    if p.dim() != 2 or p.shape[1] < 1:
        raise ValueError(f"{entry}: expected [M, Dp] parents, Dp >= 1")
    dp = p.shape[1]
    check(p, f"{entry} parents", torch.float32, (m, dp), x.device)
    check(data_p, f"{entry} data_p", torch.float32, (n, dp), x.device)
    if not wide and max(dx, dp) > _DIRECT_D:
        raise ValueError(f"{entry}: max(Dx, Dp) = {max(dx, dp)} > "
                         f"{_DIRECT_D}; use kde_cond_wide")
    sy, cy = direct_consts(dx, y_scale)
    sp, cp = direct_consts(dp, p_scale)
    out = torch.empty((m,), dtype=torch.float32, device=x.device)
    if wide:  # its scratch: the support's fragments, records and means
        scratch = torch.empty(
            (load("kde").vbn_kde_cond_wide_scratch(n, dx, dp),),
            dtype=torch.float32, device=x.device)
        extra = [scratch.data_ptr()]
    else:  # the read flag
        extra = list(_read_args(read, m, x.device, entry))
    launch("kde", entry, x.data_ptr(), p.data_ptr(), data_x.data_ptr(),
           data_p.data_ptr(), log_mask.data_ptr(), m, n, dx, dp, float(sy),
           float(sp), float(cy), float(cp), *extra, out.data_ptr(),
           device=x.device, key=entry[len("vbn_"):], flagged=read is not None)
    return out


def kde_cond(x, p, data_x, data_p, log_mask, y_scale: float,
             p_scale: float, read: Optional[ReadFlag] = None) -> torch.Tensor:
    """Conditional KDE log-density [M] for max(Dx, Dp) <= 32, 0 on the
    rows ``read`` does not read. CUDA tensors launch ``vbn_kde_cond``; CPU
    tensors run ``kde_cond_plain``."""
    if not x.is_cuda:
        return kde_cond_plain(x, p, data_x, data_p, log_mask, y_scale, p_scale,
                              read)
    with annotate("vbn.kernel.kde_cond"):
        return _launch_cond("vbn_kde_cond", x, p, data_x, data_p, log_mask,
                            y_scale, p_scale, wide=False, read=read)


def kde_cond_wide(x, p, data_x, data_p, log_mask, y_scale: float,
                  p_scale: float) -> torch.Tensor:
    """Conditional KDE log-density [M] for any feature counts (the
    dispatch sends it those past 32). CUDA tensors launch
    ``vbn_kde_cond_wide``; CPU tensors run ``kde_cond_plain``."""
    if not x.is_cuda:
        return kde_cond_plain(x, p, data_x, data_p, log_mask, y_scale, p_scale)
    with annotate("vbn.kernel.kde_cond_wide"):
        return _launch_cond("vbn_kde_cond_wide", x, p, data_x, data_p,
                            log_mask, y_scale, p_scale, wide=True)


def kde_pick(key, parents, data_p, data_x, log_mask, p_scale: float, m: int,
             gumbel: Optional[torch.Tensor] = None,
             rows: RowMap = _IDENTITY,
             read: Optional[ReadFlag] = None) -> torch.Tensor:
    """Picked ``data_x`` rows [m, Dx] (``parents`` None for a root). CUDA
    tensors launch ``vbn_kde_pick`` (inverse CDF on uniforms from ``key``
    at the rows' global flat rows ``rows``, or the Gumbel-argmax over
    ``gumbel`` when given); CPU tensors run ``kde_pick_plain``. The
    conditional inverse-CDF pick (parents, or a root past
    ``_ROOT_CDF_MAX`` points) gives 0 on the rows ``read`` does not read;
    the root's and the Gumbel pick ignore ``read``."""
    dp = 0 if parents is None else parents.shape[1]
    if gumbel is not None or (dp == 0 and data_x.shape[0] <= _ROOT_CDF_MAX):
        read = None
    if not data_x.is_cuda:
        return kde_pick_plain(key, parents, data_p, data_x, log_mask, p_scale,
                              m, gumbel, rows, read)
    with annotate("vbn.kernel.kde_pick"):
        dev = data_x.device
        if data_x.dim() != 2 or data_x.shape[0] < 1 or data_x.shape[1] < 1:
            raise ValueError(f"kde_pick: bad support {tuple(data_x.shape)}")
        n, dx = data_x.shape
        if m < 1 or m >= 1 << 31:
            raise ValueError(f"kde_pick: M={m} out of range")
        check(data_x, "kde_pick data_x", torch.float32, (n, dx), dev)
        check(log_mask, "kde_pick log_mask", torch.float32, (n,), dev)
        if dp > _DIRECT_D:
            raise ValueError(f"kde_pick: Dp={dp} > {_DIRECT_D}")
        p_ptr = dp_ptr = None
        if dp:
            check(parents, "kde_pick parents", torch.float32, (m, dp), dev)
            check(data_p, "kde_pick data_p", torch.float32, (n, dp), dev)
            p_ptr, dp_ptr = parents.data_ptr(), data_p.data_ptr()
        key_ptr = g_ptr = None
        if gumbel is not None:
            check(gumbel, "kde_pick gumbel", torch.float32, (m, n), dev)
            g_ptr = gumbel.data_ptr()
        else:
            check(key, "kde_pick key", torch.int64, (2,), dev)
            key_ptr = key.data_ptr()
        inv2p, _ = kernel_consts(dp, p_scale)
        out = torch.empty((m, dx), dtype=torch.float32, device=dev)
        launch("kde", "vbn_kde_pick", p_ptr, dp_ptr, data_x.data_ptr(),
               log_mask.data_ptr(), key_ptr, g_ptr, m, n, dp, dx, float(inv2p),
               int(rows.base), int(rows.s_loc), int(rows.stride),
               *_read_args(read, m, dev, "kde_pick"), out.data_ptr(),
               device=dev, key="kde_pick", flagged=read is not None)
        return out
