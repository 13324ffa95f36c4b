"""The KDE CPD in the port, on the CPU, against the JAX package.

- The plain versions of the four KDE kernels (``ops/kde_fused.py``)
  against the JAX Pallas kernels in interpret mode, on the shapes of
  ``tests/test_invariants.py``: root and direct conditional log-densities
  within 1e-4 (both exact float32 forms); the wide conditional within 5e-3,
  the JAX test's own tolerance: its kernel takes the cross terms through a
  bf16x3 GEMM (about 5e-4 from the exact form), where the port subtracts
  directly; picks on the same external Gumbel field exactly.
- The arithmetic of the direct kernels (base-2 lazy-reference logsumexp)
  and of the wide kernel (the expanded distance in 3xTF32 on data centred
  on the support's mean, each k-step's MMAs from zero on the tensor core's
  own rounding (``test_torch_tf32.py``), norms rounded once, the clamp at
  0, the quad's merged states) as numpy float32 models, against the plain
  versions within 1e-4; the wide form without the centring fails that
  check, and chaining the MMAs through their accumulator loses more.
- The port's ``kde_log_prob`` (``ops/kde_kernel.py``: the plain versions
  on the CPU, the chunked form for a root past 32 features) against the
  JAX one (its XLA form on the CPU) at M = 4096 + 123: 1e-4; the chunked
  pick past 32 parent features takes the nearest parent.
- The pick's served route (inverse CDF on one Philox uniform a row):
  deterministic for a key, uniform under a flat mask and the exact
  categorical under parent weights (chi-square within 6 sd of its mean),
  a two-point mask's weights, and the same past one row tile as over the
  whole batch.
- ``KDECPD.fit`` against the JAX fit (arrays and Scott bandwidths equal),
  the subsample past ``max_points``, and a JAX checkpoint loaded by the port
  (arrays, bandwidths, ``_log_prob_flat`` within 1e-4).
- The slice as a whole: both packages serve one JAX-fitted KDE flagship
  (LW both ways, MCM; static and ``dynamic_masks=True``) and the gauss8
  fixture of ``tests/test_kde_accuracy.py``; their draws differ, so the
  posterior moments are held within 4 Monte-Carlo standard errors of each
  other, and the port to that test's KL limits.

Inputs come from numpy seeds and reach both packages as numpy arrays.
"""

import jax
import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch

from benchmarking.gaussian_bn import (
    generate_gaussian_inference_queries,
    random_gaussian,
)
from chip_smoke import chi2_z_merged, far_queries, kde_cond_float64
from vectorizedbayesiannetwork_torch import VBN as TVBN
from vectorizedbayesiannetwork_torch import defaults as tdefaults
from vectorizedbayesiannetwork_torch.config_cast import (
    CPD_SCHEMAS,
    FIT_SCHEMA,
    cast_value,
    coerce_numbers,
)
from vectorizedbayesiannetwork_torch.models.kde import KDECPD as TKDE
from vectorizedbayesiannetwork_torch.ops import kde_fused as kf
from vectorizedbayesiannetwork_torch.ops import kde_kernel as tkk
from vectorizedbayesiannetwork_tpu import VBN as JVBN
from vectorizedbayesiannetwork_tpu import defaults as jdefaults
from vectorizedbayesiannetwork_tpu.models.kde import KDECPD as JKDE
from vectorizedbayesiannetwork_tpu.ops import kde_kernel as jkk
from vectorizedbayesiannetwork_tpu.ops import kde_pallas as jkp

from test_torch_tf32 import mma_tf32, tf32, tf32_split

S = 4096  # particles per query row in the whole-slice checks


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _normal(g, *shape):
    return g.normal(size=shape).astype(np.float32)


def _tail_mask(n, valid, hard=True):
    """0 on the first ``valid`` points, then -1e30 (the JAX tests' hard
    mask) or log(1e-20) (the model's soft one)."""
    lm = np.zeros(n, np.float32)
    lm[valid:] = -1e30 if hard else np.log(np.float32(1e-20))
    return lm


# ---------------------------------------------------------------------------
# plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dx", [1, 2])
def test_root_plain_matches_pallas(dx):
    g = np.random.default_rng(3)
    n, m = 200, 77
    data_x, qx = _normal(g, n, dx), _normal(g, m, dx)
    lm = _tail_mask(n, 160)
    want = jkp.kde_log_prob_root_fused(jnp.asarray(qx), jnp.asarray(data_x),
                                       jnp.asarray(lm), 0.4, interpret=True)
    got = kf.kde_root(_t(qx), _t(data_x), _t(lm), 0.4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-5)


@pytest.mark.parametrize("dx,dp,valid", [(2, 3, 150), (1, 2, 200)])
def test_cond_plain_matches_pallas(dx, dp, valid):
    g = np.random.default_rng(1)
    n, m = 200, 97
    data_p, data_x = _normal(g, n, dp), _normal(g, n, dx)
    qp, qx = _normal(g, m, dp), _normal(g, m, dx)
    lm = _tail_mask(n, valid)
    want = jkp.kde_log_prob_fused(
        jnp.asarray(qx), jnp.asarray(qp), jnp.asarray(data_x),
        jnp.asarray(data_p), jnp.asarray(lm), 0.5, 0.3, interpret=True)
    got = kf.kde_cond(_t(qx), _t(qp), _t(data_x), _t(data_p), _t(lm), 0.5, 0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# the direct kernels' logsumexp form (csrc/kde.cu, kde_direct_kernel), as a
# numpy float32 model, against the plain versions
# ---------------------------------------------------------------------------

_F = np.float32
_TILE = 256  # support points per staged tile
_LSE_MARGIN = _F(32.0)  # 2^32 bounds a term before the reference moves
_GUARD = _F(-1e30)
_GUARD2 = _F(_GUARD * _F(kf.LOG2E))


def _fma(a, b, c):
    """fmaf: the product exact, one rounding to float32."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(_F)


def _lse2_add(ref, s, v, rows):
    """Lse2::add on the ``rows`` selected: move the reference to a term
    that passes it by the margin (rescaling the sum), then add 2^(v - ref)."""
    a = (v - ref).astype(_F)
    move = rows & (a > _LSE_MARGIN)
    s[move] *= np.exp2(-a[move])
    ref[move] = v[move]
    a[move] = 0.0
    s[rows] += np.exp2(a[rows])


def _lse2_value(ref, s, offset):
    out = ((ref + _F(offset) + np.log2(s)) * _F(np.log(2.0))).astype(_F)
    out = np.where(ref == _GUARD2, _GUARD + np.log2(s) * _F(np.log(2.0)), out)
    return np.where(s > 0, out, -np.inf).astype(_F)


def _direct_model(x, data_x, lm, y_scale, p=None, data_p=None, p_scale=None):
    """The direct kernels' arithmetic in numpy float32, row-parallel: base-2
    terms from coordinates scaled by ``direct_consts``, four points at a
    time against lazily moved references, the four sent down the rescaling
    path when their largest exponent passes the margin."""
    cond = p is not None
    m, dx = x.shape
    sy, cy = kf.direct_consts(dx, y_scale)
    q = (x * sy).astype(_F)
    c_stage, c_num = cy, _F(0.0)
    if cond:
        sp, cp = kf.direct_consts(p.shape[1], p_scale)
        r = (p * sp).astype(_F)
        c_stage, c_num = cp, cy
    ref_n, s_n = np.full(m, _GUARD2, _F), np.zeros(m, _F)
    ref_p, s_p = np.full(m, _GUARD2, _F), np.zeros(m, _F)
    with np.errstate(all="ignore"):
        for t0 in range(0, data_x.shape[0], _TILE):
            tn = min(_TILE, data_x.shape[0] - t0)
            tn4 = (tn + 3) & ~3
            X = np.zeros((tn4, dx), _F)
            X[:tn] = data_x[t0:t0 + tn] * sy
            L = np.full(tn4, -np.inf, _F)
            L[:tn] = _fma(lm[t0:t0 + tn], _F(kf.LOG2E), c_stage)
            if cond:
                P = np.zeros((tn4, p.shape[1]), _F)
                P[:tn] = data_p[t0:t0 + tn] * sp
            for j in range(0, tn4, 4):
                kp = np.repeat(L[None, j:j + 4], m, 0)
                if cond:
                    for d in range(P.shape[1]):
                        e = (r[:, d:d + 1] - P[None, j:j + 4, d]).astype(_F)
                        kp = _fma(-e, e, kp)
                an = (kp - ref_n[:, None]).astype(_F)
                ap = (kp - ref_p[:, None]).astype(_F)
                for d in range(dx):
                    e = (q[:, d:d + 1] - X[None, j:j + 4, d]).astype(_F)
                    an = _fma(-e, e, an)
                mx = np.fmax.reduce(an, 1)
                if cond:
                    mx = np.fmax(mx, np.fmax.reduce(ap, 1))
                slow = mx > _LSE_MARGIN
                for k in range(4):
                    if cond:
                        s_p[~slow] += np.exp2(ap[~slow, k])
                    s_n[~slow] += np.exp2(an[~slow, k])
                for k in range(4):
                    sq = np.zeros(m, _F)
                    for d in range(dx):
                        e = (q[:, d] - X[j + k, d]).astype(_F)
                        sq = _fma(e, e, sq)
                    if cond:
                        _lse2_add(ref_p, s_p, kp[:, k], slow)
                    _lse2_add(ref_n, s_n, (kp[:, k] - sq).astype(_F), slow)
        num = _lse2_value(ref_n, s_n, c_num)
        return num - _lse2_value(ref_p, s_p, 0.0) if cond else num


_DIRECT_CASES = ["near", "far", "max_last", "hard_tail", "all_masked",
                 "under_guard", "at_guard"]


def _direct_case(case, dx, dp, g):
    """(x, p, data_x, data_p, log_mask) of one model case on n = 301 points
    (a ragged last tile of 45, padded to 48): queries near the support; 5
    scale units outside it (every term far below 0, the references moved
    many times); the support sorted farthest first (each row's largest
    terms arrive last); a tail at the JAX tests' hard mask -1e30; every
    point masked (-inf), under the guard (-2e30) or at it (-1e30)."""
    n, m = 301, 64
    data_x, data_p = _normal(g, n, dx), _normal(g, n, dp)
    x, p = 1.5 * _normal(g, m, dx), 1.5 * _normal(g, m, dp)
    lm = np.zeros(n, _F)
    if case == "far":
        x, p = x + _F(5.0), p + _F(5.0)
    elif case == "max_last":
        x, p = (0.3 * x + 2.5).astype(_F), (0.3 * p + 2.5).astype(_F)
        order = np.argsort(data_x.sum(1) + data_p.sum(1))
        data_x, data_p = data_x[order], data_p[order]
    elif case == "hard_tail":
        lm = _tail_mask(n, 250)
    else:
        lm[:] = {"all_masked": -np.inf, "under_guard": -2e30,
                 "at_guard": -1e30}.get(case, 0.0)
    return x, p, data_x, data_p, lm


@pytest.mark.parametrize("case", _DIRECT_CASES)
@pytest.mark.parametrize("dx,dp", [(1, 0), (2, 0), (1, 2), (2, 3)])
def test_direct_kernel_lse_form_matches_plain(case, dx, dp):
    """The base-2 lazy-reference logsumexp of vbn_kde_root and vbn_kde_cond,
    modelled in numpy float32, against kde_root_plain and kde_cond_plain
    (the JAX kernels' max-first float32 form) within 1e-4: rows near and
    far from the support, rows whose maximum arrives last, a hard-masked
    tail; a fully masked support gives -inf (the conditional -inf - -inf,
    NaN, on both sides), so does one under the -1e30 guard, and one at the
    guard gives the guard (the conditional 0)."""
    g = np.random.default_rng(7)
    x, p, data_x, data_p, lm = _direct_case(case, dx, max(dp, 1), g)
    if dp == 0:
        got = _direct_model(x, data_x, lm, 0.5)
        want = kf.kde_root_plain(_t(x), _t(data_x), _t(lm), 0.5).numpy()
    else:
        got = _direct_model(x, data_x, lm, 0.5, p, data_p, 0.5)
        want = kf.kde_cond_plain(_t(x), _t(p), _t(data_x), _t(data_p), _t(lm),
                                 0.5, 0.5).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    if case in ("all_masked", "under_guard"):
        assert np.isnan(want).all() if dp else (want == -np.inf).all()
    if case == "at_guard":
        assert (want == 0).all() if dp else (want == _GUARD).all()


def test_direct_consts_are_the_base2_kernel_consts():
    """sqrt(log2 e / 2h^2) squared and log2(e) * const, from kernel_consts'
    float32 values."""
    for d, h in [(1, 0.3), (2, 0.5), (17, 1.7)]:
        inv2, const = kf.kernel_consts(d, h)
        scale, c2 = kf.direct_consts(d, h)
        assert scale.dtype == c2.dtype == np.float32
        np.testing.assert_allclose(np.float64(scale) ** 2,
                                   np.float64(inv2) * kf.LOG2E, rtol=1e-6)
        np.testing.assert_allclose(c2, np.float64(const) * kf.LOG2E,
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# the wide kernel's arithmetic (csrc/kde.cu, kde_wide_kernel), as a numpy
# float32 model, against the plain version
# ---------------------------------------------------------------------------

_WIDE_DIRECT_DX = 2  # targets up to this take direct differences
_WIDE_LIVE_MASK = -30.0  # points the support's mean counts


def _sq_norm(a):
    """Row squared norms of float32 features, summed in double and rounded
    once (the kernel's)."""
    return (a.astype(np.float64) ** 2).sum(1).astype(_F)


def _wide_chains(dx, dp):
    """The kernel's layout and accumulators an n8 tile (``wide_layout``,
    ``wide_chains``): (chains, step). step: the GEMM takes the target
    (more than two target features), and each k-step's MMAs start from
    zero; else the k-steps chain through one accumulator, or two while
    registers allow (W4's shape)."""
    dxd = dx if dx <= _WIDE_DIRECT_DX else 0
    kt = -(-dp // 8) + (0 if dxd else -(-dx // 8))
    ks, chunked = (max(kt, 5), False) if kt <= 6 else (4, True)
    need = 8 * ks + (4 * (dxd - 1) if dxd else 16) + (16 if chunked else 0)
    return (2 if need <= 40 else 1), dxd == 0


def _mma_cross(a, b, chains, step):
    """a @ b.T as the kernel's 3xTF32 mma.sync on the tensor core's own
    rounding (``mma_tf32``): k-steps of 8 features, each operand split
    into TF32 big and small parts. ``step``: each k-step's small.big,
    big.small and big.big from zero, its sum added to a float32
    accumulator (rounded to nearest). Else chained, the tensor core
    truncating against the running sums: with two ``chains`` small.big and
    big.small into one accumulator and big.big into the other, added at
    the end; with one, all three in that order into one."""
    ab, as_ = tf32_split(a)
    bb, bs = tf32_split(b)
    acc = [np.zeros((a.shape[0], b.shape[0]), _F) for _ in range(chains)]
    for k0 in range(0, a.shape[1], 8):
        k = slice(k0, k0 + 8)
        if step:
            s = np.zeros_like(acc[0])
            for x, y in ((as_, bb), (ab, bs), (ab, bb)):
                s = mma_tf32(s, x[:, k], y[:, k])
            acc[0] = (acc[0] + s).astype(_F)
        else:
            for i, x, y in ((chains - 1, as_, bb), (0, ab, bb),
                            (chains - 1, ab, bs)):
                acc[i] = mma_tf32(acc[i], x[:, k], y[:, k])
    return acc[0] if chains == 1 else (acc[0] + acc[1]).astype(_F)


def _wide_model(x, p, data_x, data_p, lm, y_scale, p_scale, centre=True,
                chained=False):
    """The wide kernel's arithmetic in numpy float32: queries and support
    centred on the support's mean over its live points (``centre``) and
    scaled to base 2; the cross terms in 3xTF32 (``_mma_cross``; a wide
    target's k-steps ``chained`` through the accumulator on request); norms
    rounded once from double; -|q - P|^2 = 2 q.P - |P|^2 - |q|^2 clamped at 0; a target of up
    to two features by direct differences. Each row's columns go to the
    four threads of a quad by (n % 8) // 2, two at a time, each with its
    own base-2 lazy references (both rescaled where an exponent passes
    the margin), merged as the quad's shuffles merge them."""
    m, dx = x.shape
    dp = p.shape[1]
    sy, cy = kf.direct_consts(dx, y_scale)
    sp, cp = kf.direct_consts(dp, p_scale)
    live = lm > _WIDE_LIVE_MASK
    live = live if live.any() else np.ones_like(live)

    def centred(q, data, scale):
        mu = data[live].mean(0, dtype=_F) if centre else _F(0.0)
        return (((q - mu).astype(_F) * scale).astype(_F),
                ((data - mu).astype(_F) * scale).astype(_F))

    chains, step = _wide_chains(dx, dp)

    def neg_dist2(q, data):  # -|q - P|^2 in base 2, clamped at 0
        cross = _mma_cross(q, 2 * data, chains, step and not chained)
        return np.minimum((cross - _sq_norm(data)[None, :]
                           - _sq_norm(q)[:, None]).astype(_F), _F(0.0))

    with np.errstate(all="ignore"):
        kp = (neg_dist2(*centred(p, data_p, sp))
              + _fma(lm, _F(kf.LOG2E), cp)[None, :]).astype(_F)
        direct = dx <= _WIDE_DIRECT_DX
        ux = None if direct else neg_dist2(*centred(x, data_x, sy))
        qx, bx = (x * sy).astype(_F), (data_x * sy).astype(_F)
        pad = -data_x.shape[0] % 8
        kp = np.pad(kp, ((0, 0), (0, pad)), constant_values=-np.inf)
        if ux is not None:
            ux = np.pad(ux, ((0, 0), (0, pad)))
        bx = np.pad(bx, ((0, pad), (0, 0)))
        ref_d, s_d = np.full((m, 4), _GUARD2, _F), np.zeros((m, 4), _F)
        ref_n, s_n = np.full((m, 4), _GUARD2, _F), np.zeros((m, 4), _F)
        for c0 in range(0, kp.shape[1], 8):
            k = kp[:, c0:c0 + 8].reshape(m, 4, 2)
            cols = [k[..., c] for c in range(2)]
            vn_abs = []
            for c in range(2):
                v = cols[c]
                if ux is not None:
                    v = (v + ux[:, c0 + c:c0 + 8:2]).astype(_F)
                else:
                    for f in range(dx):
                        e = (qx[:, f:f + 1] - bx[c0 + c:c0 + 8:2, f][None, :]
                             ).astype(_F)
                        v = _fma(-e, e, v)
                vn_abs.append(v)
            vp = [(cols[c] - ref_d).astype(_F) for c in range(2)]
            vn = []
            for c in range(2):
                v = (cols[c] - ref_n).astype(_F)
                if ux is not None:
                    v = (v + ux[:, c0 + c:c0 + 8:2]).astype(_F)
                else:
                    for f in range(dx):
                        e = (qx[:, f:f + 1] - bx[c0 + c:c0 + 8:2, f][None, :]
                             ).astype(_F)
                        v = _fma(-e, e, v)
                vn.append(v)
            slow = np.fmax.reduce(vp + vn) > _LSE_MARGIN
            for c in range(2):
                s_d[~slow] += np.exp2(vp[c][~slow])
                s_n[~slow] += np.exp2(vn[c][~slow])
            for c in range(2):
                _lse2_add(ref_d, s_d, cols[c], slow)
                _lse2_add(ref_n, s_n, vn_abs[c], slow)

        def merge(ref, s):  # shuffles across lanes t ^ 1, then t ^ 2
            for o in (1, 2):
                idx = np.arange(4) ^ o
                r = np.fmax(ref, ref[:, idx])
                s = (s * np.exp2(ref - r) + s[:, idx] * np.exp2(ref[:, idx] - r)
                     ).astype(_F)
                ref = r
            return ref[:, 0], s[:, 0]

        return (_lse2_value(*merge(ref_n, s_n), cy)
                - _lse2_value(*merge(ref_d, s_d), 0.0))


def _wide_case(case, dx, dp, g):
    """(x, p, data_x, data_p, log_mask, y_scale, p_scale) of one wide case
    on N = 2048 points with Scott bandwidths (W4's 40 parent features,
    a target from the parents plus noise): queries near support points
    (a jitter of one bandwidth); the same offset by +20 in every feature;
    a tail at the hard mask -1e30; every point masked (-inf); queries one
    bandwidth off a support point in every feature (``off_support``);
    further off in every target feature, log-densities past 100
    (``far_off_support``, ``chip_smoke.far_queries``)."""
    n, m = 2048, 192
    data_p = _normal(g, n, dp)
    data_x = (data_p[:, :1] + 0.1 * data_p.mean(1, keepdims=True)
              + 0.1 * _normal(g, n, 1))
    if dx > 1:
        data_x = np.concatenate([data_x, _normal(g, n, dx - 1)], 1)
    data_x = data_x.astype(_F)
    rate = float(n) ** (-1.0 / (dx + dp + 4))
    ps = rate * float(np.mean(data_p.std(0)))
    ys = rate * float(np.mean(data_x.std(0)))
    idx = g.integers(0, n, m)
    p = (data_p[idx] + ps * _normal(g, m, dp)).astype(_F)
    x = (data_x[idx] + ys * _normal(g, m, dx)).astype(_F)
    lm = np.zeros(n, _F)
    if case == "offset":
        x, p, data_x, data_p = (a + _F(20.0) for a in (x, p, data_x, data_p))
    elif case == "hard_tail":
        lm[1700:] = -1e30
    elif case == "all_masked":
        lm[:] = -np.inf
    elif case == "off_support":
        p = (data_p[idx] + ps * np.sign(_normal(g, m, dp))).astype(_F)
        x = (data_x[idx] + ys * np.sign(_normal(g, m, dx))).astype(_F)
    elif case == "far_off_support":
        x, p, _ = (a.numpy() for a in far_queries(
            _t(data_x), _t(data_p), torch.as_tensor(idx), ys, ps,
            torch.Generator().manual_seed(int(g.integers(1 << 30))),
            lambda x, p: kde_cond_float64(x, p, _t(data_x), _t(data_p),
                                          _t(lm), ys, ps)))
    return x, p, data_x, data_p, lm, ys, ps


@pytest.mark.parametrize("case", ["near", "offset", "hard_tail", "all_masked",
                                  "off_support", "far_off_support"])
@pytest.mark.parametrize("dx,dp", [(1, 40), (35, 3), (40, 40)])
def test_wide_kernel_tf32_form_matches_plain(case, dx, dp):
    """vbn_kde_cond_wide's 3xTF32 expanded form on centred data, modelled
    in numpy float32 on the tensor core's rounding, against kde_cond_plain
    within 1e-4: W4's shape (Dx = 1 by direct differences, Dp = 40), and
    targets wide enough for the GEMM; near the support, offset by +20 in
    every feature, with a hard-masked tail, fully masked (NaN on both
    sides), one bandwidth off the support in every feature, and far off
    it, where the log-densities pass 100 (both there also against
    float64, printed)."""
    g = np.random.default_rng(17)
    x, p, data_x, data_p, lm, ys, ps = _wide_case(case, dx, dp, g)
    got = _wide_model(x, p, data_x, data_p, lm, ys, ps)
    want = kf.kde_cond_plain(_t(x), _t(p), _t(data_x), _t(data_p), _t(lm),
                             ys, ps).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    if case == "all_masked":
        assert np.isnan(want).all()
    if case == "far_off_support":
        ref = kde_cond_float64(_t(x), _t(p), _t(data_x), _t(data_p), _t(lm),
                               ys, ps).numpy()
        assert np.abs(ref).min() > 100.0
        print(f"far Dx={dx} Dp={dp}: |out| {np.abs(ref).min():.1f}-"
              f"{np.abs(ref).max():.1f}, model vs float64 "
              f"{np.abs(got - ref).max():.2e}, plain vs float64 "
              f"{np.abs(want - ref).max():.2e}")


@pytest.mark.parametrize("dx,dp", [(1, 40), (40, 40)])
def test_wide_kernel_tf32_form_needs_centring(dx, dp):
    """The same form without the centring fails the 1e-4 check on the
    offset case: the norms and the cross term then grow with the offset
    and cancel. So the model test can fail."""
    g = np.random.default_rng(17)
    x, p, data_x, data_p, lm, ys, ps = _wide_case("offset", dx, dp, g)
    want = kf.kde_cond_plain(_t(x), _t(p), _t(data_x), _t(data_p), _t(lm),
                             ys, ps).numpy()
    err = np.abs(_wide_model(x, p, data_x, data_p, lm, ys, ps, centre=False)
                 - want).max()
    assert err > 1e-4


@pytest.mark.parametrize("dx,dp", [(35, 3), (40, 40)])
def test_wide_kernel_chained_mmas_lose_more(dx, dp):
    """Chaining every k-step's MMAs through one accumulator, where the
    tensor core truncates each product against the running cross term,
    lands at least half again as far from float64 as the kernel's
    per-k-step sums, with a wide target off the support."""
    g = np.random.default_rng(17)
    case = _wide_case("off_support", dx, dp, g)
    ref = kde_cond_float64(*(_t(a) for a in case[:5]), *case[5:]).numpy()
    err = [np.abs(_wide_model(*case, chained=c) - ref).max()
           for c in (False, True)]
    assert err[1] > 1.5 * err[0]


def test_tf32_rounding_is_round_to_nearest_away():
    """The model's cvt.rna.tf32.f32: 10 mantissa bits kept, a tie (bit 12
    alone set) rounded away from zero on both signs, big + small within
    2^-22 of the value."""
    one = _F(1.0)
    ulp = _F(2.0 ** -10)
    tie = _F(1.0 + 2.0 ** -11)
    np.testing.assert_array_equal(tf32(np.array([tie, -tie])),
                                  np.array([one + ulp, -(one + ulp)], _F))
    v = np.random.default_rng(3).normal(size=1000).astype(_F)
    big, small = tf32_split(v)
    assert (big.view(np.uint32) & 0x1FFF == 0).all()
    assert (small.view(np.uint32) & 0x1FFF == 0).all()
    assert np.all(np.abs((big.astype(np.float64) + small) - v)
                  <= 2.0 ** -22 * np.abs(v))


def test_wide_plain_matches_pallas():
    g = np.random.default_rng(2)
    n, m, d = 128, 64, jkp._DIRECT_D + 4
    data_p, data_x = _normal(g, n, d), _normal(g, n, 1)
    qp, qx = _normal(g, m, d), _normal(g, m, 1)
    lm = np.zeros(n, np.float32)
    want = jkp.kde_log_prob_fused(
        jnp.asarray(qx), jnp.asarray(qp), jnp.asarray(data_x),
        jnp.asarray(data_p), jnp.asarray(lm), 0.6, 0.8, interpret=True)
    got = kf.kde_cond_wide(_t(qx), _t(qp), _t(data_x), _t(data_p), _t(lm),
                           0.6, 0.8)
    # the JAX kernel's bf16x3 cross terms, not the port, set the tolerance
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-3)
    # the plain version is exact float32: the float64 direct form agrees
    np.testing.assert_allclose(
        got.numpy(), _cond_f64(qx, qp, data_x, data_p, lm, 0.6, 0.8), atol=1e-4)


def _cond_f64(qx, qp, data_x, data_p, lm, hy, hp):
    """The conditional KDE log-density in numpy float64, direct
    differences."""
    def logits(q, t, h):
        sq = ((q.astype(np.float64)[:, None, :] - t[None, :, :]) ** 2).sum(-1)
        return -sq / (2 * h * h) - q.shape[1] * (0.5 * np.log(2 * np.pi) + np.log(h))

    def lse(a):
        mx = a.max(1, keepdims=True)
        return (mx + np.log(np.exp(a - mx).sum(1, keepdims=True)))[:, 0]

    kp = logits(qp, data_p, hp) + lm[None, :]
    return lse(kp + logits(qx, data_x, hy)) - lse(kp)


def _pick_case(case, g, n, m):
    """(parents or None, data_p, log_mask, p_scale) of one pick case."""
    dp = 2 if case == "parents_masked_tail" else 1
    data_p = _normal(g, n, dp)
    if case == "single_valid":
        lm = np.full(n, -1e30, np.float32)
        lm[7] = 0.0
        return None, data_p, lm, 0.5
    if case == "nearest_parent":
        return _normal(g, m, 1), data_p, np.zeros(n, np.float32), 1e-4
    if case == "uniform_root":
        return None, data_p, np.zeros(n, np.float32), 0.5
    return _normal(g, m, 2), data_p, _tail_mask(n, 150, hard=False), 0.4


@pytest.mark.parametrize("case", ["single_valid", "nearest_parent",
                                  "uniform_root", "parents_masked_tail"])
def test_pick_plain_matches_pallas(case):
    g = np.random.default_rng(4)
    n, m = 160, 3000
    data_x = _normal(g, n, 2)
    parents, data_p, lm, p_scale = _pick_case(case, g, n, m)
    gum = np.asarray(jax.random.gumbel(jax.random.PRNGKey(11), (m, n),
                                       jnp.float32))
    want = jkp.kde_sample_picked_fused(
        jax.random.PRNGKey(0), None if parents is None else jnp.asarray(parents),
        jnp.asarray(data_p), jnp.asarray(data_x), jnp.asarray(lm), p_scale, m,
        interpret=True, gumbel=jnp.asarray(gum))
    got = kf.kde_pick(None, None if parents is None else _t(parents),
                      _t(data_p), _t(data_x), _t(lm), p_scale, m,
                      gumbel=_t(gum))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if case == "single_valid":
        np.testing.assert_array_equal(got.numpy(), np.broadcast_to(data_x[7], (m, 2)))
    if case == "nearest_parent":
        nearest = np.argmin(np.abs(parents - data_p[:, 0][None, :]), axis=1)
        assert np.mean(np.all(got.numpy() == data_x[nearest], axis=1)) > 0.99


# ---------------------------------------------------------------------------
# chunked forms, and the pick's Philox mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("root,dx", [(True, 1), (False, 1), (True, 36)],
                         ids=["root", "cond", "root_dx36"])
def test_chunked_forms_match_jax(root, dx):
    """``kde_log_prob`` against the JAX one over more than one row tile:
    the plain versions for D <= 32, the chunked form past 32 features."""
    g = np.random.default_rng(5)
    n, m = 256, 4096 + 123
    data_p, data_x = _normal(g, n, 2), _normal(g, n, dx)
    qp, qx = _normal(g, m, 2), _normal(g, m, dx)
    lm = _tail_mask(n, 200, hard=False)
    want = jkk.kde_log_prob(
        jnp.asarray(qx), None if root else jnp.asarray(qp), jnp.asarray(data_x),
        jnp.asarray(data_p[:, :0] if root else data_p), jnp.asarray(lm),
        0.35, 0.45)
    got = tkk.kde_log_prob(
        _t(qx), None if root else _t(qp), _t(data_x),
        _t(data_p[:, :0] if root else data_p), _t(lm), 0.35, 0.45)
    assert got.shape == (m,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_plain_pick_philox_is_deterministic_and_uniform():
    n, m = 64, 8192
    data_x = torch.arange(n, dtype=torch.float32)[:, None]
    lm = torch.zeros(n)
    key = torch.tensor([0x12345678, 0x9ABCDEF0], dtype=torch.int64)
    a = kf.kde_pick(key, None, torch.zeros((n, 0)), data_x, lm, 0.5, m)
    b = kf.kde_pick(key.clone(), None, torch.zeros((n, 0)), data_x, lm, 0.5, m)
    assert torch.equal(a, b)
    other = kf.kde_pick(torch.tensor([1, 2]), None, torch.zeros((n, 0)),
                        data_x, lm, 0.5, m)
    assert not torch.equal(a, other)
    counts = np.bincount(a[:, 0].long().numpy(), minlength=n)
    chi2 = float(((counts - m / n) ** 2 / (m / n)).sum())
    assert abs(chi2 - (n - 1)) < 6 * np.sqrt(2 * (n - 1)), chi2
    # a row's uniform is the rebuilt Philox stream, row by row
    u = kf.pick_uniforms(key, 5, row0=3)
    assert torch.equal(u, kf.pick_uniforms(key, 8)[3:8])
    assert bool(((u > 0) & (u < 1)).all())


@pytest.mark.parametrize("dp", [0, 2])
def test_plain_pick_tiles_rows_as_one_field(dp):
    """Past one row tile the plain pick reads the rows' own Philox
    uniforms: it equals the inverse-CDF pick over the whole batch."""
    g = np.random.default_rng(12)
    n, m = 96, 4096 + 123
    data_x, data_p = _t(_normal(g, n, 2)), _t(_normal(g, n, dp))
    parents = _t(_normal(g, m, dp)) if dp else None
    lm = _t(_tail_mask(n, 80, hard=False))
    key = torch.tensor([77, 88])
    got = kf.kde_pick(key, parents, data_p, data_x, lm, 0.4, m)
    scores = lm[None, :]
    if dp:
        inv2p, _ = kf.kernel_consts(dp, 0.4)
        scores = -kf.sq_dist(parents, data_p) * inv2p + lm[None, :]
    idx = kf.inverse_cdf_pick(scores, kf.pick_uniforms(key, m))
    assert torch.equal(got, data_x[idx])
    assert int(idx.max()) < 80  # the soft-masked tail is never drawn here


@pytest.mark.parametrize("s_loc", [1 << 8, 200])
@pytest.mark.parametrize("kind", ["root", "cond", "pick", "root_pick"])
def test_read_flag_zeroes_the_unread_rows(kind, s_loc):
    """A read flag (``kde_fused.ReadFlag``, a strided column of a
    [B, n_nodes] mask, as the per-node sweep passes it) on the plain
    versions: the read rows bit for bit those of the call without a flag,
    every other row 0; an all-ones flag is no flag. The root pick takes no
    flag and scores every row. At 200 rows a query row a 256-thread block
    of the kernels straddles query rows."""
    g = np.random.default_rng(21)
    b, n = 7, 300
    m = b * s_loc
    data_x, data_p = _t(_normal(g, n, 2)), _t(_normal(g, n, 3))
    x, p = _t(1.5 * _normal(g, m, 2)), _t(1.5 * _normal(g, m, 3))
    lm = _t(_tail_mask(n, 260, hard=False))
    key, rows = torch.tensor([5, 6]), kf.RowMap.of(3, 0, s_loc, s_loc)
    masks = torch.zeros((b, 4))
    masks[[0, 3, 4], 2] = 1.0

    def run(read):
        if kind == "root":
            return kf.kde_root(x, data_x, lm, 0.3, read=read)
        if kind == "cond":
            return kf.kde_cond(x, p, data_x, data_p, lm, 0.3, 0.4, read=read)
        return kf.kde_pick(key, None if kind == "root_pick" else p, data_p,
                           data_x, lm, 0.4, m, rows=rows, read=read)

    full = run(None)
    got = run(kf.ReadFlag(masks[:, 2], s_loc))
    keep = (masks[:, 2] != 0).repeat_interleave(s_loc)
    assert torch.equal(got[keep], full[keep])
    if kind == "root_pick":
        assert torch.equal(got, full)
    else:
        assert not bool(got[~keep].any()) and bool(full[~keep].any())
    assert torch.equal(run(kf.ReadFlag(torch.ones(b), s_loc)), full)


@pytest.mark.parametrize("root", [True, False], ids=["root", "parents"])
def test_plain_pick_draws_the_exact_categorical(root):
    """2^16 inverse-CDF draws for one parent row against the categorical
    mask_n exp(-|p - P_n|^2 / 2h^2), computed in float64: chi-square
    within 6 sd of its mean."""
    g = np.random.default_rng(21)
    n, m, dp, h = 200, 1 << 16, 2, 0.6
    data_p = _normal(g, n, dp)
    lm = np.zeros(n, np.float32)
    lm[:50] = np.log(0.2)  # a graded mask
    lm[180:] = np.log(np.float32(1e-20))  # a soft-masked tail
    p_row = np.array([[0.3, -0.5]], np.float32)
    logits = lm.astype(np.float64)
    if not root:
        logits = logits - ((p_row.astype(np.float64) - data_p) ** 2).sum(1) / (2 * h * h)
    probs = np.exp(logits - logits.max())
    probs /= probs.sum()
    data_x = torch.arange(n, dtype=torch.float32)[:, None]
    parents = None if root else _t(np.repeat(p_row, m, axis=0))
    got = kf.kde_pick(torch.tensor([3, 4]), parents, _t(data_p), data_x,
                      _t(lm), h, m)
    counts = np.bincount(got[:, 0].long().numpy(), minlength=n).astype(np.float64)
    z = chi2_z_merged(counts, probs)
    assert abs(z) < 6, z


def test_plain_pick_follows_a_conditional_two_point_mask():
    """Two live points at equal parent distance with mask weights 0.75 and
    0.25: the draws follow the mask, and no masked point is drawn."""
    n, m = 40, 20000
    lm = torch.full((n,), float(np.log(np.float32(1e-20))))
    lm[7], lm[31] = float(np.log(0.75)), float(np.log(0.25))
    data_p = torch.zeros((n, 1))
    data_p[7, 0], data_p[31, 0] = 0.5, -0.5
    data_x = torch.arange(n, dtype=torch.float32)[:, None]
    got = kf.kde_pick(torch.tensor([9, 10]), torch.zeros((m, 1)), data_p,
                      data_x, lm, 0.5, m)[:, 0]
    assert set(got.long().tolist()) <= {7, 31}
    frac = float((got == 7).double().mean())
    assert abs(frac - 0.75) < 6 * np.sqrt(0.75 * 0.25 / m), frac


def test_inverse_cdf_pick_edges():
    """The walk's edges: the first point whose running sum exceeds t; zero
    weights never drawn; rows whose weights are all 0 take point 0."""
    scores = torch.tensor([[0.0, 0.0, -1e30, 0.0]])
    u = torch.tensor([1e-7, 0.5, 1.0 - 2.0**-24])
    assert kf.inverse_cdf_pick(scores, u).tolist() == [0, 1, 3]
    rows = torch.tensor([[0.0, -1e30, 0.0], [-np.inf, -np.inf, -np.inf]])
    assert kf.inverse_cdf_pick(rows, torch.tensor([0.6, 0.3])).tolist() == [2, 0]


def test_chunked_pick_past_32_parent_features_takes_the_nearest_parent():
    """``kde_sample_indices``, the pick of a node with Dp > 32 (an inverse
    CDF on one uniform a row), over more than one row tile: at a tiny
    parent bandwidth the nearest support point's parents win."""
    g = np.random.default_rng(13)
    n, m, dp = 64, 4096 + 123, 36
    data_p = _normal(g, n, dp)
    rows = g.integers(0, n, m)
    parents = data_p[rows] + 0.01 * _normal(g, m, dp)
    u = torch.rand((m,), generator=torch.Generator().manual_seed(0))
    idx = tkk.kde_sample_indices(u, _t(parents), _t(data_p), torch.zeros(n),
                                 1e-3, m)
    assert idx.shape == (m,)
    np.testing.assert_array_equal(idx.numpy(), rows)


def test_plain_pick_follows_a_two_point_mask():
    n, m = 50, 20000
    lm = torch.full((n,), float(np.log(np.float32(1e-20))))
    lm[3], lm[40] = float(np.log(0.75)), float(np.log(0.25))
    data_x = torch.arange(n, dtype=torch.float32)[:, None]
    got = kf.kde_pick(torch.tensor([5, 6]), None, torch.zeros((n, 0)), data_x,
                      lm, 0.5, m)[:, 0]
    assert set(got.long().tolist()) <= {3, 40}
    frac = float((got == 3).double().mean())
    assert abs(frac - 0.75) < 6 * np.sqrt(0.75 * 0.25 / m), frac


def test_pick_gumbel_stays_finite_where_the_jax_uniform_reaches_one():
    """The JAX pick kernel's uniform ((bits >> 8) + 0.5) 2^-24
    (``kde_pallas.py:404-406``) rounds to 1.0 in float32 for the top 24-bit
    value, so its Gumbel noise is +inf there and the pick ignores the mask;
    the port's pick uniform is clamped below 1, so its walk never passes
    the last running sum."""
    words = np.array([0xFFFFFFFF, 0xFFFFFE00, 0], np.uint32)
    b24 = jnp.asarray((words >> 8).astype(np.int32))
    u = (b24.astype(jnp.float32) + 0.5) * (1.0 / (1 << 24))
    assert float(u[0]) == 1.0
    assert np.isposinf(np.asarray(-jnp.log(-jnp.log(u)))[0])
    got = kf.clamped_uniform(torch.as_tensor(words.astype(np.int64)))
    assert bool(((got > 0) & (got < 1)).all())
    assert float(got[0]) == float(np.float32(kf.U_MAX))


# ---------------------------------------------------------------------------
# config, fit and checkpoint
# ---------------------------------------------------------------------------


def test_kde_defaults_and_schema_match_the_jax_package():
    schema = CPD_SCHEMAS["kde"]
    got, want = tdefaults.cpd("kde"), jdefaults.cpd("kde")
    for sub in ("fit", "update"):  # PyYAML reads 1e-3 as a string
        assert got.pop(sub) == coerce_numbers(want.pop(sub), FIT_SCHEMA)
    assert got == coerce_numbers(want, schema)
    assert cast_value("scott", "float_or_str") == "scott"
    assert cast_value(" 0.5 ", "float_or_str") == 0.5
    assert cast_value(np.float32(2.0), "float_or_str") == 2.0
    assert cast_value(None, "float_or_str") is None
    with pytest.raises(ValueError):
        cast_value([1.0], "float_or_str", "bandwidth")


@pytest.mark.parametrize("with_parents", [False, True])
def test_fit_matches_jax_fit(with_parents):
    g = np.random.default_rng(6)
    n = 300
    x = _normal(g, n, 1)
    parents = _normal(g, n, 2) * 3.0 if with_parents else None
    din = 2 if with_parents else 0
    kw = dict(bandwidth="scott", max_points=512, min_scale=1e-4)
    jc, tc = JKDE(din, 1, seed=0, **kw), TKDE(din, 1, seed=0, **kw)
    jp = jc.fit({}, jax.random.PRNGKey(0), parents, x)
    tp = tc.fit(tc.init("cpu"), parents, x, device="cpu")
    for k in ("data_p", "data_x", "valid"):
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    assert (tc.bandwidth, tc.parent_bandwidth) == (jc.bandwidth,
                                                   jc.parent_bandwidth)
    assert tc.get_init_kwargs() == jc.get_init_kwargs()


def test_fit_past_max_points_keeps_data_rows():
    g = np.random.default_rng(7)
    n, mp = 700, 256
    x, parents = _normal(g, n, 1), _normal(g, n, 2)
    cpd = TKDE(2, 1, seed=0, max_points=mp)
    gen = torch.Generator().manual_seed(3)
    p = cpd.fit(cpd.init("cpu"), parents, x, device="cpu", gen=gen)
    assert float(p["valid"].sum()) == mp
    rows = {tuple(r) for r in np.concatenate([parents, x], 1).tolist()}
    got = torch.cat([p["data_p"], p["data_x"]], 1).numpy().tolist()
    assert all(tuple(r) in rows for r in got)
    assert len({tuple(r) for r in got}) == mp  # a subset: no repeats
    # the fit's generator chooses the subset
    again = cpd.fit(cpd.init("cpu"), parents, x, device="cpu",
                    gen=torch.Generator().manual_seed(3))
    assert torch.equal(again["data_x"], p["data_x"])


def _flagship_data(n, seed=0):
    g = np.random.default_rng(seed)
    x0, x1 = g.normal(size=n), g.normal(size=n)
    x2 = 0.5 * x0 - 0.2 * x1 + 0.1 * g.normal(size=n)
    return {k: v.astype(np.float32).reshape(-1, 1)
            for k, v in (("x0", x0), ("x1", x1), ("x2", x2))}


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """The 3-node flagship, all KDE (max_points 256 of 600 rows), fitted by
    the JAX package and loaded by the port."""
    g = nx.DiGraph([("x0", "x2"), ("x1", "x2")])
    jv = JVBN(g, seed=0)
    jv.set_learning_method("node_wise", nodes_cpds={
        k: dict(jdefaults.cpd("kde"), max_points=256) for k in ("x0", "x1", "x2")})
    jv.fit(_flagship_data(600))
    path = tmp_path_factory.mktemp("kde_flagship")
    jv.save(str(path))
    return jv, TVBN.load(str(path), device="cpu")


def test_jax_checkpoint_loads_into_the_port(flagship):
    jv, tv = flagship
    for node in ("x0", "x1", "x2"):
        jc, tc = jv.nodes[node], tv.nodes[node]
        assert isinstance(tc, TKDE)
        assert (tc.bandwidth, tc.parent_bandwidth, tc.max_points,
                tc.min_scale) == (jc.bandwidth, jc.parent_bandwidth,
                                  jc.max_points, jc.min_scale)
        for k in ("data_p", "data_x", "valid"):
            np.testing.assert_array_equal(tv.params[node][k].numpy(),
                                          np.asarray(jv.params[node][k]))
    g = np.random.default_rng(8)
    x, par = _normal(g, 500, 1), _normal(g, 500, 2)
    for node, p in (("x0", None), ("x2", par)):
        want = jv.nodes[node]._log_prob_flat(
            jv.params[node], jnp.asarray(x), None if p is None else jnp.asarray(p))
        got = tv.nodes[node]._log_prob_flat(
            tv.params[node], _t(x), None if p is None else _t(p))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------


def _moments(w, x):
    """Self-normalized weighted (mean, std) per row and their standard
    errors (the delta-method variance of a self-normalized estimate)."""
    w = np.nan_to_num(np.asarray(w, np.float64), nan=0.0, posinf=0.0)
    x = np.asarray(x, np.float64)[..., 0]
    wn = w / w.sum(axis=1, keepdims=True)
    mean = (wn * x).sum(1)
    dev2 = (x - mean[:, None]) ** 2
    var = (wn * dev2).sum(1)
    se_mean = np.sqrt((wn**2 * dev2).sum(1))
    se_var = np.sqrt((wn**2 * (dev2 - var[:, None]) ** 2).sum(1))
    std = np.sqrt(var)
    return mean, std, se_mean, se_var / (2 * std)


def _within_4se(a, b):
    for i, label in ((0, "mean"), (1, "std")):
        se = np.sqrt(a[i + 2] ** 2 + b[i + 2] ** 2)
        assert np.all(np.abs(a[i] - b[i]) <= 4 * se), (label, a[i], b[i], se)


_B = 4
_QUERIES = {
    "lw_x2_given_x0": ("likelihood_weighting", "x2", {"x0": np.linspace(-1, 1, _B)}),
    "lw_x0_given_x2": ("likelihood_weighting", "x0", {"x2": np.linspace(-1, 1, _B)}),
    "mcm_x2_given_x0_x1": ("monte_carlo_marginalization", "x2",
                           {"x0": np.linspace(-1, 1, _B),
                            "x1": np.linspace(1, -1, _B)}),
}


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
@pytest.mark.parametrize("name", sorted(_QUERIES))
def test_flagship_moments_match_jax(flagship, name, dynamic):
    jv, tv = flagship
    method, target, ev = _QUERIES[name]
    q = {"target": target,
         "evidence": {k: v.reshape(-1, 1).astype(np.float32) for k, v in ev.items()}}
    out = []
    for v in (jv, tv):
        v.set_inference_method(method, n_samples=S, dynamic_masks=dynamic)
        w, x = v.infer_posterior(q)
        out.append(_moments(np.asarray(w), np.asarray(x)))
    _within_4se(out[1], out[0])
    # the static moments route has no fused kernel for KDE: the stream
    tv.set_inference_method(method, n_samples=S, dynamic_masks=dynamic)
    rows, _ = tv.infer_posterior_moments([q])
    assert rows.shape == (_B, 2) and np.isfinite(rows).all()
    assert tv._last_summary_path == ("fused" if dynamic else "stream")


def _gauss_kl(m1, s1, m2, s2):
    s1, s2 = max(s1, 1e-6), max(s2, 1e-6)
    return float(np.log(s2 / s1) + (s1**2 + (m1 - m2) ** 2) / (2 * s2**2) - 0.5)


@pytest.fixture(scope="module")
def gauss8(tmp_path_factory):
    """The gauss8 fixture of tests/test_kde_accuracy.py, JAX-fitted
    (max_points 1024 of 2048 rows), and the port's load of it."""
    bn = random_gaussian(8, seed=0)
    data = bn.sample(2048, seed=1)
    queries = generate_gaussian_inference_queries(bn, n_queries=24, seed=2)
    g = nx.DiGraph()
    g.add_nodes_from(bn.nodes)
    g.add_edges_from(bn.edges())
    jv = JVBN(g, seed=0)
    jv.set_learning_method("node_wise", nodes_cpds={
        n: dict(jdefaults.cpd("kde"), max_points=1024) for n in bn.nodes})
    jv.fit({k: np.asarray(v, np.float32).reshape(-1, 1) for k, v in data.items()})
    path = tmp_path_factory.mktemp("kde_gauss8")
    jv.save(str(path))
    qd = [{"target": q.target,
           "evidence": {k: np.array([[float(v)]], np.float32)
                        for k, v in q.evidence.items()}} for q in queries]
    return bn, queries, qd, jv, TVBN.load(str(path), device="cpu")


def test_gauss8_port_passes_the_kl_limits(gauss8):
    bn, queries, qd, _jv, tv = gauss8
    tv.set_inference_method("likelihood_weighting", n_samples=2048,
                            dynamic_masks=True)
    mom, spans = tv.infer_posterior_moments(qd, pad_bucket=32)
    kls = [
        _gauss_kl(float(mom[lo][0]), float(mom[lo][1]),
                  *bn.conditional(q.target, q.evidence))
        for q, (lo, _hi, _t) in zip(queries, spans)
        if q.evidence_mode != "off_manifold"
    ]
    assert np.median(kls) < 0.02, np.median(kls)
    assert np.mean(kls) < 0.1, np.mean(kls)


def test_gauss8_moments_match_jax(gauss8):
    bn, queries, qd, jv, tv = gauss8
    stats = []
    for v in (jv, tv):
        v.set_inference_method("likelihood_weighting", n_samples=S,
                               dynamic_masks=True)
        res = v.infer_posterior_many(qd, pad_bucket=32)
        rows = [_moments(np.asarray(w), np.asarray(x)) for w, x in res]
        stats.append(tuple(np.concatenate([r[i] for r in rows]) for i in range(4)))
    _within_4se(stats[1], stats[0])
