"""The port's resampling ops against the JAX package's, on the CPU.

The port's wrappers run their kernels' plain versions for CPU tensors
(``ops/scan.py``, ``ops/resample_merge.py``); the JAX functions run their
Pallas kernels in interpret mode, at the JAX tests' own sizes (B=3,
S=2048, D=5; S=1024 and 2^16 for the gate and high-u0 cases). Both sides
get the same inputs, made with numpy, and the same uniforms or Exp(1)
draws.

``vbn_cumsum``'s two-pass grouping (tiles of 8192 entries, their totals
scanned in one fixed order) is modelled in numpy float32 and held against
the plain version: bit for bit on quantized weights, within rtol 1e-5 on
uniform rows of many tiles.

Exactness: the weights are integer multiples of 2^-23 summing to exactly
1, so both packages' ``_norm_cum`` give the same CDF bit for bit whatever
order they sum in, and the merges then agree exactly. Where the two sides
would cumsum unquantized numbers (the multinomial order statistics), the
draws are multiples of 2^-6 below 8 for the same reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from chip_smoke import PROFILES, quantized_profile

from vectorizedbayesiannetwork_torch.ops import resample as tres
from vectorizedbayesiannetwork_torch.ops import resample_merge as tmerge
from vectorizedbayesiannetwork_torch.ops.scan import cumsum_rows
from vectorizedbayesiannetwork_tpu.ops import resample as jres
from vectorizedbayesiannetwork_tpu.ops import resample_pallas as jmerge
from vectorizedbayesiannetwork_tpu.ops.scan_pallas import cumsum_pallas

B, S, D = 3, 2048, 5


def _profile(name: str, s: int = S) -> np.ndarray:
    return quantized_profile(name, B, s)


def _values(seed: int, b=B, s=S, d=D) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(np.float32)


def _u0(key, b=B) -> np.ndarray:
    """The JAX wrappers' own u0 draw for ``key``."""
    return np.asarray(jax.random.uniform(key, (b, 1), jnp.float32))


def _t(a):
    return torch.as_tensor(np.array(a))


# ---------------------------------------------------------------------------
# kernel 5: cumsum
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("monotone", [False, True])
def test_cumsum_plain_equals_pallas_on_quantized_weights(monotone):
    """Multiples of 2^-23 summing to 1: every grouping of the sums is
    exact, so the plain version equals the Pallas doubling tree bit for
    bit (the property norm_cum relies on up to S = 2^20)."""
    w = np.concatenate([_profile(p) for p in PROFILES])
    got = cumsum_rows(_t(w), monotone=monotone).numpy()
    want = np.asarray(cumsum_pallas(jnp.asarray(w), monotone=monotone,
                                    interpret=True))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(3, 2048), (2, 65536)])
@pytest.mark.parametrize("monotone", [False, True])
def test_cumsum_plain_matches_pallas(shape, monotone):
    x = np.random.default_rng(0).uniform(size=shape).astype(np.float32)
    got = cumsum_rows(_t(x), monotone=monotone).numpy()
    want = np.asarray(cumsum_pallas(jnp.asarray(x), monotone=monotone,
                                    interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if monotone:
        assert (np.diff(got, axis=1) >= 0).all()


# vbn_cumsum's grouping (csrc/resample.cu: a reduce-then-scan over tiles of
# 8192 entries), as a numpy float32 model, against the plain version
_CS_TILE = 8192  # entries a tile: 8 entries a thread of 1024


def _shfl_scan(v):
    """Inclusive Hillis-Steele scan over the last axis (32 lanes), float32:
    the warp-shuffle scan of the kernel."""
    lane = np.arange(v.shape[-1])
    for d in (1, 2, 4, 8, 16):
        y = np.concatenate([np.zeros_like(v[..., :d]), v[..., :-d]], -1)
        v = np.where(lane >= d, (v + y).astype(np.float32), v)
    return v


def _tile_scan_model(t):
    """tile_scan on tiles [T, 8192] (zeros past S): each warp's 32 entries
    of each sub-chunk j by shuffles, then warp 0's scan of the 256 warp
    totals (8 a lane in sequence, the lanes by shuffles); returns the local
    inclusive prefix sums [T, 8192] and the tiles' totals [T]."""
    f32 = np.float32
    w = _shfl_scan(t.reshape(-1, 8, 32, 32))  # [tile, j, warp, lane]
    parts = w[..., 31].reshape(-1, 32, 8)  # partial j*32 + warp, 8 a lane
    tex = np.zeros_like(parts)
    run = np.zeros(parts.shape[:2], f32)
    for i in range(8):
        tex[..., i] = run
        run = (run + parts[..., i]).astype(f32)
    incl = _shfl_scan(run)
    excl = np.concatenate([np.zeros_like(incl[:, :1]), incl[:, :-1]], 1)
    pex = (excl[..., None] + tex).astype(f32).reshape(-1, 8, 32, 1)
    return (pex + w).astype(f32).reshape(-1, _CS_TILE), incl[:, 31]


def _cumsum_model(x, monotone):
    """vbn_cumsum's two passes on [B, S] float32: the tiles' local scans,
    their totals scanned in one fixed order (a contiguous run a lane, the
    runs by shuffles, then each run walked from its lane's prefix), the
    outputs fl(e_j + l_i); with ``monotone``, the running max seeded with
    max over j' < j of fl(e_j' + max l_j'). Returns (out, per-row list of
    (e [tiles], locals [tiles, 8192], valid mask))."""
    f32 = np.float32
    b, s = x.shape
    tiles = -(-s // _CS_TILE)
    out = np.empty_like(x)
    parts = []
    for r in range(b):
        t = np.zeros(tiles * _CS_TILE, f32)
        t[:s] = x[r]
        local, total = _tile_scan_model(t.reshape(tiles, _CS_TILE))
        valid = (np.arange(tiles * _CS_TILE) < s).reshape(tiles, _CS_TILE)
        per = -(-tiles // 32)
        runs = np.zeros(32, f32)
        for lane in range(32):
            for j in range(lane * per, min(lane * per + per, tiles)):
                runs[lane] = f32(runs[lane] + total[j])
        incl = _shfl_scan(runs)
        e = np.zeros(tiles, f32)
        for lane in range(32):
            acc = f32(0.0) if lane == 0 else incl[lane - 1]
            for j in range(lane * per, min(lane * per + per, tiles)):
                e[j] = acc
                acc = f32(acc + total[j])
        o = (e[:, None] + local).astype(f32)
        if monotone:
            top = np.where(valid, local, -np.inf).max(1)
            prev = np.maximum.accumulate(
                np.concatenate([[-np.inf], (e + top).astype(f32)[:-1]]))
            o = np.maximum(prev[:, None], np.maximum.accumulate(o, 1))
        out[r] = o.reshape(-1)[:s]
        parts.append((e, local, valid))
    return out, parts


@pytest.mark.parametrize("monotone", [False, True])
def test_cumsum_two_pass_model_equals_plain_on_quantized_weights(monotone):
    """Multiples of 2^-23 summing to 1, rows of 3 tiles and a ragged fourth:
    the two-pass grouping is exact too, so it equals the plain version (and
    torch.cumsum) bit for bit."""
    w = np.concatenate([quantized_profile(p, 1, 3 * _CS_TILE + 77)
                        for p in PROFILES])
    got, _ = _cumsum_model(w, monotone)
    np.testing.assert_array_equal(got, cumsum_rows(_t(w), monotone).numpy())


@pytest.mark.parametrize("shape", [(3, 70000), (2, 33 * _CS_TILE + 5)])
@pytest.mark.parametrize("monotone", [False, True])
def test_cumsum_two_pass_model_matches_plain(shape, monotone):
    """Uniform rows spanning many tiles (past 32 tiles a lane takes a run
    of two), with a ragged last tile: within rtol 1e-5 of the plain
    version; monotone rows nondecreasing, and the carried maximum of each
    tile, fl(e + max l), equal to the largest of its outputs fl(e + l)."""
    x = np.random.default_rng(4).uniform(size=shape).astype(np.float32)
    got, parts = _cumsum_model(x, monotone)
    np.testing.assert_allclose(got, cumsum_rows(_t(x), monotone).numpy(),
                               rtol=1e-5, atol=0)
    if monotone:
        assert (np.diff(got, axis=1) >= 0).all()
    for e, local, valid in parts:
        outs = np.where(valid, (e[:, None] + local).astype(np.float32), -np.inf)
        top = np.where(valid, local, -np.inf).max(1)
        np.testing.assert_array_equal((e + top).astype(np.float32), outs.max(1))


# ---------------------------------------------------------------------------
# kernel 6: the merge's search index
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["dirichlet", "last", "mixed"])
def test_cum_index_plain_equals_prebuild_and_window_pointers(name):
    w = _profile(name)
    cum_j = jmerge._norm_cum(jnp.asarray(w))
    cum = tmerge.norm_cum(_t(w))
    np.testing.assert_array_equal(cum.numpy(), np.asarray(cum_j))
    # systematic tile queries (u_grid) and sorted positions' tile heads
    u0 = _u0(jax.random.PRNGKey(5))
    pos = np.sort(np.random.default_rng(1).uniform(size=(B, S)), axis=1)
    pos = pos.astype(np.float32)
    for q in (tmerge.systematic_positions(_t(u0), S, tmerge.T),
              _t(pos)[:, :: tmerge.T]):
        lasts, ptrs = tmerge.cum_index(cum, q)
        want = jmerge._window_pointers(
            cum_j, jnp.clip(jnp.asarray(q.numpy()), 0.0, jmerge._POS_MAX))
        np.testing.assert_array_equal(ptrs.numpy(), np.asarray(want))
    cum_w, val_w, dd = jmerge._raw_windows(cum_j, jnp.zeros((B, S, 1)))
    blocks = jmerge._prebuild_blocks(cum_w, val_w, dd, True)
    np.testing.assert_array_equal(lasts.numpy(),
                                  np.asarray(blocks[:, :, 7, 0]))


# ---------------------------------------------------------------------------
# kernel 7: systematic resample-gather
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", PROFILES)
def test_systematic_gather_equals_pallas(name):
    w = _profile(name)
    vals = _values(PROFILES.index(name))
    key = jax.random.PRNGKey(42 + PROFILES.index(name))
    want = jmerge.systematic_resample_gather(
        key, jnp.asarray(w), jnp.asarray(vals), interpret=True)
    got = tmerge.systematic_resample_gather(_t(w), _t(vals), u0=_t(_u0(key)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    plain = tmerge.systematic_resample_gather_plain(
        _t(w), _t(vals), u0=_t(_u0(key)))
    np.testing.assert_array_equal(plain.numpy(), got.numpy())


def test_high_u0_equals_pallas_and_picks_a_real_particle():
    """(S-1+u0)/S rounds to 1.0 in float32 for a high u0: the clamp to
    1 - 2^-24 keeps the last position on a real particle
    (tests/test_resample_pallas.py:192-217)."""
    s2 = 1 << 16
    thr = 1.0 - s2 * 2.0**-25
    key = next(
        k for k in (jax.random.fold_in(jax.random.PRNGKey(0), i)
                    for i in range(4096))
        if (_u0(k, 2) >= thr).any()
        and np.float32((s2 - 1 + _u0(k, 2).max()) / s2) >= 1.0
    )
    w = np.full((2, s2), 1.0 / s2, np.float32)
    vals = np.broadcast_to(
        np.arange(1, s2 + 1, dtype=np.float32)[None, :, None], (2, s2, 1))
    want = jmerge.systematic_resample_gather(
        key, jnp.asarray(w), jnp.asarray(vals), interpret=True)
    got = tmerge.systematic_resample_gather(
        _t(w), _t(vals.copy()), u0=_t(_u0(key, 2)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(got.min()) >= 1.0


def test_gate_matches_jax():
    for s, d in [(2048, 5), (100, 5), (2048, 1024), (512, 5), (1024, 3),
                 (1024, 512), (1024, 0), (1536, 1)]:
        assert tmerge.srg_supported(s, d) == jmerge.srg_supported(s, d)


# ---------------------------------------------------------------------------
# kernel 8: sorted-position gather, and multinomial resampling on it
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", PROFILES)
def test_sorted_gather_equals_pallas(name):
    """One shared CDF and position set; boundary positions 0 and 1."""
    w = _profile(name)
    cum = np.asarray(jmerge._norm_cum(jnp.asarray(w)))
    rng = np.random.default_rng(100 + PROFILES.index(name))
    pos = np.sort(rng.uniform(size=(B, S)), axis=1).astype(np.float32)
    pos[:, 0], pos[:, -1] = 0.0, 1.0
    vals = _values(7)
    want = jmerge.sorted_gather(jnp.asarray(cum), jnp.asarray(pos),
                                jnp.asarray(vals), interpret=True)
    got = tmerge.sorted_gather(_t(cum), _t(pos), _t(vals))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tmerge.spg_plain(_t(cum), _t(pos), _t(vals)).numpy(),
        np.asarray(jmerge.sorted_gather_xla(jnp.asarray(cum), jnp.asarray(pos),
                                            jnp.asarray(vals))))


def test_sorted_gather_different_sizes_equals_pallas():
    """S_out != S_in: 1024 picks from a 2048-row support."""
    cum = np.asarray(jmerge._norm_cum(jnp.asarray(_profile("dirichlet"))))
    pos = np.sort(np.random.default_rng(3).uniform(size=(B, 1024)), axis=1)
    pos = pos.astype(np.float32)
    vals = _values(8)
    want = jmerge.sorted_gather(jnp.asarray(cum), jnp.asarray(pos),
                                jnp.asarray(vals), interpret=True)
    got = tmerge.sorted_gather(_t(cum), _t(pos), _t(vals))
    assert got.shape == (B, 1024, D)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["dirichlet", "alternate", "mixed"])
def test_multinomial_gather_with_shared_draws_equals_pallas(name):
    """The JAX wrapper's body (resample_pallas.py:1006-1016) with its Exp(1)
    draws passed in, against the port's ``e`` hook."""
    w = _profile(name)
    vals = _values(9)
    e = np.random.default_rng(11).exponential(size=(B, S + 1))
    e = (np.round(np.minimum(e, 7.9) * 64.0) / 64.0).astype(np.float32)
    c = jnp.cumsum(jnp.asarray(e), axis=1)
    pos = c[:, :S] / jnp.maximum(c[:, -1:], 1e-20)
    want = jmerge.sorted_gather(jmerge._norm_cum(jnp.asarray(w)), pos,
                                jnp.asarray(vals), interpret=True)
    got = tmerge.multinomial_resample_gather(_t(w), _t(vals), e=_t(e))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# kernels 7 and 8 on the card: merge_kernel's schedule, as a numpy model
# ---------------------------------------------------------------------------

_W, _T, _NS, _RUN_MAX, _STAGE_D = 512, 512, 4, 128, 4
# block slots of the card (SMs x blocks an SM) that launch_merge divides the
# tiles by: one tile a run, runs ending inside a row, whole rows (RUN_MAX)
_SLOTS = (1 << 30, 7, 2)
_MERGE_SIZES = (1024, 1536, (1 << 16) + 512)  # 2, 3 and 129 tiles a row


def _merge_run(b, k_tiles, slots):
    """Tiles a run, as launch_merge sizes them: ceil(B K / slots) in
    [1, RUN_MAX]."""
    return min(max(-(-b * k_tiles // slots), 1), _RUN_MAX)


_CG, _C_MAX = 16, 2048  # csrc/resample.cu's run_pointers


def _pointer_model(cum, heads, c_max=_C_MAX):
    """run_pointers (csrc/resample.cu) on numpy: for each position of
    ``heads`` [B, K] (clamped), the window pointer min(#{w : lasts[w] <= u},
    kw - 2) and the CDF entry before its pair, c[p*512 - 1] (-inf at p = 0),
    as the kernel derives them: a coarse sample of the lasts (every g-th,
    g = max(16, ceil(kw / c_max)), whole groups only) searched by bisection
    puts the count in a bracket of g - 1 lasts, counted 15 at a time, the
    largest last <= u kept on the way; a clamped pointer reads its entry.
    Returns (ptrs int32, prev float32), each [B, K]."""
    b, s = cum.shape
    kw = s // _W
    g = max(_CG, -(-kw // c_max))
    lasts = cum[:, _W - 1 :: _W]
    ptrs = np.empty(heads.shape, np.int32)
    prev = np.empty(heads.shape, np.float32)
    for row in range(b):
        coarse = lasts[row, g - 1 : kw // g * g : g]
        for k, u in enumerate(np.clip(heads[row], 0.0, tmerge.POS_MAX)):
            lo, hi = 0, coarse.size
            while lo < hi:
                mid = (lo + hi) // 2
                lo, hi = (mid + 1, hi) if coarse[mid] <= u else (lo, mid)
            last = coarse[lo - 1] if lo > 0 else -np.inf
            w0 = lo * g
            w1 = min(w0 + g - 1, kw)
            count = w0
            for base in range(w0, w1, _CG - 1):
                for lw in lasts[row, base : min(base + _CG - 1, w1)]:
                    if lw <= u:
                        count, last = count + 1, lw
            p = min(count, kw - 2)
            if p < count:
                last = cum[row, p * _W - 1] if p > 0 else -np.inf
            ptrs[row, k], prev[row, k] = p, last
    return ptrs, prev


def _pointer_cdfs(s):
    """[B + 3, S] normalized CDFs (norm_cum) with every hard case of the
    pointer count: the six profiles (all mass last or first, dead
    256-blocks), zero-weight windows in long runs (flat lasts, ties across
    many coarse entries), and one heavy window a row (a jump)."""
    w = np.concatenate([quantized_profile(n, 1, s) for n in PROFILES]
                       + [quantized_profile("dirichlet", 3, s)])
    w[-3, s // 4 : 3 * s // 4] = 0.0  # a run of zero windows mid-row
    w[-2, : s - 2 * _W] = 0.0  # all mass in the last two windows
    w[-1, 5 * _W : 6 * _W] += 1.0  # one window holds half the mass
    return tmerge.norm_cum(_t(w / w.sum(axis=1, keepdims=True))).numpy()


@pytest.mark.parametrize("c_max", [_C_MAX, 4])
@pytest.mark.parametrize("s", [1024, 1536, 1 << 15, (1 << 16) + 512])
def test_pointer_model_equals_cum_index_plain(s, c_max):
    """The merge's in-kernel pointer derivation (coarse sample, bracket,
    clamp) gives cum_index_plain's pointers bit for bit, on tile heads,
    sorted positions and the same out of order, the window lasts themselves
    (ties) and the floats just below them, flat and zero-weight windows,
    and positions at 0 and 1 - 2^-24; its CDF entry before the pair is
    c[p*512 - 1]. c_max = 4 forces brackets of more than 15 lasts
    (g = ceil(kw / 4)), which the card meets past S = 2^24."""
    cum = _pointer_cdfs(s)
    b = cum.shape[0]
    rng = np.random.default_rng(s)
    lasts = cum[:, _W - 1 :: _W]
    ends = np.tile(np.float32([0.0, tmerge.POS_MAX, 1.0, -1.0]), (b, 1))
    u0 = rng.uniform(size=(b, 1)).astype(np.float32)
    sys_heads = tmerge.systematic_positions(_t(u0), s, _T).numpy()
    sorted_pos = np.sort(rng.uniform(size=(b, 300)), axis=1).astype(np.float32)
    for heads in (sys_heads, sorted_pos, rng.permuted(sorted_pos, axis=1),
                  np.concatenate([lasts, ends], 1),
                  np.nextafter(lasts, np.float32(-1.0))):
        ptrs, prev = _pointer_model(cum, heads, c_max)
        want = tmerge.cum_index_plain(_t(cum), _t(heads))[1].numpy()
        np.testing.assert_array_equal(ptrs, want)
        idx = np.maximum(ptrs.astype(np.int64) * _W - 1, 0)
        before = np.where(ptrs > 0, np.take_along_axis(cum, idx, 1), -np.inf)
        np.testing.assert_array_equal(prev, before.astype(np.float32))


def _merge_model(cum, u, values, run):
    """merge_kernel on numpy arrays: ``u`` [B, S_out] the clamped positions.
    Each (row, run) block derives its tiles' window pointers and the CDF
    entries before their pairs from the tiles' first positions
    (``_pointer_model``), and keeps a ring of NS slots (window tag, CDF
    copy, values copy for D <= STAGE_D). A stage writes its slot at once,
    before the tile in use is resolved (the earliest a cp.async can land),
    so a schedule that overwrote the pair in use or read a window it did
    not stage gives wrong outputs; the pair's tags are also asserted. Each
    position resolves from the staged pair by the kernel's branchless
    search, or by the global fallbacks (before the pair: c[p*512 - 1] > u;
    past it: 1024 entries <= u, then the next window unless its last is
    <= u, else a search of the lasts read in place).
    Returns (out [B, S_out, D], counts: positions by route, windows staged,
    windows the runs' pairs cover, pairs loaded after their tile)."""
    b, s = cum.shape
    kw, d = s // _W, values.shape[2]
    k_tiles = u.shape[1] // _T
    ds = d if d <= _STAGE_D else 0
    lasts = cum[:, _W - 1 :: _W]
    ptrs, prevs = _pointer_model(cum, u[:, ::_T])
    out = np.empty((b, u.shape[1], d), np.float32)
    st = dict(stage=0, before=0, past=0, past_far=0, windows=0, cover=0,
              later=0)
    for row in range(b):
        c, v = cum[row], values[row]
        for k0 in range(0, k_tiles, run):
            n = min(run, k_tiles - k0)
            sp = ptrs[row, k0:k0 + n].astype(np.int64)
            prev = prevs[row, k0:k0 + n]
            st["cover"] += len(set(sp.tolist()) | set((sp + 1).tolist()))
            tag = np.full(_NS, -1)
            ring_c = np.full((_NS, _W), np.nan, np.float32)
            ring_v = np.full((_NS, _W, d), np.nan, np.float32)

            def stage(w):
                tag[w % _NS] = w
                ring_c[w % _NS] = c[w * _W:(w + 1) * _W]
                if ds:
                    ring_v[w % _NS] = v[w * _W:(w + 1) * _W]
                st["windows"] += 1

            p = int(sp[0])
            stage(p)
            stage(p + 1)
            for r in range(n):
                k = k0 + r
                pn, later = p, False
                if r + 1 < n:
                    pn = int(sp[r + 1])
                    if p <= pn <= p + _NS - 2:
                        for w in range(max(p + 2, pn), pn + 2):
                            stage(w)
                    else:
                        later = True
                sa, sb = p % _NS, (p + 1) % _NS
                assert tag[sa] == p and tag[sb] == p + 1, "pair not staged"
                pair = np.concatenate([ring_c[sa], ring_c[sb]])
                uu = u[row, k * _T:(k + 1) * _T]
                base = np.where(pair[_W - 1] <= uu, _W, 0)
                i = np.zeros(_T, np.int64)
                step = _W // 2
                while step:
                    i += step * (pair[base + i + step - 1] <= uu)
                    step //= 2
                lo = base + i + (pair[base + i] <= uu)
                before = uu < prev[r]
                past = ~before & (lo == 2 * _W)
                staged = ~before & ~past
                rank = p * _W + lo
                w0 = p * _W
                rank[before] = np.searchsorted(c[:w0], uu[before], "right")
                for j in np.flatnonzero(past):
                    w = p + 2  # the next window, unless its last is <= u
                    if w < kw and lasts[row, w] <= uu[j]:
                        w = p + 3 + np.searchsorted(lasts[row, p + 3:], uu[j],
                                                    "right")
                        st["past_far"] += 1
                    rank[j] = s if w == kw else w * _W + np.searchsorted(
                        c[w * _W:(w + 1) * _W], uu[j], "right")
                anc = np.minimum(rank, s - 1)
                got = v[anc]
                if ds:
                    slot = (p + lo[staged] // _W) % _NS
                    got[staged] = ring_v[slot, lo[staged] % _W]
                out[row, k * _T:(k + 1) * _T] = got
                st["stage"] += int(staged.sum())
                st["before"] += int(before.sum())
                st["past"] += int(past.sum())
                if later:
                    stage(pn)
                    stage(pn + 1)
                    st["later"] += 1
                p = pn
    return out, st


def _model_values(s, d, seed, b=B):
    """Column 0 the particle's index (exact in float32), the rest normal."""
    v = _values(seed, b, s, d)
    v[:, :, 0] = np.arange(s, dtype=np.float32)
    return v


# D = 512 at the two small sizes only: the model copies the values
_MERGE_CASES = [(s, d) for s in _MERGE_SIZES for d in (1, 3, 5, 512)
                if s * d < (1 << 20)]


@pytest.mark.parametrize("s, d", _MERGE_CASES)
@pytest.mark.parametrize("name", PROFILES)
def test_merge_model_equals_plain_systematic(name, s, d):
    """vbn_srg's schedule: every run length, ragged last runs, and S = 1536
    (three tiles a row) give srg_plain's output bit for bit; a run stages
    each window its pairs cover exactly once (systematic pointers never
    move back)."""
    w = quantized_profile(name, B, s)
    u0 = np.random.default_rng(s + d).uniform(size=(B, 1)).astype(np.float32)
    vals = _model_values(s, d, PROFILES.index(name))
    cum = tmerge.norm_cum(_t(w))
    u = tmerge.systematic_positions(_t(u0), s)
    want = tmerge.srg_plain(_t(u0), cum, _t(vals)).numpy()
    for slots in _SLOTS:
        run = _merge_run(B, s // _T, slots)
        got, st = _merge_model(cum.numpy(), u.numpy(), vals, run)
        np.testing.assert_array_equal(got, want)
        assert st["windows"] == st["cover"] and st["before"] == 0


def _sorted_positions(s_out, seed):
    pos = np.sort(np.random.default_rng(seed).uniform(size=(B, s_out)), 1)
    pos = pos.astype(np.float32)
    pos[:, 0], pos[:, -1] = 0.0, 1.0
    return pos


@pytest.mark.parametrize("s", _MERGE_SIZES)
@pytest.mark.parametrize("name", PROFILES)
def test_merge_model_equals_plain_sorted(name, s):
    """vbn_spg's schedule at S_out = S/2 (rounded down to a tile, at least
    one), S and 2S, D = 1 and 5: spg_plain's output bit for bit; sorted
    positions stage each covered window once."""
    w = quantized_profile(name, B, s)
    cum = tmerge.norm_cum(_t(w))
    for s_out in (max(_T, s // 2 // _T * _T), s, 2 * s):
        pos = _sorted_positions(s_out, s_out + PROFILES.index(name))
        u = np.clip(pos, 0.0, tmerge.POS_MAX)
        for d in (1, 5):
            vals = _model_values(s, d, d)
            want = tmerge.spg_plain(cum, _t(pos), _t(vals)).numpy()
            for slots in _SLOTS:
                run = _merge_run(B, s_out // _T, slots)
                got, st = _merge_model(cum.numpy(), u, vals, run)
                np.testing.assert_array_equal(got, want)
                assert st["windows"] == st["cover"]


def test_merge_model_fallbacks_and_pointer_jumps():
    """Positions the pair does not hold: unsorted positions (before the
    pair, and pointers that move back), crowded weights (past the pair),
    and pointers that leap more than two windows (the pair loaded after
    the tile): each route taken, and the output still spg_plain's."""
    s = (1 << 16) + 512
    w = quantized_profile("dirichlet", B, s)
    w[:, 1000:40000] = 0.0  # a dead stretch: pointers leap over it
    w[:, 50000:50008] = 0.05  # crowded: a tile's positions past its pair
    w = w / w.sum(axis=1, keepdims=True)
    cum = tmerge.norm_cum(_t(w))
    pos = _sorted_positions(s, 5)
    pos = np.random.default_rng(6).permuted(pos, axis=1)  # unsorted
    vals = _model_values(s, 3, 7)
    want = tmerge.spg_plain(cum, _t(pos), _t(vals)).numpy()
    got, st = _merge_model(cum.numpy(), np.clip(pos, 0.0, tmerge.POS_MAX),
                           vals, _merge_run(B, s // _T, 7))
    np.testing.assert_array_equal(got, want)
    assert min(st["before"], st["past"], st["later"], st["stage"]) > 0
    assert 0 < st["past_far"] < st["past"]  # both past-the-pair routes
    # sorted positions over the same weights: leaps, no position before
    pos = _sorted_positions(s, 8)
    got, st = _merge_model(cum.numpy(), np.clip(pos, 0.0, tmerge.POS_MAX),
                           vals, _merge_run(B, s // _T, 7))
    np.testing.assert_array_equal(
        got, tmerge.spg_plain(cum, _t(pos), _t(vals)).numpy())
    assert st["later"] > 0 and st["past"] > 0 and st["before"] == 0
    # positions on the window lasts themselves (ties), over the dead stretch
    # whose lasts are equal: past the pair, the next window's last ties
    lasts = cum.numpy()[:, _W - 1 :: _W]
    rng = np.random.default_rng(9)
    pos = np.sort(np.stack([rng.choice(r, s) for r in lasts]), axis=1)
    got, st = _merge_model(cum.numpy(), np.clip(pos, 0.0, tmerge.POS_MAX),
                           vals, _merge_run(B, s // _T, 7))
    np.testing.assert_array_equal(
        got, tmerge.spg_plain(cum, _t(pos), _t(vals)).numpy())
    assert st["past_far"] > 0


# ---------------------------------------------------------------------------
# ops/resample.py: the index forms for the shapes the gate refuses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [512, 2048])
def test_resample_indices_equal_jax(s):
    w = _profile("dirichlet", s)
    key = jax.random.PRNGKey(s)
    want = jres.systematic_resample_indices(key, jnp.asarray(w))
    got = tres.systematic_resample_indices(_t(w), u0=_t(_u0(key)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    u = np.asarray(jax.random.uniform(key, (B, s)))
    want = jres.multinomial_resample_indices(key, jnp.asarray(w))
    got = tres.multinomial_resample_indices(_t(w), u=_t(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    vals = _values(s, s=s)
    np.testing.assert_array_equal(
        tres.gather_particles(_t(vals), got).numpy(),
        np.asarray(jres.gather_particles(jnp.asarray(vals), want)))


def test_norm_cum_keeps_light_particles_that_jax_rounding_drops():
    """The port's one departure (ops/resample_merge.py note): the JAX
    ``_norm_cum`` rounds normalized weights to multiples of 2^-23 up to
    S = 2^20, so a particle weighing under 1/16 of the uniform 1/S gets a
    zero CDF step and is never drawn. Here 30 % of 2^20 particles have
    likelihood ratio 0.02: the JAX CDF gives them no mass at all; the
    port's keeps their share (within 1 %: each float32 step of a CDF near
    1 carries up to an ulp, 6e-8, of rounding)."""
    s = 1 << 20
    light = np.random.default_rng(0).random(s) < 0.3
    w = np.where(light, 0.02, 1.0).astype(np.float32)[None]
    share = float(w[0, light].sum() / w.sum())

    def mass(cum):
        step = np.diff(np.concatenate([[0.0], np.asarray(cum, np.float64)[0]]))
        return float(step[light].sum())

    assert mass(jmerge._norm_cum(jnp.asarray(w))) == 0.0
    assert abs(mass(tmerge.norm_cum(_t(w)).numpy()) - share) < 0.01 * share
