"""The tensor cores' TF32 arithmetic that ``vbn_kde_cond_wide`` uses
(``csrc/kde.cu``: ``tf32``, ``mma_tf32``), modelled in numpy. The model
of the wide kernel in ``test_torch_kde.py`` is built on it, and
``test_torch_cuda.py`` holds it bit for bit against the card
(``vbn_kde_mma_probe``).

- ``cvt.rna.tf32.f32``: float32 rounded to 10 mantissa bits, ties away
  from zero.
- ``mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32``, one output:
  ``d = c + sum_k a_k b_k``. Each product is exact. The products and ``c``
  are aligned to the largest exponent among them, a product's exponent
  being the sum of its two factors' (its significand lies in [1, 4)); the
  bits of each term below 2^(emax - 25) are dropped, toward zero; the
  aligned terms are summed exactly and the sum is truncated (toward zero)
  to float32. It does not round to nearest.

The CPU tests here pin each of those rules on inputs made by hand.
"""

import numpy as np

_F = np.float32


def tf32(v):
    """cvt.rna.tf32.f32: float32 rounded to 10 mantissa bits, ties away
    from zero (the magnitude's bits rounded half up)."""
    bits = np.ascontiguousarray(v, _F).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(_F)


def tf32_split(v):
    """(big, small): v's TF32 part and the TF32 of the rest, as the wide
    kernel splits each operand for its three passes."""
    big = tf32(v)
    return big, tf32((v - big).astype(_F))


def _exponent(v):
    """floor(log2 |v|) of float64 values (any, for 0: never the largest)."""
    return np.frexp(v)[1].astype(np.float64) - 1.0


def _to_float32_toward_zero(x):
    f = x.astype(_F)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], _F(0.0))
    return f


def mma_tf32(c, a, b):
    """``c + a @ b.T`` as the tensor core's m16n8k8 TF32 MMA gives it, for
    c [..., N] float32 and TF32 operands a [..., K], b [N, K] (K <= 8: one
    MMA's k-step): the products and c aligned to their largest exponent
    (a product's the sum of its factors'), the bits below 2^(emax - 25)
    dropped toward zero, the exact sum truncated to float32."""
    a64 = np.asarray(a, np.float64)[..., None, :]
    b64 = np.asarray(b, np.float64)
    c64 = np.asarray(c, np.float64)
    prod = a64 * b64  # exact: 11 by 11 significant bits
    e_prod = np.where(prod != 0, _exponent(a64) + _exponent(b64), -np.inf)
    e_c = np.where(c64 != 0, _exponent(c64), -np.inf)
    emax = np.maximum(e_prod.max(-1), e_c)
    q = np.exp2(np.where(np.isfinite(emax), emax, 0.0) - 25.0)
    # multiples of q below 2^30 each: their sum is exact in float64
    total = (np.trunc(c64 / q) * q
             + (np.trunc(prod / q[..., None]) * q[..., None]).sum(-1))
    return _to_float32_toward_zero(total)


def _one(c, a_row, b_row):
    """One output of mma_tf32 from lists (the first k features of a row
    of a and of a column of b)."""
    a = np.array([a_row], _F)
    b = np.array([b_row], _F)
    return float(mma_tf32(np.array([[c]], _F), a, b)[0, 0])


def test_mma_model_is_exact_within_the_window():
    """Small integers: every product and the sum fit, the MMA is exact."""
    assert _one(3.0, [1, 2, 3, 4, 5, 6, 7, 8], [1, -1, 2, -2, 3, -3, 4, -4]) \
        == 3.0 + (1 - 2 + 6 - 8 + 15 - 18 + 28 - 32)


def test_mma_model_truncates_the_sum():
    """c = 1 plus 1.5 2^-24 (aligned without loss): round to nearest would
    give 1 + 2^-23, the tensor core's truncation gives 1."""
    s = 2.0 ** -12
    assert _one(1.0, [s], [1.5 * s]) == 1.0


def test_mma_model_drops_bits_below_the_window():
    """c = 1 and eight products of 2^-26, each below 2^(0 - 25): all
    dropped, so 1, where their exact sum 1 + 2^-23 is a float32."""
    s = 2.0 ** -13
    assert _one(1.0, [s] * 8, [s] * 8) == 1.0
    # the same products beside c = 2^-3 fit the window: exact
    assert _one(0.125, [s] * 8, [s] * 8) == 0.125 + 2.0 ** -23


def test_mma_model_aligns_to_the_factors_exponents():
    """1.5 x 1.5 = 2.25 has exponent 1, but the window is set by the
    factors' exponents (0 + 0): with 2.25 - 2.25 + 1.5 2^-24, the last
    product (3 2^-25) is kept whole. Aligned to 2^1 it would lose 2^-25."""
    s = 2.0 ** -12
    assert _one(0.0, [1.5, -1.5, 1.5 * s], [1.5, 1.5, s]) == 1.5 * 2.0 ** -24


def test_mma_model_truncates_toward_zero_on_both_signs():
    """The drop and the final truncation are toward zero: the model is odd
    in its inputs."""
    g = np.random.default_rng(0)
    a = tf32(g.normal(size=(64, 8)).astype(_F))
    b = tf32(g.normal(size=(8, 8)).astype(_F))
    c = (g.normal(size=(64, 8)) * 8).astype(_F)
    np.testing.assert_array_equal(mma_tf32(-c, -a, b), -mma_tf32(c, a, b))
