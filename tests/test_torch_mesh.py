"""The port's distributed resampling and data-parallel fit steps against the
JAX package's, on a 2x2 mesh.

The JAX side runs ``ops/resample_distributed.py`` and ``parallel/train.py``
on four of its virtual CPU devices; the port runs its counterparts on a
four-rank gloo group (``tests/torch_mesh_ranks.py``). On weights quantized
to multiples of 2^-23 (``chip_smoke.quantized_profile``) every cumsum is
exact, so with JAX's ``u0`` and Exp(1) draws handed to each rank the
resampled values (which encode their ancestors) must be JAX's bit for bit.
The four cases of ``tests/test_resample_distributed.py`` run on the port's
own draws. The ridge fit must match within 1e-5 and one Adam step of a
``gaussian_nn`` net from the same initial net within 1e-6.
"""

import numpy as np
import pytest

from chip_smoke import quantized_profile
from torch_mesh_ranks import N_DATA, WORLD, load, spawn_ranks

NPART = WORLD // N_DATA
B, D = 4, 3
PROFILES = ["dirichlet", "uniform", "last", "first", "alternate", "mixed"]
# (profile, S): S = 2048 takes the merge's gate a shard, S = 1000 the
# searchsorted fallback
EXACT = [(p, 2048) for p in PROFILES] + [("dirichlet", 1000)]
METHODS = ["systematic", "multinomial"]


def _values(b, s):
    return np.stack([np.tile(np.arange(s, dtype=np.float32), (b, 1)) + 1000 * d
                     for d in range(D)], axis=-1)


def _gamma_case(seed, s=1024):
    rng = np.random.default_rng(seed)
    return rng.gamma(0.3, size=(B, s)).astype(np.float32), _values(B, s)


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """(JAX outputs, every rank's outputs of the 'resample' and 'fit' jobs)."""
    import jax
    import jax.numpy as jnp

    from vectorizedbayesiannetwork_tpu import CPD_REGISTRY
    from vectorizedbayesiannetwork_tpu.ops.resample_distributed import (
        distributed_resample_gather,
    )
    from vectorizedbayesiannetwork_tpu.parallel.mesh import make_mesh
    from vectorizedbayesiannetwork_tpu.parallel.train import (
        gaussian_nn_dp_step,
        linear_gaussian_fit_step,
        shard_rows,
    )
    from vectorizedbayesiannetwork_torch.vbn import _flatten_params

    d = tmp_path_factory.mktemp("mesh")
    mesh = make_mesh(n_data=N_DATA, devices=jax.devices()[:WORLD])
    inputs, expect = {}, {}
    for i, ((prof, s), method) in enumerate(
            [(c, m) for c in EXACT for m in METHODS]):
        case = f"{method}|{prof}|{s}"
        w, vals = quantized_profile(prof, B, s), _values(B, s)
        key = jax.random.PRNGKey(11 + i)
        expect[case] = np.asarray(jax.jit(
            lambda k, wt, v, m=method: distributed_resample_gather(
                k, wt, v, mesh, method=m))(key, jnp.asarray(w),
                                            jnp.asarray(vals)))
        inputs.update({f"{case}:w": w, f"{case}:v": vals,
                       f"{case}:seed": np.asarray(i)})
        b_l, s_l = B // N_DATA, s // NPART
        for di in range(N_DATA):
            row = jax.random.fold_in(key, di)
            inputs[f"{case}:u0_{di}"] = np.asarray(
                jax.random.uniform(row, (b_l, 1), jnp.float32))
            if method == "multinomial":
                inputs[f"{case}:tail_{di}"] = np.asarray(jax.random.exponential(
                    jax.random.fold_in(row, NPART), (b_l,), jnp.float32))
                for pi in range(NPART):
                    inputs[f"{case}:e_{di}{pi}"] = np.asarray(
                        jax.random.exponential(jax.random.fold_in(row, pi),
                                               (b_l, s_l), jnp.float32))
    # the four cases of tests/test_resample_distributed.py, on the port's draws
    w, vals = _gamma_case(0)
    inputs.update({"systematic|own_counts:w": w, "systematic|own_counts:v": vals,
                   "systematic|own_counts:seed": np.asarray(7)})
    w, vals = _gamma_case(1)
    w[:] = 0.001
    w[:, :64] = 1.0
    inputs.update({"multinomial|own_hot:w": w, "multinomial|own_hot:v": vals,
                   "multinomial|own_hot:seed": np.asarray(3)})
    w, vals = _gamma_case(2)
    inputs.update({"systematic|own_rows:w": w, "systematic|own_rows:v": vals,
                   "systematic|own_rows:seed": np.asarray(9)})

    g = np.random.default_rng(0)
    parents = g.normal(size=(1024, 2)).astype(np.float32)
    x = (parents @ np.array([[0.5], [-0.2]], np.float32)
         + 0.05 * g.normal(size=(1024, 1)).astype(np.float32))
    fit = linear_gaussian_fit_step(mesh, *shard_rows(mesh, parents, x))
    expect.update({f"lg:{k}": np.asarray(v) for k, v in fit.items()})
    inputs.update({"lg:parents": parents, "lg:x": x,
                   "rows": np.arange(32, dtype=np.float32).reshape(16, 2)})
    nn_p = g.normal(size=(512, 2)).astype(np.float32)
    nn_x = (nn_p @ np.array([[0.5], [-0.2]], np.float32)).astype(np.float32)
    cpd = CPD_REGISTRY["gaussian_nn"](2, 1, seed=0, hidden_dims=[8])
    net0 = jax.tree_util.tree_map(np.asarray,
                                  cpd.init(jax.random.PRNGKey(0))["net"])
    net1, opt = gaussian_nn_dp_step(mesh, cpd, net0, None,
                                    *shard_rows(mesh, nn_p, nn_x))
    expect.update({f"net1/{k}": v for k, v in _flatten_params(
        jax.tree_util.tree_map(np.asarray, net1)).items()})
    expect["opt_step"] = np.asarray(opt["step"])
    inputs.update({f"net0/{k}": v for k, v in _flatten_params(net0).items()})
    inputs.update({"nn:parents": nn_p, "nn:x": nn_x})
    np.savez(d / "inputs.npz", **inputs)
    spawn_ranks(d, ["resample", "fit"])
    ranks = [{**load(d, "resample", r), **load(d, "fit", r)}
             for r in range(WORLD)]
    return expect, inputs, ranks


def _ancestor_range(inputs, case, s, delta=1e-5):
    """([B, S], [B, S]): the lowest and highest ancestor a multinomial
    position can take when its target mass moves by ``delta``, from JAX's
    Exp(1) draws in float64. The draws' partial sums are not exact in
    float32 (torch's CPU cumsum accumulates in float64, XLA's in float32 in
    another order, ``vbn_cumsum`` by tiles), so a mass near a CDF entry may
    fall on either side of it."""
    cum = np.cumsum(inputs[f"{case}:w"].astype(np.float64), axis=1)
    b_l = B // N_DATA
    lo, hi = [], []
    for di in range(N_DATA):
        e = np.concatenate([inputs[f"{case}:e_{di}{pi}"] for pi in range(NPART)],
                           axis=1).astype(np.float64)
        ec = np.cumsum(e, axis=1)
        q = ec / (ec[:, -1:] + inputs[f"{case}:tail_{di}"][:, None])
        for r in range(b_l):
            c = cum[di * b_l + r]
            lo.append(np.searchsorted(c, q[r] - delta, side="right"))
            hi.append(np.searchsorted(c, q[r] + delta, side="right"))
    return (np.clip(np.stack(lo), 0, s - 1), np.clip(np.stack(hi), 0, s - 1))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("prof,s", EXACT)
def test_ancestors_match_jax_bit_for_bit(mesh_run, prof, s, method):
    """Systematic: every ancestor JAX's. Multinomial: every ancestor JAX's
    where a 1e-5 move of the target mass cannot change it (at least 95 %
    of them), and elsewhere one of those it can take (``_ancestor_range``).
    """
    expect, inputs, ranks = mesh_run
    case = f"{method}|{prof}|{s}"
    want = expect[case]
    keep = np.ones((B, s), bool)
    if method == "multinomial":
        lo, hi = _ancestor_range(inputs, case, s)
        keep = lo == hi
        assert keep.mean() > 0.95
        for anc in [want[..., 0]] + [got[case][..., 0] for got in ranks]:
            assert ((anc >= lo) & (anc <= hi)).all()
    for got in ranks:
        np.testing.assert_array_equal(got[case][keep], want[keep])


def test_supported_gate(mesh_run):
    _e, _i, ranks = mesh_run
    for got in ranks:
        assert got["supported"].tolist() == [True, False, False, False]


def test_systematic_matches_global_counts(mesh_run):
    _e, inputs, ranks = mesh_run
    out = ranks[0]["systematic|own_counts"]
    w = inputs["systematic|own_counts:w"]
    s = w.shape[1]
    assert out.shape == (B, s, D)
    np.testing.assert_allclose(out[..., 1] - 1000, out[..., 0])
    anc = out[..., 0].astype(int)
    for b in range(B):
        counts = np.bincount(anc[b], minlength=s)
        expect = s * w[b] / w[b].sum()
        assert np.max(np.abs(counts - expect)) < 1.0 + 1e-3
        assert counts.sum() == s
    for got in ranks[1:]:
        np.testing.assert_array_equal(got["systematic|own_counts"], out)


def test_multinomial_distribution(mesh_run):
    _e, inputs, ranks = mesh_run
    anc = ranks[0]["multinomial|own_hot"][..., 0].astype(int)
    s = anc.shape[1]
    frac_hot = (anc < 64).mean()
    expect = 64.0 / (64.0 + 0.001 * (s - 64))
    assert abs(frac_hot - expect) < 0.05


def test_rows_independent_across_data_shards(mesh_run):
    _e, _i, ranks = mesh_run
    anc = ranks[0]["systematic|own_rows"][..., 0].astype(int)
    assert not np.array_equal(anc[0], anc[2])


def test_linear_gaussian_fit_step_matches_jax(mesh_run):
    expect, _i, ranks = mesh_run
    for got in ranks:
        for k in ("weight", "bias", "var"):
            np.testing.assert_allclose(got[f"lg:{k}"], expect[f"lg:{k}"],
                                       atol=1e-5, rtol=0)
    np.testing.assert_allclose(ranks[0]["lg:weight"].ravel(), [0.5, -0.2],
                               atol=0.02)


def test_gaussian_nn_dp_step_matches_jax(mesh_run):
    expect, inputs, ranks = mesh_run
    keys = [k for k in expect if k.startswith("net1/")]
    assert keys
    for got in ranks:
        assert sorted(k for k in got if k.startswith("net1/")) == sorted(keys)
        for k in keys:
            np.testing.assert_allclose(got[k], expect[k], atol=1e-6, rtol=0)
        assert float(got["opt_step"]) == float(expect["opt_step"]) == 1.0
    # the step moved the params
    assert not np.allclose(ranks[0]["net1/layers/#0/w"],
                           inputs["net0/layers/#0/w"])


def test_shard_rows_block_order(mesh_run):
    """Rank di * n_particle + pi holds row block di * n_particle + pi, the
    JAX ``P(('data', 'particle'), None)`` order."""
    _e, inputs, ranks = mesh_run
    rows = inputs["rows"]
    n = rows.shape[0] // WORLD
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["rows"], rows[r * n:(r + 1) * n])
