"""The port's public API under ``VBN.set_mesh``, on a four-rank gloo group.

Mirrors ``tests/test_sharding.py`` and the mesh cases of
``tests/test_sweep_pallas.py``: the sharded paths (LW and MCM on the sweep
kernels, static and ``dynamic_masks``; RIS over the distributed resampler)
hold the JAX tests' limits against exact posteriors, and the path that
runs whole on every rank (``update``), the samplers' chains sharded over
the mesh and the torch-op sweeps sharded over it (IS, the stacked forms, KDE and
neural LW, LBP, RBM, the samplers' ancestral starts) give the unmeshed
answer at the same key counter, bit for bit; the torch-op paths are also
held against the JAX package's 2x2 mesh within Monte-Carlo error. Every
rank must return the same result. The ranks are
``tests/torch_mesh_ranks.py``'s ``api``, ``trace`` and ``chains`` jobs on
a (2, 2) mesh.
"""

import types

import numpy as np
import pytest

from torch_mesh_ranks import (
    CHAIN_CASES,
    TRACE_CASES,
    TRACE_S,
    WORLD,
    check_chains,
    load,
    spawn_ranks,
)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_api")
    spawn_ranks(d, ["api", "trace", "chains"])
    return d


@pytest.fixture(scope="module")
def ranks(run_dir):
    return [load(run_dir, "api", r) for r in range(WORLD)]


@pytest.fixture(scope="module")
def traces(run_dir):
    return [load(run_dir, "trace", r) for r in range(WORLD)]


def test_every_rank_returns_the_whole_result(ranks):
    for other in ranks[1:]:
        assert sorted(other) == sorted(ranks[0])
        for k, v in ranks[0].items():
            if k not in ("bs", "bsd"):  # each rank's own block
                np.testing.assert_array_equal(other[k], v, err_msg=k)


def test_constrain_cuts_this_ranks_block(ranks):
    """Rank (di, pi) of the (2, 2) mesh holds rows block di and particle
    block pi of a [B, S] (or [B, S, D]) tensor."""
    grid = np.arange(4 * 8, dtype=np.float32).reshape(4, 8)
    for r, got in enumerate(ranks):
        di, pi = divmod(r, 2)
        want = grid[2 * di:2 * di + 2, 4 * pi:4 * pi + 4]
        np.testing.assert_array_equal(got["bs"], want)
        np.testing.assert_array_equal(got["bsd"], np.repeat(want[..., None], 3, -1))


def test_lw_pmf_under_mesh_matches_exact(ranks):
    """The JAX limit (``tests/test_sweep_pallas.py:457``): 0.05 of the
    exact posterior, on the fused path."""
    from benchmarking.exact import exact_posterior
    from benchmarking.networks import asia

    got = ranks[0]
    assert bool(got["lw_pmf_path"])
    bn = asia()
    for r in range(4):  # asia_query: smoke = r % 2, asia = (r // 2) % 2
        exact = exact_posterior(bn, "dysp", {"smoke": r % 2, "asia": r // 2 % 2})
        assert abs(got["lw_pmf"][r, 1] - float(exact[1])) < 0.05
    w, s = got["lw_w"], got["lw_s"]
    assert w.shape == (4, 1 << 14) and s.shape == (4, 1 << 14, 1)
    assert np.isfinite(w).all()
    p1 = (w[1] * (s[1, :, 0] > 0.5)).sum() / w[1].sum()
    exact = exact_posterior(bn, "dysp", {"smoke": 1, "asia": 0})
    assert abs(p1 - float(exact[1])) < 0.05


def test_refused_batch_is_served_whole(ranks):
    """B = 3 does not split over 'data': every rank serves it whole, the
    unmeshed answer bit for bit."""
    np.testing.assert_array_equal(ranks[0]["odd_mesh"], ranks[0]["odd_whole"])


def test_dynamic_pmf_under_mesh_matches_exact(ranks):
    got = ranks[0]
    exact = got["dyn_exact"] / got["dyn_exact"].sum(axis=1, keepdims=True)
    assert np.abs(got["dyn_pmf"] - exact).max() < 0.05


def _chain_sd(got):
    b0, v0, b1, v1, w0, w1, b2, v2 = got["chain"]
    return np.sqrt(v2), (b0, v0, b1, v1, w0, w1, b2, v2)


def test_mcm_moments_under_mesh_match_closed_form(ranks):
    """x2 | x0, x1 weighted by its own density: mean w.x + b, std sigma/sqrt 2."""
    from chip_smoke import flagship_query

    got = ranks[0]
    sigma, (_b0, _v0, _b1, _v1, w0, w1, b2, _v2) = _chain_sd(got)
    ev = flagship_query(4)["evidence"]
    mean = w0 * ev["x0"][:, 0] + w1 * ev["x1"][:, 0] + b2
    mom = got["mcm_mom"]
    assert np.abs(mom[:, 0] - mean).max() < 0.05 * sigma
    assert np.abs(mom[:, 1] - sigma / np.sqrt(2.0)).max() < 0.05 * sigma


def test_dynamic_moments_under_mesh_match_exact(ranks):
    got = ranks[0]
    mom, exact = got["dyn_mom"], got["dyn_mom_exact"]
    sd = exact[:, 1]
    assert (np.abs(mom[:, 0] - exact[:, 0]) < 0.1 * sd).all()
    assert (np.abs(mom[:, 1] - sd) < 0.1 * sd).all()


@pytest.mark.parametrize("what", ["is", "ancestral", "gibbs", "hmc", "nuts"])
def test_whole_paths_equal_unmeshed(ranks, what):
    got = ranks[0]
    a, b = got[f"{what}_whole"], got[f"{what}_mesh"]
    assert np.isfinite(a).all()
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("case", [c[0] for c in CHAIN_CASES])
def test_chains_meshed_equal_unmeshed_on_2x2(run_dir, case):
    """The chain samplers sharded over the (2, 2) mesh (rows over 'data',
    chains over 'particle') return the unmeshed samples bit for bit on
    every rank, at a fixed and an adapted step; a batch whose chains do
    not split runs whole."""
    check_chains([load(run_dir, "chains", r) for r in range(WORLD)], case)


def test_update_under_mesh_equals_unmeshed(ranks):
    got = ranks[0]
    keys = [k for k in got if k.startswith("update_whole/")]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(
            got[k.replace("update_whole/", "update_mesh/")], got[k], err_msg=k)


@pytest.mark.parametrize("method", ["systematic", "multinomial"])
def test_ris_under_mesh_within_mc_error(ranks, method):
    """x0 | x2 on the chain: the weighted moments within 5 standard errors
    of the closed form, at the weights' ESS."""
    got = ranks[0]
    w, x = got[f"ris_{method}_w"], got[f"ris_{method}_s"]
    assert w.shape == (2, 1 << 13) and x.shape == (2, 1 << 13)
    assert np.isfinite(w).all() and np.isfinite(x).all()
    assert bool(got[f"ris_{method}_resampled"])
    _sd, (b0, v0, b1, v1, w0, w1, b2, v2) = _chain_sd(got)
    var2 = w0 ** 2 * v0 + w1 ** 2 * v1 + v2
    gain = w0 * v0 / var2
    sd = np.sqrt(v0 - gain * w0 * v0)
    for r, x2 in enumerate((0.6, 0.2)):
        mean = b0 + gain * (x2 - (w0 * b0 + w1 * b1 + b2))
        wn = w[r] / w[r].sum()
        ess = 1.0 / (wn ** 2).sum()
        m = (wn * x[r]).sum()
        s = np.sqrt((wn * (x[r] - m) ** 2).sum())
        assert abs(m - mean) < 5 * sd / np.sqrt(ess)
        assert abs(s - sd) < 5 * sd / np.sqrt(ess) + 0.02 * sd


def test_cache_key_changes_with_set_mesh(ranks):
    """A function built before ``set_mesh`` is not reused after it."""
    assert ranks[0]["cache_sizes"].tolist() == [1, 2]


def test_scaling_efficiency():
    from vectorizedbayesiannetwork_torch.parallel import scaling_efficiency

    small = types.SimpleNamespace(size=lambda: 1, name="small")
    large = types.SimpleNamespace(size=lambda: 4, name="large")
    rate = {"small": 100.0, "large": 360.0}
    rep = scaling_efficiency(lambda m: rate[m.name], small, large)
    assert rep == {"throughput_small": 100.0, "throughput_large": 360.0,
                   "devices_small": 1, "devices_large": 4, "speedup": 3.6,
                   "efficiency": 0.9}


def test_one_rank_group_without_arguments():
    """With no arguments and no RANK / WORLD_SIZE, ``initialize_distributed``
    starts a one-rank group, so ``make_mesh()`` works in a plain script; a
    second call is a no-op."""
    import torch.distributed as dist

    from vectorizedbayesiannetwork_torch.parallel import (
        initialize_distributed,
        make_mesh,
        mesh_signature,
    )

    assert not dist.is_initialized()
    initialize_distributed()
    try:
        initialize_distributed()
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        mesh = make_mesh(device_type="cpu")
        assert mesh_signature(mesh) == (("data", "particle"), (1, 1), (0,))
        with pytest.raises(ValueError, match="not divisible"):
            make_mesh(n_data=2, device_type="cpu")
        with pytest.raises(ValueError, match="needs 2 ranks"):
            make_mesh(n_data=1, n_particle=2, device_type="cpu")
    finally:
        dist.destroy_process_group()
    assert mesh_signature(None) == ()


def test_measure_queries_per_s():
    from chip_smoke import flagship_data
    from vectorizedbayesiannetwork_torch import VBN, defaults
    from vectorizedbayesiannetwork_torch.parallel import measure_queries_per_s

    vbn = VBN([("x0", "x2"), ("x1", "x2")], seed=0, device="cpu")
    vbn.set_learning_method("node_wise", nodes_cpds={
        k: defaults.cpd("linear_gaussian") for k in ("x0", "x1", "x2")})
    vbn.fit(flagship_data(512, 0))
    vbn.set_inference_method("likelihood_weighting", n_samples=1024)
    q = {"target": "x0", "evidence": {"x2": np.zeros((4, 1), np.float32)}}
    assert measure_queries_per_s(vbn, q, n_samples=1024, reps=2) > 0


@pytest.mark.parametrize("case", [c[0] for c in TRACE_CASES])
def test_torch_op_paths_shard_and_equal_unmeshed(traces, case):
    """Each torch-op path ran sharded (a rank swept [N, B/2, S/2]) and every
    rank returns the unmeshed weights and samples bit for bit."""
    for got in traces:
        assert got[f"{case}_sharded"][0] >= 1
        for x in ("w", "s"):
            np.testing.assert_array_equal(got[f"{case}_mesh_{x}"],
                                          got[f"{case}_whole_{x}"])
            np.testing.assert_array_equal(got[f"{case}_mesh_{x}"],
                                          traces[0][f"{case}_mesh_{x}"])


def _weighted_moments(w, x):
    """Per row (mean, sd, ESS) of x [B, S] under weights w [B, S]."""
    w = np.asarray(w, np.float64)
    x = np.asarray(x, np.float64)
    wn = w / w.sum(axis=1, keepdims=True)
    mean = (wn * x).sum(axis=1)
    sd = np.sqrt((wn * (x - mean[:, None]) ** 2).sum(axis=1))
    return mean, sd, 1.0 / (wn ** 2).sum(axis=1)


@pytest.fixture(scope="module")
def jax_traces(run_dir, traces):
    """The JAX package's answers on its 2x2 mesh, from the models the ranks
    fitted and saved, at 16x the ranks' particles."""
    import os

    import jax

    from vectorizedbayesiannetwork_tpu import VBN as JVBN
    from vectorizedbayesiannetwork_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(n_data=2, devices=jax.devices()[:WORLD])
    out = {}
    for case, tag, method, kw, query, scan in TRACE_CASES:
        jv = JVBN.load(str(run_dir / f"trace_{tag}.npz"))
        jv.set_mesh(mesh)
        kw = dict({"n_samples": 16 * TRACE_S}, **kw)
        if "n_particles" in kw:
            kw["n_particles"] *= 16
        jv.set_inference_method(method, **kw)
        prev = os.environ.get("VBN_DISCRETE_SCAN")
        os.environ["VBN_DISCRETE_SCAN"] = scan or "never"
        try:
            w, s = jv.infer_posterior(query)
        finally:
            if prev is None:
                os.environ.pop("VBN_DISCRETE_SCAN")
            else:
                os.environ["VBN_DISCRETE_SCAN"] = prev
        out[case] = (np.asarray(w), np.asarray(s)[..., 0])
    return out


@pytest.mark.parametrize("case", [c[0] for c in TRACE_CASES])
def test_torch_op_paths_match_jax_mesh_within_mc_error(traces, jax_traces,
                                                       case):
    """The port's meshed posterior mean a row within 5 standard errors
    (both sides' sd / sqrt(ESS)) of the JAX package's on its 2x2 mesh."""
    got = traces[0]
    m_t, sd_t, ess_t = _weighted_moments(got[f"{case}_mesh_w"],
                                         got[f"{case}_mesh_s"][..., 0])
    m_j, sd_j, ess_j = _weighted_moments(*jax_traces[case])
    if case == "rbm":  # a grid: its error is the particles'
        ess_t, ess_j = np.full(4, 256.0), np.full(4, 16 * 256.0)
    se = np.sqrt(sd_t ** 2 / ess_t + sd_j ** 2 / ess_j)
    assert (np.abs(m_t - m_j) <= 5 * se + 1e-6).all(), (m_t, m_j, se)
