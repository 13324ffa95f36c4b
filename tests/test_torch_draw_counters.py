"""The port's row stream: every torch-op draw keyed by (key, particle, row,
node).

Mirrors ``tests/test_invariants.py::test_batched_vs_single_consistency``
on every torch-op route of the port: at one key-stream position
(``_keys.set_state(500)``), row 0 of a batch of two equals a batch of one,
weights within 1e-6 and samples exactly. Then the stream itself
(``core/rng.py``): blocks cut by ``row0`` / ``particle0`` join into the
whole, tag 4 shares no Philox word with the kernels' tags 0-3, and each
CPD's draws from it hold their distribution. Last, the torch-op paths on
a four-rank gloo group with a (1, 4) mesh (``tests/torch_mesh_ranks.py``'s
``trace`` job) return the unmeshed weights and samples bit for bit; the
(2, 2) mesh is ``tests/test_torch_mesh_api.py``'s.
"""

import numpy as np
import pytest
import torch

from torch_mesh_ranks import (
    CHAIN_CASES,
    TRACE_CASES,
    WORLD,
    check_chains,
    load,
    spawn_ranks,
    trace_models,
)
from vectorizedbayesiannetwork_torch import VBN, defaults
from vectorizedbayesiannetwork_torch.core.rng import (
    STREAM_TAG,
    ChunkedDraws,
    Draw,
    RowStream,
    draw_key,
    philox_uniforms,
    stream_values,
    stream_values_many,
    stream_words,
)
from vectorizedbayesiannetwork_torch.inference import _sweep

CPU = torch.device("cpu")
S = 64
EV_X2 = np.array([[0.3], [-0.2]], np.float32)


@pytest.fixture(scope="module")
def models():
    return trace_models()


@pytest.fixture(scope="module")
def amortizer():
    from chip_smoke import flagship_data

    v = VBN([("x0", "x2"), ("x1", "x2")], seed=0, device="cpu")
    v.set_learning_method(
        "amortized",
        nodes_cpds={k: defaults.cpd("linear_gaussian") for k in ("x0", "x1", "x2")},
        epochs=2, batch_size=256, hidden_dims=[16], n_do_sets=1, n_obs_sets=1)
    v.fit({k: a.astype(np.float32).reshape(-1, 1)
           for k, a in flagship_data(300, 0).items()})
    return v


def _x2_query(b):
    return {"target": "x0", "evidence": {"x2": EV_X2[:b]}}


def _asia_query(b):
    return {"target": "dysp", "evidence": {
        "smoke": np.array([[1.0], [0.0]], np.float32)[:b],
        "asia": np.array([[0.0], [1.0]], np.float32)[:b]}}


def _mcm_direct_query(b):
    return {"target": "x2", "evidence": {
        "x0": np.array([[0.3], [-0.4]], np.float32)[:b],
        "x1": np.array([[0.1], [0.6]], np.float32)[:b]}}


def _rbm_query(b):
    return {"target": "x2", "evidence": {"x0": EV_X2[:b]}}


# case -> (model, method, settings, query(b), VBN_DISCRETE_SCAN, route)
CASES = {
    "lw_lg": ("lg", "likelihood_weighting", {}, _x2_query, "never", "per_node"),
    "lw_lg_dynamic": ("lg", "likelihood_weighting", {"dynamic_masks": True},
                      _x2_query, "never", "per_node"),
    "lw_nn": ("nn", "likelihood_weighting", {}, _x2_query, "never", "per_node"),
    "lw_nn_dynamic": ("nn", "likelihood_weighting", {"dynamic_masks": True},
                      _x2_query, "never", "per_node"),
    "lw_asia": ("asia", "likelihood_weighting", {}, _asia_query, "never",
                "per_node"),
    "lw_asia_dynamic": ("asia", "likelihood_weighting", {"dynamic_masks": True},
                        _asia_query, "never", "per_node"),
    "stacked_cat": ("asia", "likelihood_weighting", {}, _asia_query, "always",
                    "discrete"),
    "stacked_cat_dynamic": ("asia", "likelihood_weighting",
                            {"dynamic_masks": True}, _asia_query, "always",
                            "discrete"),
    "stacked_lg": ("lg", "likelihood_weighting", {}, _x2_query, "always",
                   "gaussian"),
    "is": ("lg", "importance_sampling", {}, _x2_query, "never", "per_node"),
    "is_dynamic": ("lg", "importance_sampling", {"dynamic_masks": True},
                   _x2_query, "never", "per_node"),
    "mcm": ("lg", "monte_carlo_marginalization", {}, _rbm_query, "never",
            "per_node"),
    "mcm_dynamic": ("lg", "monte_carlo_marginalization",
                    {"dynamic_masks": True}, _rbm_query, "never", "per_node"),
    "mcm_target_draw": ("nn", "monte_carlo_marginalization", {},
                        _mcm_direct_query, "never", None),
    "ris_systematic": ("lg", "resampled_importance_sampling",
                       {"ess_threshold": 0.99, "resample_method": "systematic"},
                       _x2_query, "never", None),
    "ris_multinomial": ("lg", "resampled_importance_sampling",
                        {"ess_threshold": 0.99,
                         "resample_method": "multinomial"},
                        _x2_query, "never", None),
    "kde": ("kde", "likelihood_weighting", {}, _x2_query, "never", "per_node"),
    "kde_dynamic": ("kde", "likelihood_weighting", {"dynamic_masks": True},
                    _x2_query, "never", "per_node"),
    "lbp": ("lg", "lbp", {}, _x2_query, "never", "per_node"),
    "rbm": ("lg", "rao_blackwellized_marginalization",
            {"n_samples": 64, "n_particles": S}, _rbm_query, "never",
            "per_node"),
}


def _at_500(vbn, call):
    vbn._keys.set_state(500)
    out = call()
    return tuple(np.asarray(t) for t in out) if isinstance(out, tuple) \
        else np.asarray(out)


@pytest.mark.parametrize("case", sorted(CASES))
def test_batched_vs_single_consistency(models, monkeypatch, case):
    """Row 0 of B=2 equals B=1 at the same key-stream position."""
    tag, method, kw, query, scan, route = CASES[case]
    vbn = models[tag]
    monkeypatch.setenv("VBN_DISCRETE_SCAN", scan)
    vbn.set_inference_method(method, **dict({"n_samples": S}, **kw))
    _sweep.ROUTES.clear()
    wb, sb = _at_500(vbn, lambda: vbn.infer_posterior(query(2)))
    ws, ss = _at_500(vbn, lambda: vbn.infer_posterior(query(1)))
    if route is not None:
        assert set(_sweep.ROUTES) == {route}
    if method == "resampled_importance_sampling":
        assert vbn._inference._last_resampled
    if method == "importance_sampling":
        assert not vbn._inference._last_fallback
    assert wb.shape[0] == 2 and ws.shape[0] == 1
    assert np.isfinite(wb).all() and np.isfinite(sb).all()
    np.testing.assert_allclose(wb[0], ws[0], atol=1e-6)
    np.testing.assert_array_equal(sb[0], ss[0])
    assert not np.array_equal(sb[0], sb[1])  # the rows draw apart


def test_batched_vs_single_consistency_ancestral(models):
    vbn = models["lg"]
    vbn.set_sampling_method("ancestral")
    q = {"target": "x2", "evidence": {"x0": EV_X2}}
    big = _at_500(vbn, lambda: vbn.sample(q, n_samples=S))
    one = _at_500(vbn, lambda: vbn.sample(
        {"target": "x2", "evidence": {"x0": EV_X2[:1]}}, n_samples=S))
    np.testing.assert_array_equal(big[0], one[0])


def test_batched_vs_single_consistency_amortized(amortizer):
    vbn = amortizer
    vbn.set_inference_method("amortized", n_samples=S)
    wb, sb = _at_500(vbn, lambda: vbn.infer_posterior(_x2_query(2)))
    ws, ss = _at_500(vbn, lambda: vbn.infer_posterior(_x2_query(1)))
    assert not vbn._inference._last_fallback
    np.testing.assert_allclose(wb[0], ws[0], atol=1e-6)
    np.testing.assert_array_equal(sb[0], ss[0])


# ---------------------------------------------------------------------------
# The chain samplers: draws keyed by (key, chain, row, step)
# ---------------------------------------------------------------------------

EV_3 = np.array([[0.3], [0.9], [-0.5]], np.float32)
CHAIN_SAMPLES = 32


@pytest.fixture(scope="module")
def chain_pair(tmp_path_factory):
    """The chain of ``tests/conftest.py`` with ``linear_gaussian`` CPDs,
    seed 0, fitted by the JAX package and loaded by the port."""
    from conftest import make_chain_df, make_chain_graph
    from vectorizedbayesiannetwork_tpu import VBN as JVBN
    from vectorizedbayesiannetwork_tpu import defaults as jdefaults

    jv = JVBN(make_chain_graph(), seed=0)
    jv.set_learning_method("node_wise", nodes_cpds={
        k: jdefaults.cpd("linear_gaussian") for k in ("x0", "x1", "x2")})
    jv.fit(make_chain_df())
    path = tmp_path_factory.mktemp("chain") / "chain.npz"
    jv.save(str(path))
    return jv, VBN.load(str(path), device="cpu")


def _row0_gap(vbn, name):
    """max |row 0 of B=3 - B=1| of ``name`` at its defaults, both from key
    counter 500 (x0 | x2)."""
    vbn.set_sampling_method(name)
    big = _at_500(vbn, lambda: vbn.sample(
        {"target": "x0", "evidence": {"x2": EV_3}}, n_samples=CHAIN_SAMPLES))
    one = _at_500(vbn, lambda: vbn.sample(
        {"target": "x0", "evidence": {"x2": EV_3[:1]}},
        n_samples=CHAIN_SAMPLES))
    assert big.shape == (3, CHAIN_SAMPLES, 1) and np.isfinite(big).all()
    assert not np.array_equal(big[0], big[1])  # the rows draw apart
    return big, one


@pytest.mark.parametrize("name", ["gibbs", "hmc", "nuts"])
def test_batched_vs_single_consistency_chains(chain_pair, name):
    """Row 0 of B=3 equals B=1 bit for bit on the samples, for the port's
    chain samplers at a fixed step size; the JAX package's HMC and NUTS
    hold it too (its Gibbs draws its hoisted noise flat over B * C * K,
    so a row's noise there moves with B)."""
    jv, tv = chain_pair
    big, one = _row0_gap(tv, name)
    np.testing.assert_array_equal(big[0], one[0])
    if name != "gibbs":
        jbig, jone = _row0_gap(jv, name)
        np.testing.assert_allclose(jbig[0], jone[0], atol=1e-6)


@pytest.mark.parametrize("hoisted", [True, False])
def test_gibbs_routes_draw_the_same_counters(chain_pair, monkeypatch,
                                             hoisted):
    """Gibbs's hoisted noise is what its in-loop route draws, word for
    word: both routes give the same samples bit for bit (and row 0 holds
    on each)."""
    from vectorizedbayesiannetwork_torch.models.linear_gaussian import (
        LinearGaussianCPD,
    )

    _, tv = chain_pair
    tv.set_sampling_method("gibbs")
    q = {"target": "x0", "evidence": {"x2": EV_3}}
    kw = dict(n_samples=48, burn_in=3, n_steps=2, n_chains=4)
    want = _at_500(tv, lambda: tv.sample(q, **kw))
    assert tv._sampling._last_hoisted
    if not hoisted:
        monkeypatch.delattr(LinearGaussianCPD, "_noise_spec")
    got = _at_500(tv, lambda: tv.sample(q, **kw))
    assert tv._sampling._last_hoisted is hoisted
    np.testing.assert_array_equal(got, want)


def test_chain_words_stay_under_2_32_or_raise():
    """Every counter word a chain sampler draws is ``step * width + i``
    below 2^32: the largest fits, one more raises, and so does an index
    outside its step."""
    from vectorizedbayesiannetwork_torch.core.rng import WORD_LIMIT, chain_word

    assert WORD_LIMIT == 1 << 32
    assert chain_word(0, 3, 2) == 2 and chain_word(5, 3, 1) == 16
    top = (1 << 32) // 9 - 1
    assert chain_word(top, 9, 8) == top * 9 + 8 < 1 << 32
    with pytest.raises(ValueError, match="2\\^32"):
        chain_word(top + 1, 9, 8)
    with pytest.raises(ValueError, match="outside a step"):
        chain_word(0, 3, 3)
    # a stream word at the top still draws (the plain version's Philox
    # takes any 32-bit word)
    v = stream_values(7, 1, 4, (1 << 32) - 1, 2)
    assert v.shape == (4, 2) and bool(((v > 0) & (v < 1)).all())


@pytest.mark.parametrize("name,kw", [
    ("gibbs", {"n_samples": 2, "burn_in": (1 << 31)}),
    ("hmc", {"n_samples": 2, "burn_in": (1 << 31)}),
    ("nuts", {"n_samples": 2, "burn_in": (1 << 29), "max_tree_depth": 8}),
])
def test_chain_samplers_raise_before_a_word_passes_2_32(chain_pair, name, kw):
    """A call whose last step's word would pass 2^32 raises before it
    draws anything."""
    _, tv = chain_pair
    tv.set_sampling_method(name)
    with pytest.raises(ValueError, match="2\\^32"):
        tv.sample({"target": "x0", "evidence": {"x2": EV_3[:1]}}, **kw)


# ---------------------------------------------------------------------------
# The stream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("normal,k,at", [(False, 1, 0), (False, 5, 2),
                                         (False, 3, 7), (True, 1, 0),
                                         (True, 3, 4), (True, 2, 6)])
def test_blocks_join_into_the_whole(normal, k, at):
    """A (2 x 2) grid of blocks cut by ``row0`` / ``particle0`` joins into
    the unblocked stream, value for value."""
    draw = Draw(0xDEADBEEF12345, CPU)
    b, s = 4, 24
    whole = RowStream(draw, b, s).values(7, k, at, normal).reshape(b, s, k)
    for r0 in (0, 2):
        for p0 in (0, 12):
            part = RowStream(draw, 2, 12, row0=r0, particle0=p0,
                             n_particles=s, n_rows=b).values(7, k, at, normal)
            assert torch.equal(part.reshape(2, 12, k),
                               whole[r0 : r0 + 2, p0 : p0 + 12])


def test_tag_4_shares_no_word_with_tags_0_to_3():
    """The stream's counters end in 4 | (j << 3), whose low three bits no
    kernel tag (0-3) has; on one key the words of tag 4 and of tags 0-3
    at the same (particle, row, node) differ."""
    for j in (0, 1, 7, 1 << 20):
        assert (STREAM_TAG | (j << 3)) & 7 == 4
    seed, b, s, n = 99, 2, 8, 4
    mine = {int(w) for node in range(n)
            for w in stream_words(seed, b, s, node, 0, 8, CPU).flatten()}
    theirs = set()
    for words, grouped in ((1, False), (2, False), (1, True), (2, True)):
        u = philox_uniforms(seed, b, n, s, words, CPU, grouped=grouped)
        theirs |= {int(x) for x in (u * (1 << 24) - 0.5).round().long().flatten()}
    mine24 = {w >> 8 for w in mine}
    assert len(mine24) > 0.99 * len(mine) and not mine24 & theirs


def test_stream_draws_are_uniform_and_normal():
    draw = Draw(5, CPU)
    u = stream_values(draw.seed, 4, 1 << 14, 3, 2).double()
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    n = u.numel()
    assert abs(float(u.mean()) - 0.5) < 5 * np.sqrt(1 / 12 / n)
    z = stream_values(draw.seed, 4, 1 << 14, 3, 2, normal=True).double()
    assert abs(float(z.mean())) < 5 / np.sqrt(n)
    assert abs(float(z.std()) - 1.0) < 5 * np.sqrt(0.5 / n)
    # the Box-Muller pair of slots (0, 1) is the normal of column 0
    words = stream_words(draw.seed, 4, 1 << 14, 3, 0, 2, CPU)
    u12 = ((words >> 8).float() + 0.5) / (1 << 24)
    want = -torch.sqrt(-2.0 * torch.log(u12[..., 0])) * torch.cos(
        torch.tensor(2 * np.pi, dtype=torch.float32) * (u12[..., 1] - 0.5))
    assert torch.equal(z[:, 0].float(), want.reshape(-1))


# ---------------------------------------------------------------------------
# A list of nodes a launch (stream_values_many) and the chunks drawn ahead
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("normal,k,at", [(False, 1, 0), (False, 1, 3),
                                         (False, 4, 0), (False, 5, 6),
                                         (True, 1, 0), (True, 4, 2)])
@pytest.mark.parametrize("row0,particle0", [(0, 0), (3, 1 << 12)])
def test_stream_values_many_is_the_stacked_per_node_stream(normal, k, at,
                                                           row0, particle0):
    """``stream_values_many`` over a list of nodes (out of order, one
    repeated) equals each node's ``stream_values`` bit for bit, and a
    ``RowStream`` block's ``values_many`` its ``values``."""
    seed, b, s = 0xFEEDFACE12345, 3, 50
    nodes = [9, 2, 40, 2, 0]
    many = stream_values_many(seed, b, s, nodes, k, at=at, normal=normal,
                              row0=row0, particle0=particle0)
    assert many.shape == (len(nodes), b * s, k)
    for g, node in enumerate(nodes):
        assert torch.equal(many[g], stream_values(
            seed, b, s, node, k, at=at, normal=normal, row0=row0,
            particle0=particle0))
    st = RowStream(Draw(seed, CPU), b, s, row0=row0, particle0=particle0)
    assert torch.equal(st.values_many(nodes, k, at, normal), many)
    pre = st.predraw(nodes, [(k, at, normal)])
    assert list(pre) == [draw_key(k, at, normal)]
    assert torch.equal(pre[draw_key(k, at, normal)], many)


@pytest.mark.parametrize("k,normal", [(1, False), (4, False), (1, True)])
def test_chunked_draws_are_each_nodes_own(monkeypatch, k, normal):
    """``ChunkedDraws`` hands node i its own values, chunk after chunk (a
    chunk cut to 3 nodes here), each chunk one ``values_many`` call."""
    from vectorizedbayesiannetwork_torch.core import rng

    st = RowStream(Draw(3, CPU), 2, 40)
    monkeypatch.setattr(rng, "CHUNK_BYTES", 3 * 4 * st.m * k)
    calls = []
    real = RowStream.values_many
    monkeypatch.setattr(RowStream, "values_many", lambda self, *a, **kw: (
        calls.append(list(a[0])), real(self, *a, **kw))[1])
    ahead = ChunkedDraws(st, 8, k, normal)
    assert ahead.chunk == 3
    for i in range(8):
        assert torch.equal(ahead(i), real(st, [i], k, 0, normal)[0])
    assert calls[:3] == [[0, 1, 2], [3, 4, 5], [6, 7]]


@pytest.mark.parametrize("form", ["gumbel", "class_loop", "gaussian"])
def test_stacked_forms_draw_each_nodes_own_values(models, monkeypatch, form):
    """The stacked forms' chunked draws are the per-node draws: the form on
    the row stream equals the form fed each node's own ``stream_values``
    as ``noise``, bit for bit."""
    from vectorizedbayesiannetwork_torch.inference._discrete_sweep import (
        discrete_sweep_trace,
    )
    from vectorizedbayesiannetwork_torch.inference._gaussian_sweep import (
        gaussian_sweep_trace,
    )

    vbn = models["lg" if form == "gaussian" else "asia"]
    query = _x2_query(2) if form == "gaussian" else _asia_query(2)
    from vectorizedbayesiannetwork_torch.core.base import Query
    from vectorizedbayesiannetwork_torch.core.plan import (
        get_plan,
        pack_fixed_values,
    )

    q = Query(target=query["target"], evidence={
        k: np.asarray(v, np.float32) for k, v in query["evidence"].items()})
    plan = get_plan(vbn, q)
    cpds = [vbn.cpd_spec(n) for n in plan.topo_order]
    params = tuple(vbn.params[n] for n in plan.topo_order)
    fixed = torch.as_tensor(pack_fixed_values(q, plan, 2))
    st = RowStream(Draw(21, CPU), 2, S)
    n = plan.n_nodes
    if form == "gaussian":
        noise = torch.stack([st.normal(i).reshape(2, S) for i in range(n)], -1)
        got = gaussian_sweep_trace(plan, cpds, params, st, fixed, S,
                                   weighted=True)
        want = gaussian_sweep_trace(plan, cpds, params, None, fixed, S,
                                    weighted=True, noise=noise)
    else:
        loop = form == "class_loop"
        monkeypatch.setenv("VBN_SCAN_CLASS_LOOP", "always" if loop else "never")
        cmax = max(c.resolved_classes for c in cpds)
        noise = torch.stack([
            st.uniform(i).reshape(2, S) if loop else
            -torch.log(-torch.log(st.uniform(i, cmax).reshape(2, S, cmax)))
            for i in range(n)])
        got = discrete_sweep_trace(plan, cpds, params, st, fixed, S,
                                   weighted=True)
        want = discrete_sweep_trace(plan, cpds, params, st, fixed, S,
                                    weighted=True, noise=noise)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


M = 1 << 15


def _node_draws(cpd, params, parents):
    stream = RowStream(Draw(11, CPU), 1, M)
    return cpd._sample_flat(params, stream.node(2), parents, M)


def test_linear_gaussian_draws_hold_their_distribution(models):
    vbn = models["lg"]
    cpd, params = vbn.cpd_spec("x2"), vbn.params["x2"]
    parents = torch.tensor([[0.3, -0.2]]).expand(M, 2).contiguous()
    x = _node_draws(cpd, params, parents)[:, 0].double()
    loc, scale = cpd.conditional_params(params, parents[:1])
    mu, sd = float(loc[0, 0]), float(scale[0, 0])
    assert abs(float(x.mean()) - mu) < 5 * sd / np.sqrt(M)
    assert abs(float(x.std()) - sd) < 5 * sd * np.sqrt(0.5 / M)


def test_gaussian_nn_draws_hold_their_distribution(models):
    vbn = models["nn"]
    cpd, params = vbn.cpd_spec("x2"), vbn.params["x2"]
    parents = torch.tensor([[0.3, -0.2]]).expand(M, 2).contiguous()
    x = _node_draws(cpd, params, parents)[:, 0].double()
    loc, scale = cpd.conditional_params(params, parents[:1])
    mu, sd = float(loc[0, 0]), float(scale[0, 0])
    assert abs(float(x.mean()) - mu) < 5 * sd / np.sqrt(M)
    assert abs(float(x.std()) - sd) < 5 * sd * np.sqrt(0.5 / M)


@pytest.mark.parametrize("node", ["either", "dysp", "asia"])
def test_table_draws_hold_the_cpt(models, node):
    """Chi-square of the draws against the CPT row: z <= 6."""
    vbn = models["asia"]
    cpd, params = vbn.cpd_spec(node), vbn.params[node]
    k = cpd.input_dim
    parents = torch.ones((M, k)) if k else None
    x = _node_draws(cpd, params, parents)[:, 0].long()
    probs = cpd.categorical_probs(params, parents[:1] if k else None)[0]
    counts = np.bincount(x.numpy(), minlength=probs.shape[0])
    exp = probs.double().numpy() * M
    live = exp > 0
    chi2 = float(((counts[live] - exp[live]) ** 2 / exp[live]).sum())
    dof = int(live.sum()) - 1
    assert abs(chi2 - dof) / np.sqrt(2 * dof) <= 6, (chi2, dof)


# ---------------------------------------------------------------------------
# The (1, 4) mesh: every torch-op path returns the unmeshed stream
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks_1x4(tmp_path_factory):
    d = tmp_path_factory.mktemp("trace_1x4")
    spawn_ranks(d, ["trace", "chains"], n_data=1)
    return d


@pytest.fixture(scope="module")
def traces_1x4(ranks_1x4):
    return [load(ranks_1x4, "trace", r) for r in range(WORLD)]


@pytest.mark.parametrize("case", [c[0] for c in TRACE_CASES])
def test_meshed_equals_unmeshed_on_1x4(traces_1x4, case):
    for got in traces_1x4:
        assert got[f"{case}_sharded"][0] >= 1  # the sweep ran sharded
        for x in ("w", "s"):
            np.testing.assert_array_equal(got[f"{case}_mesh_{x}"],
                                          got[f"{case}_whole_{x}"])
            np.testing.assert_array_equal(got[f"{case}_mesh_{x}"],
                                          traces_1x4[0][f"{case}_mesh_{x}"])


@pytest.mark.parametrize("case", ["is", "nn_lw", "lbp"])
def test_grouped_sweep_meshed_equals_unmeshed_on_1x4(traces_1x4, case):
    """The chain's roots x0, x1 sample as one level group, unmeshed and on
    each rank's block of the (1, 4) mesh; the blocks join into the
    unmeshed stream bit for bit."""
    for got in traces_1x4:
        assert (got[f"{case}_groups"] >= 1).all()
        for x in ("w", "s"):
            np.testing.assert_array_equal(got[f"{case}_mesh_{x}"],
                                          got[f"{case}_whole_{x}"])


@pytest.mark.parametrize("case", [c[0] for c in CHAIN_CASES])
def test_chains_meshed_equal_unmeshed_on_1x4(ranks_1x4, case):
    """Gibbs over tables and LG (both noise routes), HMC and NUTS on the
    LG chain at a fixed and an adapted step: 4 rows of 8 chains, two a
    rank of the (1, 4) mesh, return the unmeshed samples bit for bit on
    every rank; 3 chains do not split and run whole."""
    check_chains([load(ranks_1x4, "chains", r) for r in range(WORLD)], case)
