"""The port's stacked-table sweeps against the JAX package's scan forms.

``inference/_discrete_sweep.py`` and ``_gaussian_sweep.py`` of both
packages get the same fitted model (the JAX fit, saved and loaded by the
port) and the same draws: the JAX function draws its own from a key, and
the port is fed those draws through ``noise`` (Gumbel ``[N, B, S, Cmax]``
or the class loop's uniforms ``[N, B, S]``; the Gaussian ``eps [B, S,
N]``). States must be equal exactly (categorical) or within 1e-5
(Gaussian), log-weights and target log-densities within 1e-5 (the
Gaussian ones, sums of up to 24 float32 log-densities that reach -60,
within 1e-5 + 1e-6 of their magnitude: a parent sum rounds in XLA's order
there, in torch's here). Then the
routing (``VBN_DISCRETE_SCAN`` and the 64-node threshold) and the
posteriors of the stacked forms against the exact engines, as
``tests/test_discrete_scan.py`` and ``tests/test_gaussian_scan.py`` hold
the JAX package's.
"""

import networkx as nx
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from benchmarking.bif import DiscreteBN
from benchmarking.data_gen import generate_dataset
from benchmarking.exact import exact_posterior
from benchmarking.gaussian_bn import random_gaussian
from benchmarking.networks import random_bn, random_bn_treewidth
from vectorizedbayesiannetwork_torch import VBN as TVBN
from vectorizedbayesiannetwork_torch import defaults as tdefaults
from vectorizedbayesiannetwork_torch.core.base import Query as TQuery
from vectorizedbayesiannetwork_torch.core.plan import get_plan as t_get_plan
from vectorizedbayesiannetwork_torch.core.rng import Draw
from vectorizedbayesiannetwork_torch.inference import _discrete_sweep as tds
from vectorizedbayesiannetwork_torch.inference import _dynamic_sweep as tdyn
from vectorizedbayesiannetwork_torch.inference import _gaussian_sweep as tgs
from vectorizedbayesiannetwork_torch.inference import _sweep as tsw
from vectorizedbayesiannetwork_tpu import VBN as JVBN
from vectorizedbayesiannetwork_tpu import defaults as jdefaults
from vectorizedbayesiannetwork_tpu.core.base import Query as JQuery
from vectorizedbayesiannetwork_tpu.core.plan import get_plan as j_get_plan
from vectorizedbayesiannetwork_tpu.inference import _discrete_sweep as jds
from vectorizedbayesiannetwork_tpu.inference import _gaussian_sweep as jgs

B, S = 2, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph(bn):
    g = nx.DiGraph()
    g.add_nodes_from(bn.nodes)
    g.add_edges_from(bn.edges())
    return g


def _cat_conf(bn, defaults):
    conf = {}
    for node in bn.nodes:
        c = dict(defaults.cpd("categorical_table"), n_classes=bn.card(node))
        if bn.parents[node]:
            c["parent_n_classes"] = [bn.card(p) for p in bn.parents[node]]
        conf[node] = c
    return conf


def _loaded(jv, tmp_path):
    jv.save(str(tmp_path))
    return TVBN.load(str(tmp_path), device="cpu")


def _jax_cat(bn, tmp_path, seed=0):
    jv = JVBN(_graph(bn), seed=seed)
    jv.set_learning_method("node_wise", nodes_cpds=_cat_conf(bn, jdefaults))
    data = generate_dataset(bn, 4096, seed=seed)
    jv.fit({k: np.asarray(v, np.float32).reshape(-1, 1) for k, v in data.items()})
    return bn, jv, _loaded(jv, tmp_path)


@pytest.fixture(scope="module")
def highcard(tmp_path_factory):
    """Up to 80 classes, one parent a node (``test_torch_scan.py``'s)."""
    return _jax_cat(random_bn(n_nodes=6, max_card=80, max_indegree=1, seed=0),
                    tmp_path_factory.mktemp("hc"), seed=3)


@pytest.fixture(scope="module")
def tw24(tmp_path_factory):
    return _jax_cat(random_bn_treewidth(24, seed=5),
                    tmp_path_factory.mktemp("tw24"))


@pytest.fixture(scope="module")
def gauss24(tmp_path_factory):
    gbn = random_gaussian(24, seed=0)
    jv = JVBN(_graph(gbn), seed=0)
    jv.set_learning_method(
        "node_wise",
        nodes_cpds={n: jdefaults.cpd("linear_gaussian") for n in gbn.nodes})
    jv.fit({k: v.reshape(-1, 1) for k, v in gbn.sample(4096, seed=0).items()})
    return gbn, jv, _loaded(jv, tmp_path_factory.mktemp("g24"))


def _nets(request, net):
    return request.getfixturevalue(net)


def _sides(jv, tv, query):
    jp = j_get_plan(jv, JQuery(**query))
    tp = t_get_plan(tv, TQuery(**query))
    assert jp.topo_order == tp.topo_order
    return (
        (jp, tuple(jv.cpd_spec(n) for n in jp.topo_order),
         tuple(jv.params[n] for n in jp.topo_order)),
        (tp, tuple(tv.cpd_spec(n) for n in tp.topo_order),
         tuple(tv.params[n] for n in tp.topo_order)),
    )


def _static_query(nodes, cards, rng):
    """First node the target, the last two evidence, the third do."""
    col = lambda n: np.full((B, 1), float(rng.integers(0, cards[n])), np.float32)
    return dict(target=nodes[0], evidence={nodes[-1]: col(nodes[-1]),
                                           nodes[-2]: col(nodes[-2])},
                do={nodes[2]: col(nodes[2])})


def _packed(plan, query, b):
    fixed = np.zeros((b, plan.total_dim), np.float32)
    for name, v in {**query["evidence"], **query["do"]}.items():
        fixed[:, plan.topo_order.index(name)] = v[:, 0]
    return fixed


def _dynamic_masks(n, cards, b, rng):
    """Per-row fixed values, evidence and do masks and a one-hot target."""
    fixed = np.zeros((b, n), np.float32)
    ev = np.zeros((b, n), np.float32)
    do = np.zeros((b, n), np.float32)
    tgt = np.zeros((b, n), np.float32)
    for r in range(b):
        t, e1, e2, d = rng.choice(n, 4, replace=False)
        tgt[r, t] = 1.0
        ev[r, [e1, e2]] = 1.0
        do[r, d] = 1.0
        for i in (e1, e2, d):
            fixed[r, i] = float(rng.integers(0, cards[i]))
    return fixed, ev, do, tgt


@pytest.mark.parametrize("net", ["highcard", "tw24"])
def test_static_tables_equal_jax(request, net):
    bn, jv, tv = _nets(request, net)
    nodes = list(jv.dag.topological_order())
    q = _static_query(nodes, {n: bn.card(n) for n in nodes},
                      np.random.default_rng(0))
    (jp, jc, jpar), (tp, tc, tpar) = _sides(jv, tv, q)
    jt, tt = jds._static_tables(jp, jc), tds._static_tables(tp, tc)
    assert set(jt) == set(tt)
    for key in jt:
        if key in ("total_rows", "cmax"):
            assert jt[key] == tt[key], key
        else:
            np.testing.assert_array_equal(np.asarray(jt[key]),
                                          tt[key].numpy(), err_msg=key)
    np.testing.assert_allclose(
        tds._stacked_log_cpt(tc, tpar, tt["cmax"]).numpy(),
        np.asarray(jds._stacked_log_cpt(jc, jpar, jt["cmax"])), atol=1e-6,
        rtol=0)


def _jax_cat_noise(key, n, cmax, class_loop):
    keys = jax.random.split(key, n)
    if class_loop:
        draws = [jax.random.uniform(keys[i], (B, S), dtype=jnp.float32)
                 for i in range(n)]
    else:
        draws = [jax.random.gumbel(keys[i], (B, S, cmax), dtype=jnp.float32)
                 for i in range(n)]
    return torch.from_numpy(np.array(jnp.stack(draws)))


@pytest.mark.parametrize("form", ["gumbel", "class_loop"])
@pytest.mark.parametrize("mode", ["static", "dynamic"])
@pytest.mark.parametrize("net", ["highcard", "tw24"])
def test_discrete_trace_matches_jax_draws(request, monkeypatch, net, mode, form):
    monkeypatch.setenv("VBN_SCAN_CLASS_LOOP",
                       "always" if form == "class_loop" else "never")
    bn, jv, tv = _nets(request, net)
    nodes = list(jv.dag.topological_order())
    cards = {n: bn.card(n) for n in nodes}
    rng = np.random.default_rng(1)
    q = _static_query(nodes, cards, rng)
    (jp, jc, jpar), (tp, tc, tpar) = _sides(jv, tv, q)
    key = jax.random.PRNGKey(11)
    if mode == "static":
        fixed = _packed(jp, q, B)
        kw_j = dict(weighted=True)
        kw_t = dict(weighted=True)
    else:
        fixed, ev, do, tgt = _dynamic_masks(
            jp.n_nodes, [cards[n] for n in jp.topo_order], B, rng)
        fx = np.maximum(ev, do)
        kw_j = dict(weighted=True, ev_mask_arr=jnp.asarray(ev),
                    fx_mask_arr=jnp.asarray(fx), tgt_mask_arr=jnp.asarray(tgt))
        kw_t = dict(weighted=True, ev_mask_arr=torch.from_numpy(ev),
                    fx_mask_arr=torch.from_numpy(fx),
                    tgt_mask_arr=torch.from_numpy(tgt))
    j_out = jds.discrete_sweep_trace(jp, jc, jpar, key, jnp.asarray(fixed), S,
                                     **kw_j)
    cmax = tds._static_tables(tp, tc)["cmax"]
    noise = _jax_cat_noise(key, jp.n_nodes, cmax, form == "class_loop")
    t_out = tds.discrete_sweep_trace(tp, tc, tpar, None,
                                     torch.from_numpy(fixed), S, noise=noise,
                                     **kw_t)
    assert len(j_out) == len(t_out) == (2 if mode == "static" else 3)
    np.testing.assert_array_equal(t_out[0].numpy(), np.asarray(j_out[0]))
    for j, t in zip(j_out[1:], t_out[1:]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=0)
    # the ev/do clamps hold
    if mode == "static":
        for name, v in {**q["evidence"], **q["do"]}.items():
            i = tp.topo_order.index(name)
            assert torch.all(t_out[0][..., i] == float(v[0, 0]))


@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_gaussian_trace_matches_jax_eps(gauss24, mode):
    gbn, jv, tv = gauss24
    nodes = list(jv.dag.topological_order())
    rng = np.random.default_rng(2)
    col = lambda: rng.normal(size=(B, 1)).astype(np.float32)
    q = dict(target=nodes[0], evidence={nodes[-1]: col(), nodes[-3]: col()},
             do={nodes[4]: col()})
    (jp, jc, jpar), (tp, tc, tpar) = _sides(jv, tv, q)
    key = jax.random.PRNGKey(5)
    n = jp.n_nodes
    if mode == "static":
        fixed = _packed(jp, q, B)
        kw_j, kw_t = dict(weighted=True), dict(weighted=True)
    else:
        _f, ev, do, tgt = _dynamic_masks(n, [2] * n, B, rng)
        fixed = rng.normal(size=(B, n)).astype(np.float32)
        fx = np.maximum(ev, do)
        kw_j = dict(weighted=True, ev_mask_arr=jnp.asarray(ev),
                    fx_mask_arr=jnp.asarray(fx), tgt_mask_arr=jnp.asarray(tgt))
        kw_t = dict(weighted=True, ev_mask_arr=torch.from_numpy(ev),
                    fx_mask_arr=torch.from_numpy(fx),
                    tgt_mask_arr=torch.from_numpy(tgt))
    j_out = jgs.gaussian_sweep_trace(jp, jc, jpar, key, jnp.asarray(fixed), S,
                                     **kw_j)
    eps = torch.from_numpy(np.array(
        jax.random.normal(key, (B, S, n), jnp.float32)))
    t_out = tgs.gaussian_sweep_trace(tp, tc, tpar, None,
                                     torch.from_numpy(fixed), S, noise=eps,
                                     **kw_t)
    assert len(j_out) == len(t_out) == (2 if mode == "static" else 3)
    np.testing.assert_allclose(t_out[0].numpy(), np.asarray(j_out[0]),
                               atol=1e-5, rtol=0)
    for j, t in zip(j_out[1:], t_out[1:]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5,
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


def _port_cat(bn, seed=0):
    tv = TVBN({n: bn.parents[n] for n in bn.nodes}, seed=seed, device="cpu")
    tv.set_learning_method("node_wise", nodes_cpds=_cat_conf(bn, tdefaults))
    tv.fit(generate_dataset(bn, 2048, seed=seed))
    return tv


def _port_lg(gbn, seed=0):
    tv = TVBN({n: gbn.parents[n] for n in gbn.nodes}, seed=seed, device="cpu")
    tv.set_learning_method(
        "node_wise",
        nodes_cpds={n: tdefaults.cpd("linear_gaussian") for n in gbn.nodes})
    tv.fit(gbn.sample(2048, seed=seed))
    return tv


@pytest.fixture(scope="module")
def tw63_64():
    return {n: _port_cat(random_bn_treewidth(n, seed=2)) for n in (63, 64)}


@pytest.mark.parametrize("n_nodes", [63, 64])
@pytest.mark.parametrize("mode", ["always", "never", "auto"])
def test_discrete_scan_routing(tw63_64, monkeypatch, mode, n_nodes):
    """VBN_DISCRETE_SCAN and the 64-node threshold pick the route of the
    static sweep (ancestral sampling) and of the mask-dynamic one (LW with
    dynamic_masks at an S the scan kernel refuses)."""
    monkeypatch.setenv("VBN_DISCRETE_SCAN", mode)
    tv = tw63_64[n_nodes]
    want = ("discrete" if mode == "always" or (mode == "auto" and n_nodes >= 64)
            else "per_node")
    nodes = list(tv.dag.topological_order())
    q = {"target": nodes[-1], "evidence": {nodes[0]: [[0.0]]}}
    tsw.ROUTES.clear()
    tv.set_sampling_method("ancestral")
    draws = tv.sample(q, n_samples=100)
    tv.set_inference_method("likelihood_weighting", n_samples=1000,
                            dynamic_masks=True)
    w, s = tv.infer_posterior(q)
    assert dict(tsw.ROUTES) == {want: 2}
    assert draws.shape == (1, 100, 1) and s.shape == (1, 1000, 1)
    assert torch.isfinite(w).all()
    assert tsw._use_discrete_scan(n_nodes) == (want == "discrete")


def test_gaussian_form_routing(monkeypatch):
    """An all-LG 64-node plan takes the Gaussian form under auto (both
    sweep kernels refuse S = 1000, not a multiple of 1024)."""
    monkeypatch.setenv("VBN_DISCRETE_SCAN", "auto")
    tv = _port_lg(random_gaussian(64, seed=1))
    nodes = list(tv.dag.topological_order())
    tsw.ROUTES.clear()
    tv.set_inference_method("likelihood_weighting", n_samples=1000)
    w, s = tv.infer_posterior({"target": nodes[0],
                               "evidence": {nodes[-1]: [[0.5]]}})
    assert dict(tsw.ROUTES) == {"gaussian": 1}
    assert torch.isfinite(w).all() and torch.isfinite(s).all()


def test_mixed_plan_never_takes_a_stacked_form(monkeypatch):
    """Gaussian and categorical nodes in one plan: the per-node loop, even
    when forced (``test_scan_not_used_for_mixed_networks``)."""
    monkeypatch.setenv("VBN_DISCRETE_SCAN", "always")
    g = np.random.default_rng(0)
    c = g.integers(0, 2, size=500)
    data = {"c": c.astype(np.float32),
            "y": (c + g.normal(size=500)).astype(np.float32)}
    tv = TVBN([("c", "y")], seed=0, device="cpu")
    tv.set_learning_method("node_wise", nodes_cpds={
        "c": dict(tdefaults.cpd("categorical_table"), n_classes=2),
        "y": tdefaults.cpd("linear_gaussian")})
    tv.fit(data)
    plan = t_get_plan(tv, TQuery(target="c", evidence={"y": np.ones((1, 1))},
                                 do={}))
    cpds = tuple(tv.cpd_spec(n) for n in plan.topo_order)
    assert tsw.stacked_form(plan, cpds) == ("per_node", None)
    tsw.ROUTES.clear()
    tv.set_inference_method("likelihood_weighting", n_samples=64)
    w, _s = tv.infer_posterior({"target": "c", "evidence": {"y": [[0.1]]}})
    tv.set_inference_method("likelihood_weighting", n_samples=64,
                            dynamic_masks=True)
    w2, _s2 = tv.infer_posterior({"target": "c", "evidence": {"y": [[0.1]]}})
    assert dict(tsw.ROUTES) == {"per_node": 2}
    assert torch.isfinite(w).all() and torch.isfinite(w2).all()


# ---------------------------------------------------------------------------
# Posteriors against the exact engines (test_discrete_scan.py,
# test_gaussian_scan.py)
# ---------------------------------------------------------------------------


def _fitted(bn, tv):
    fit = DiscreteBN(name="fitted")
    for node in tv.dag.topological_order():
        cnt = tv.params[node]["counts"][0].double().numpy()
        cards = tuple(bn.card(p) for p in tv.dag.parents(node))
        fit.nodes.append(node)
        fit.states[node] = bn.states[node]
        fit.parents[node] = list(tv.dag.parents(node))
        fit.cpts[node] = (cnt / cnt.sum(-1, keepdims=True)).reshape(
            cards + (cnt.shape[-1],))
    return fit


def _lw_pmf(tv, target, evidence, n_samples, k):
    tv.set_inference_method("likelihood_weighting", n_samples=n_samples)
    w, s = tv.infer_posterior({"target": target, "evidence": {
        n: [[float(v)]] for n, v in evidence.items()}})
    p = np.bincount(s[0, :, 0].long().numpy(), weights=w[0].double().numpy(),
                    minlength=k)
    return p / p.sum()


@pytest.mark.parametrize("case", ["predictive", "diagnosis"])
def test_discrete_form_matches_exact(monkeypatch, case):
    """Forced stacked form at S = 16000 (off the kernels' 1024 grid),
    against variable elimination on the fitted CPTs: a predictive query
    and one with evidence downstream of the target (the log-weights)."""
    monkeypatch.setenv("VBN_DISCRETE_SCAN", "always")
    if case == "predictive":
        bn = random_bn(15, max_indegree=3, max_card=3, seed=7)
        target, ev = bn.nodes[-1], {bn.nodes[0]: 1}
    else:
        bn = random_bn(10, max_indegree=2, max_card=2, seed=11)
        target = bn.nodes[0]
        desc = next((n for n in bn.nodes if target in bn.parents[n]),
                    bn.nodes[-1])
        ev = {desc: 0}
    tv = _port_cat(bn)
    tsw.ROUTES.clear()
    got = _lw_pmf(tv, target, ev, 16000, bn.card(target))
    assert dict(tsw.ROUTES) == {"discrete": 1}
    gt = exact_posterior(_fitted(bn, tv), target, ev)
    np.testing.assert_allclose(got, gt, atol=0.03)


def test_discrete_form_matches_per_node_loop(monkeypatch):
    """Both routes are Monte-Carlo estimates of one posterior."""
    bn = random_bn(12, max_indegree=2, max_card=3, seed=3)
    tv = _port_cat(bn)
    target, ev = bn.nodes[-1], {bn.nodes[0]: 0}
    got = {}
    for mode in ("never", "always"):
        monkeypatch.setenv("VBN_DISCRETE_SCAN", mode)
        got[mode] = _lw_pmf(tv, target, ev, 16000, bn.card(target))
    np.testing.assert_allclose(got["never"], got["always"], atol=0.03)


def _chain(n_nodes, seed=0, rows=3000):
    g = np.random.default_rng(seed)
    cols = {}
    for i in range(n_nodes):
        noise = g.normal(size=rows)
        cols[f"v{i}"] = noise if i == 0 else 0.7 * cols[f"v{i-1}"] + 0.3 * noise
    tv = TVBN({f"v{i}": [f"v{i-1}"] if i else [] for i in range(n_nodes)},
              seed=0, device="cpu")
    tv.set_learning_method("node_wise", nodes_cpds={
        c: tdefaults.cpd("linear_gaussian") for c in cols})
    tv.fit(cols)
    return tv


def _mean(tv, q, n_samples=16000):
    tv.set_inference_method("likelihood_weighting", n_samples=n_samples)
    w, s = tv.infer_posterior(q)
    return tv._posterior_stats(w, s)["mean"][:, 0].numpy()


def test_gaussian_form_matches_per_node_and_closed_form(monkeypatch):
    tv = _chain(10)
    q = {"target": "v9", "evidence": {"v0": [[1.0], [-1.0]]}}
    got = {}
    for mode in ("never", "always"):
        monkeypatch.setenv("VBN_DISCRETE_SCAN", mode)
        tsw.ROUTES.clear()
        got[mode] = _mean(tv, q)
        assert dict(tsw.ROUTES) == {("gaussian" if mode == "always"
                                     else "per_node"): 1}
    np.testing.assert_allclose(got["never"], got["always"], atol=0.05)
    assert abs(got["always"][0] - 0.7 ** 9) < 0.05


def test_gaussian_form_diagnosis_and_do(monkeypatch):
    monkeypatch.setenv("VBN_DISCRETE_SCAN", "always")
    tv = _chain(5)
    assert _mean(tv, {"target": "v0", "evidence": {"v4": [[1.0]]}},
                 32000)[0] > 0.15  # pulled toward +
    tv4 = _chain(4)
    tv4.set_sampling_method("ancestral")
    draws = tv4.sample({"target": "v3", "evidence": {}, "do": {"v1": [[2.0]]}},
                       n_samples=8192)
    assert abs(float(draws.mean()) - 2.0 * 0.7 ** 2) < 0.05


def test_dynamic_sweep_takes_the_stacked_form(tw63_64, monkeypatch):
    """``dynamic_sweep_trace`` (the amortizer's and the dynamic methods'
    torch-op sweep) on a 64-node plan under auto: the stacked form's
    states and weights, draw for draw, equal the forced route's on the
    same key's row stream."""
    tv = tw63_64[64]
    plan = t_get_plan(tv, TQuery(target=tv.dag.topological_order()[0],
                                 evidence={}, do={}))
    cpds = tuple(tv.cpd_spec(n) for n in plan.topo_order)
    params = tuple(tv.params[n] for n in plan.topo_order)
    n = plan.n_nodes
    fixed = torch.zeros((2, n))
    ev = torch.zeros((2, n))
    ev[0, 5] = 1.0
    do = torch.zeros((2, n))
    do[1, 7] = 1.0
    outs = {}
    for mode in ("auto", "always"):
        monkeypatch.setenv("VBN_DISCRETE_SCAN", mode)
        draw = Draw(3, torch.device("cpu"))
        tsw.ROUTES.clear()
        outs[mode] = tdyn.dynamic_sweep_trace(plan, cpds, params, draw, fixed,
                                              ev, do, 32)
        assert dict(tsw.ROUTES) == {"discrete": 1}
    for a, b in zip(outs["auto"], outs["always"]):
        assert torch.equal(a, b)
    assert torch.all(outs["auto"][0][0, :, 5] == 0.0)
    assert torch.all(outs["auto"][0][1, :, 7] == 0.0)
