"""The port's exact engines against the JAX package's and benchmarking.exact.

The JAX package fits each network on rows made with numpy from a seed
(in-repo generators only), sets ``categorical_exact`` or
``gaussian_exact``, and saves its checkpoint; the port loads it on the CPU
(the method comes back from the checkpoint) and both answer the same
queries. References: the JAX engines on the same checkpoint, and variable
elimination (``benchmarking.exact.exact_posterior``) on the fitted CPTs,
or the fitted linear-Gaussian network's closed form
(``GaussianBN.conditional``, float64).

Tolerances. pmf rows: 1e-5 absolute against the JAX engine and against
variable elimination (float32 sums of the same factors in another order;
rows are probabilities at most 1). Moments: 1e-4 of the posterior std
against the JAX engine and the float64 closed form (float32 solves of the
same systems, one factorization with two right-hand sides here, two
solves there). Float32 matmuls run at full precision here as in the JAX
package's ``Precision.HIGHEST``: ``allow_tf32`` is off (it only matters
on a card).
"""

import types
import warnings

import networkx as nx
import numpy as np
import pytest
import torch

from benchmarking.data_gen import generate_dataset
from benchmarking.exact import exact_posterior, min_fill_order
from benchmarking.gaussian_bn import gaussian_ground_truth, random_gaussian
from benchmarking.midsize import alarm, insurance
from benchmarking.networks import asia
from benchmarking.query_gen import generate_inference_queries
from chip_smoke import fitted_discrete_bn, fitted_gaussian_bn
from test_torch_checkpoint import flagship_setup
from vectorizedbayesiannetwork_torch import VBN as TVBN
from vectorizedbayesiannetwork_torch.inference._lg_exact import (
    lg_exact_supported,
)
from vectorizedbayesiannetwork_tpu import VBN as JVBN
from vectorizedbayesiannetwork_tpu import defaults as jdefaults

torch.backends.cuda.matmul.allow_tf32 = False

PMF_ATOL = 1e-5
MOM_RTOL = 1e-4


def _discrete(bn, n_rows=2048, seed=0):
    """The JAX fit of a discrete network on ``n_rows`` of its data."""
    data = generate_dataset(bn, n_rows, seed=seed)
    g = nx.DiGraph()
    g.add_nodes_from(bn.nodes)
    g.add_edges_from(bn.edges())
    conf = {}
    for node in bn.nodes:
        c = dict(jdefaults.cpd("categorical_table"), n_classes=bn.card(node))
        if bn.parents[node]:
            c["parent_n_classes"] = [bn.card(p) for p in bn.parents[node]]
        conf[node] = c
    jv = JVBN(g, seed=seed)
    jv.set_learning_method("node_wise", nodes_cpds=conf)
    jv.fit({k: np.asarray(v, np.float32).reshape(-1, 1)
            for k, v in data.items()})
    return jv


def _gaussian(parents, data, seed=0):
    g = nx.DiGraph()
    g.add_nodes_from(parents)
    g.add_edges_from((p, n) for n in parents for p in parents[n])
    jv = JVBN(g, seed=seed)
    jv.set_learning_method(
        "node_wise",
        nodes_cpds={n: jdefaults.cpd("linear_gaussian") for n in parents})
    jv.fit(data)
    return jv


def _load(jv, path, method, **kw):
    """Set ``method`` on the JAX model, save it, load it in the port: the
    port must restore the method from the checkpoint, with no warning."""
    jv.set_inference_method(method, **kw)
    jv.save(str(path))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tv = TVBN.load(str(path), device="cpu")
    assert tv._inference_config["name"] == method
    assert type(tv._inference).__name__ == type(jv._inference).__name__
    return tv


def _pair(jv, path):
    return jv, _load(jv, path, "categorical_exact")


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp("exact")
    ja = _discrete(asia(), 4096)
    mid = {net.__name__: net() for net in (insurance, alarm)}
    fg, farrays = flagship_setup()
    jf = _gaussian({"x0": [], "x1": [], "x2": ["x0", "x1"]}, farrays)
    gbn = random_gaussian(8, seed=0)
    jg = _gaussian({n: gbn.parents[n] for n in gbn.nodes},
                   gbn.sample(4096, seed=0))
    return {
        "asia": (ja, _load(ja, root / "asia.npz", "categorical_exact")),
        **{name: (bn, *_pair(_discrete(bn, 2048), root / f"{name}.npz"))
           for name, bn in mid.items()},
        "flagship": (jf, _load(jf, root / "flag.npz", "gaussian_exact",
                               n_samples=64)),
        "gauss8": (jg, _load(jg, root / "g8.npz", "gaussian_exact",
                             n_samples=64)),
        "gbn": gbn,
    }


def _col(v):
    return np.full((1, 1), float(v), np.float32)


def _q(target, evidence, do=None):
    return {"target": target, "evidence": {k: _col(v) for k, v in evidence.items()},
            "do": {k: _col(v) for k, v in (do or {}).items()}}


ASIA_QUERIES = [
    ("dysp", {"smoke": 1, "asia": 0}, None),
    ("lung", {"xray": 1, "dysp": 1}, None),  # latent parents, diagnosis
    ("either", {}, None),
    ("bronc", {"dysp": 0}, {"smoke": 1}),  # a do
    ("tub", {"asia": 1, "xray": 0, "dysp": 1}, None),
]


def _normalized(rows):
    rows = np.asarray(rows, np.float64)
    return rows / rows.sum(axis=1, keepdims=True)


def test_asia_enumeration_matches_jax_and_variable_elimination(models):
    ja, ta = models["asia"]
    qs = [_q(*q) for q in ASIA_QUERIES]
    got, spans = ta.infer_posterior_pmf(qs, n_classes=2)
    want, jspans = ja.infer_posterior_pmf(qs, n_classes=2)
    assert spans == jspans and ta._last_summary_path == "fused"
    assert not ta._inference._last_fallback
    np.testing.assert_allclose(_normalized(got), _normalized(want),
                               atol=PMF_ATOL)
    fit = fitted_discrete_bn(asia(), ta)
    for (lo, _hi, _t), (t, ev, do) in zip(spans, ASIA_QUERIES):
        if do:
            continue  # variable elimination takes no do()
        ref = np.asarray(exact_posterior(fit, t, ev))
        np.testing.assert_allclose(_normalized(got[lo:lo + 1])[0], ref,
                                   atol=PMF_ATOL)


@pytest.mark.parametrize("name", ["insurance", "alarm"])
def test_junction_tree_matches_jax_and_variable_elimination(models, name):
    """insurance (27 nodes) and alarm (37): joint supports far past
    enumeration, served by the junction tree."""
    bn, ji, ti = models[name]
    gen = generate_inference_queries(bn, 6, seed=0)
    qs = [_q(q.target, q.evidence) for q in gen]
    k = max(bn.card(n) for n in bn.nodes)
    got, spans = ti.infer_posterior_pmf(qs, n_classes=k)
    want, _ = ji.infer_posterior_pmf(qs, n_classes=k)
    assert not ti._inference._last_fallback
    assert ti._inference._jtree_cache  # enumeration is out of range
    np.testing.assert_allclose(_normalized(got), _normalized(want),
                               atol=PMF_ATOL)
    fit = fitted_discrete_bn(bn, ti, floor=1e-12)
    order = min_fill_order(fit)
    for (lo, _hi, _t), q in zip(spans, gen):
        ref = np.asarray(exact_posterior(fit, q.target, q.evidence,
                                         elim_order=order))
        np.testing.assert_allclose(got[lo, : ref.size], ref, atol=PMF_ATOL)


def test_categorical_exact_per_query_matches_jax(models):
    """infer_posterior: parents observed (the CPT row), latent parents (the
    exact programs for one query), and a clamped target."""
    ja, ta = models["asia"]
    for q in (_q("dysp", {"either": 1, "bronc": 0}),
              _q("lung", {"xray": 1}), _q("smoke", {"smoke": 1})):
        gp, gs = ta.infer_posterior(q)
        jp, js = ja.infer_posterior(q)
        np.testing.assert_allclose(gp.numpy(), np.asarray(jp), atol=PMF_ATOL)
        np.testing.assert_array_equal(gs.numpy(), np.asarray(js))
        assert not ta._inference._last_fallback


def test_categorical_exact_delegates_past_both_budgets(models, tmp_path):
    """A clique budget of 2 refuses the junction tree: the whole dispatch
    goes to likelihood weighting's mask-dynamic path, flagged; its rows
    are within Monte-Carlo error of the exact ones."""
    ja, _ = models["asia"]
    tv = _load(ja, tmp_path / "a.npz", "categorical_exact", max_states=4,
               max_clique_states=2, n_samples=1 << 14)
    qs = [_q(*q) for q in ASIA_QUERIES[:3]]
    rows, spans = tv.infer_posterior_pmf(qs, n_classes=2)
    assert tv._inference._last_fallback and rows.shape == (3, 2)
    exact_tv = models["asia"][1]
    want, _ = exact_tv.infer_posterior_pmf(qs, n_classes=2)
    np.testing.assert_allclose(_normalized(rows), _normalized(want), atol=0.03)
    ja.set_inference_method("categorical_exact")


def _gauss_reference(fit, queries):
    """(mean, std) of each query under the fitted network, float64."""
    ns = [types.SimpleNamespace(query_id=str(i), target=t, evidence=ev, do=do)
          for i, (t, ev, do) in enumerate(queries)]
    return np.array([[r["mean"], r["std"]]
                     for r in gaussian_ground_truth(fit, ns)])


def _mixed_gauss_queries(nodes, seed):
    """Targets with 0-2 evidence nodes and at most one do each."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(12):
        t, *rest = (nodes[int(j)] for j in rng.permutation(len(nodes)))
        n_ev = min(i % 3, len(rest))
        ev = {n: float(rng.normal()) for n in rest[:n_ev]}
        do = ({rest[n_ev]: float(rng.normal())}
              if i % 4 == 3 and n_ev < len(rest) else {})
        out.append((t, ev, do))
    return out


@pytest.mark.parametrize("model", ["flagship", "gauss8"])
def test_gaussian_exact_fused_moments_match_jax_and_closed_form(models, model):
    jv, tv = models[model]
    nodes = list(tv.dag.topological_order())
    queries = _mixed_gauss_queries(nodes, 5)
    if model == "flagship":
        queries.append(("x2", {"x0": -0.7, "x1": 0.4}, {}))
    qs = [_q(*q) for q in queries]
    got, spans = tv.infer_posterior_moments(qs)
    want, _ = jv.infer_posterior_moments(qs)
    assert tv._last_summary_path == "fused"
    assert not tv._inference._last_fallback
    ref = _gauss_reference(fitted_gaussian_bn(tv), queries)
    rows = np.array([got[lo] for lo, _hi, _t in spans], np.float64)
    scale = np.maximum(ref[:, 1:2], 1e-3)
    jrows = np.asarray(want, np.float64)[[lo for lo, _hi, _t in spans]]
    np.testing.assert_array_less(np.abs(rows - jrows) / scale, MOM_RTOL)
    np.testing.assert_array_less(np.abs(rows - ref) / scale, MOM_RTOL)


def test_gaussian_exact_grid_and_fallback_match_jax(models):
    """infer_posterior: the pdf on the loc +- 4 scale grid where every
    parent is observed, the fallback (flagged) where one is latent."""
    jf, tf = models["flagship"]
    q = {"target": "x2", "evidence": {
        "x0": np.linspace(-1, 1, 5, dtype=np.float32).reshape(5, 1),
        "x1": np.linspace(1, -1, 5, dtype=np.float32).reshape(5, 1)}}
    gp, gs = tf.infer_posterior(q)
    jp, js = jf.infer_posterior(q)
    assert gp.shape == (5, 64) and gs.shape == (5, 64, 1)
    np.testing.assert_allclose(gp.numpy(), np.asarray(jp), rtol=1e-5)
    np.testing.assert_allclose(gs.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-6)
    assert not tf._inference._last_fallback
    tf.infer_posterior(_q("x2", {"x0": 0.3}))
    assert tf._inference._last_fallback


def test_lg_exact_refuses_networks_that_are_not_linear_gaussian(models):
    """A categorical node: the closed form refuses the plan, gaussian_exact's
    fused moments return None and the VBN reduces the stream instead."""
    _, ta = models["asia"]
    ta.set_inference_method("gaussian_exact", n_samples=256)
    inf = ta._inference
    plan, cpds = inf._canonical(ta)
    assert not lg_exact_supported(plan, cpds)
    assert inf.infer_posterior_moments(ta, [ta._normalize_query(
        _q("dysp", {"smoke": 1}))]) is None
    rows, _ = ta.infer_posterior_moments([_q("dysp", {"smoke": 1})])
    assert ta._last_summary_path == "stream" and rows.shape == (1, 2)
    ta.set_inference_method("categorical_exact")
