"""The neural CPD slice as a whole: JAX checkpoints served by the port.

The JAX package fits networks of neural CPDs on rows made with numpy from
a seed (the 3-node flagship with ``gaussian_nn`` roots and a
``gaussian_nn``, ``rff_gaussian`` or ``mdn`` child; asia with
``softmax_nn`` and ``categorical_embedded_softmax`` nodes), saves them,
and the port loads each checkpoint on the CPU. Then:

- ``gaussian_exact``'s grid answers (a Gaussian-family target with its
  parents observed) agree within 1e-4, and ``categorical_exact``'s pmf
  rows within 1e-5 (the same float32 expressions of the same params);
- likelihood weighting, Monte-Carlo marginalization and importance
  sampling agree within Monte-Carlo error: each side's weighted mean
  within 5 standard errors of the other (both sides' ESS counted);
- a checkpoint the port writes loads back into the JAX package, params
  equal, log-densities within 1e-5;
- ``node_wise`` without ``nodes_cpds`` fits ``gaussian_nn`` everywhere;
- the port's own ``categorical_embedded_softmax`` fit meets the JAX
  package's accuracy limit (``tests/test_emb_accuracy.py``): mean KL to
  the true CPTs within 2x of ``categorical_table``'s + 1e-3.
"""

import networkx as nx
import numpy as np
import pytest
import torch

from benchmarking.data_gen import domain_schema, generate_dataset
from benchmarking.networks import acquire, asia
from test_torch_checkpoint import flagship_setup
from vectorizedbayesiannetwork_torch import VBN as TVBN
from vectorizedbayesiannetwork_torch import defaults as tdefaults
from vectorizedbayesiannetwork_torch.models import GaussianNNCPD
from vectorizedbayesiannetwork_tpu import VBN as JVBN
from vectorizedbayesiannetwork_tpu import defaults as jdefaults

S = 1 << 14
FIT = {"epochs": 15, "batch_size": 512, "lr": 1e-2}
NN = {"hidden_dims": [16]}
CHILD = {
    "gaussian_nn": NN,
    "rff_gaussian": {"n_features": 16, "lengthscale": 0.5, "ridge": 1e-2},
    "mdn": dict(NN, n_components=3),
}


def _flagship_conf(defaults, child):
    root = dict(defaults.cpd("gaussian_nn"), **NN, fit=FIT)
    return {"x0": root, "x1": dict(root),
            "x2": dict(defaults.cpd(child), **CHILD[child], fit=FIT)}


def _asia_conf(defaults):
    """softmax_nn on the roots and odd nodes, embedded softmax elsewhere."""
    bn = asia()
    out = {}
    for i, node in enumerate(bn.nodes):
        if not bn.parents[node] or i % 2:
            out[node] = dict(defaults.cpd("softmax_nn"), **NN, n_classes=2,
                             fit=FIT)
        else:
            out[node] = dict(defaults.cpd("categorical_embedded_softmax"),
                             **NN, embedding_dim=4, fit=FIT)
    return out


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """name -> (JAX model, the port's load of its checkpoint)."""
    root = tmp_path_factory.mktemp("neural_slice")
    g, arrays = flagship_setup(2048)
    out = {}
    for child in CHILD:
        jv = JVBN(g, seed=0)
        jv.set_learning_method("node_wise",
                               nodes_cpds=_flagship_conf(jdefaults, child))
        jv.fit(arrays)
        jv.save(str(root / f"{child}.npz"))
        out[child] = (jv, TVBN.load(str(root / f"{child}.npz"), device="cpu"))
    bn = asia()
    data = generate_dataset(bn, 2048, seed=0)
    ag = nx.DiGraph()
    ag.add_nodes_from(bn.nodes)
    ag.add_edges_from(bn.edges())
    jv = JVBN(ag, seed=0)
    jv.set_learning_method("node_wise", nodes_cpds=_asia_conf(jdefaults))
    jv.fit({k: np.asarray(v, np.float32) for k, v in data.items()})
    jv.save(str(root / "asia.npz"))
    out["asia"] = (jv, TVBN.load(str(root / "asia.npz"), device="cpu"))
    return out


def _both(models, name, method, **kw):
    jv, tv = models[name]
    jv.set_inference_method(method, **kw)
    tv.set_inference_method(method, **kw)
    return jv, tv


# ---------------------------------------------------------------------------
# exact engines
# ---------------------------------------------------------------------------

EV = np.linspace(-1.0, 1.0, 4, dtype=np.float32).reshape(-1, 1)


@pytest.mark.parametrize("child", ["gaussian_nn", "rff_gaussian"])
def test_gaussian_exact_grid_matches_jax(models, child):
    jv, tv = _both(models, child, "gaussian_exact", n_samples=256)
    q = {"target": "x2", "evidence": {"x0": EV, "x1": -EV}}
    jw, js = jv.infer_posterior(q)
    tw, ts = tv.infer_posterior(q)
    assert not tv._inference._last_fallback
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-4,
                               atol=1e-4)
    qs = [q, {"target": "x0", "evidence": {}}]
    jrows, _ = jv.infer_posterior_moments(qs)
    trows, _ = tv.infer_posterior_moments(qs)
    np.testing.assert_allclose(trows, np.asarray(jrows), rtol=1e-4, atol=1e-4)


ASIA_QS = [
    {"target": "dysp", "evidence": {"smoke": [[0.0], [1.0], [1.0], [0.0]],
                                    "asia": [[0.0], [0.0], [1.0], [1.0]]}},
    {"target": "lung", "evidence": {"xray": [[1.0]], "dysp": [[1.0]]}},
    {"target": "either", "evidence": {"tub": [[0.0], [1.0]],
                                      "lung": [[1.0], [0.0]]}},
]


def _normalized(rows):
    rows = np.asarray(rows, np.float64)
    return rows / rows.sum(axis=1, keepdims=True)


def test_categorical_exact_matches_jax(models):
    jv, tv = _both(models, "asia", "categorical_exact")
    jrows, jspans = jv.infer_posterior_pmf(ASIA_QS, n_classes=2)
    trows, tspans = tv.infer_posterior_pmf(ASIA_QS, n_classes=2)
    assert [tuple(s) for s in tspans] == [tuple(s) for s in jspans]
    assert not tv._inference._last_fallback
    np.testing.assert_allclose(_normalized(trows), _normalized(jrows),
                               atol=1e-5)
    for q in ASIA_QS:  # per query: parents observed, then latent parents
        jp, js = jv.infer_posterior(q)
        tp, ts = tv.infer_posterior(q)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# ---------------------------------------------------------------------------
# sampling methods within Monte-Carlo error
# ---------------------------------------------------------------------------


def _weighted(pdf, samples):
    """(mean [B], std [B], ess [B]) of the weighted draws."""
    w = np.maximum(np.nan_to_num(np.asarray(pdf, np.float64)), 0.0)
    w = w / w.sum(axis=1, keepdims=True)
    x = np.asarray(samples, np.float64)[..., 0]
    mean = (w * x).sum(axis=1)
    std = np.sqrt((w * (x - mean[:, None]) ** 2).sum(axis=1))
    return mean, std, 1.0 / (w**2).sum(axis=1)


METHOD_QUERIES = {
    "likelihood_weighting": {"target": "x0", "evidence": {"x2": EV}},
    "monte_carlo_marginalization": {"target": "x2", "evidence": {"x0": EV}},
    "importance_sampling": {"target": "x1", "evidence": {"x2": EV}},
}


@pytest.mark.parametrize("child", sorted(CHILD))
@pytest.mark.parametrize("method", sorted(METHOD_QUERIES))
def test_sampling_methods_agree_within_mc_error(models, child, method):
    jv, tv = _both(models, child, method, n_samples=S)
    q = METHOD_QUERIES[method]
    jm, js, je = _weighted(*jv.infer_posterior(q))
    tm, ts, te = _weighted(*tv.infer_posterior(q))
    se = np.sqrt(js**2 / je + ts**2 / te)
    assert np.all(np.abs(tm - jm) <= 5 * se), (tm, jm, se)
    assert np.all(np.abs(ts - js) <= 5 * se + 0.05 * js), (ts, js)


def test_lw_pmf_on_the_discrete_network_agrees_within_mc_error(models):
    jv, tv = _both(models, "asia", "likelihood_weighting", n_samples=S)
    for q in ASIA_QS:
        jp, js = jv.infer_posterior(q)
        tp, ts = tv.infer_posterior(q)
        for pdf, samples in ((jp, js), (tp, ts)):
            assert np.isin(np.asarray(samples), [0.0, 1.0]).all()
        jm, _, je = _weighted(jp, js)
        tm, _, te = _weighted(tp, ts)
        # the weighted mean of a 0/1 target is P(class 1)
        se = np.sqrt(jm * (1 - jm) / je + tm * (1 - tm) / te)
        assert np.all(np.abs(tm - jm) <= 5 * se + 1e-6), (tm, jm)


# ---------------------------------------------------------------------------
# the port's checkpoints, the default learner, the embedded fit's accuracy
# ---------------------------------------------------------------------------


def _port_fit(name, tmp_path):
    if name == "asia":
        bn = asia()
        parents = {n: bn.parents[n] for n in bn.nodes}
        data = generate_dataset(bn, 1024, seed=1)
        conf = _asia_conf(tdefaults)
        queries = [("dysp", {"either": [1.0, 0.0], "bronc": [0.0, 1.0]}),
                   ("asia", None)]
    else:
        parents = {"x0": [], "x1": [], "x2": ["x0", "x1"]}
        _, data = flagship_setup(1024, seed=1)
        conf = _flagship_conf(tdefaults, name)
        queries = [("x2", {"x0": 0.3, "x1": -0.5}), ("x0", None)]
    tv = TVBN(parents, seed=0, device="cpu")
    tv.set_learning_method("node_wise", nodes_cpds=conf)
    tv.fit({k: np.asarray(v, np.float32) for k, v in data.items()})
    path = str(tmp_path / f"port_{name}.npz")
    tv.save(path)
    return tv, JVBN.load(path), queries


@pytest.mark.parametrize("name", ["gaussian_nn", "rff_gaussian", "mdn",
                                  "asia"])
def test_port_checkpoint_loads_in_jax(name, tmp_path):
    tv, jv, queries = _port_fit(name, tmp_path)
    for node in tv.dag.nodes():
        assert jv.nodes[node].registry_key == tv.nodes[node].registry_key
        assert jv.nodes[node].get_extra_state() == tv.nodes[node].get_extra_state()
        assert jv.nodes[node].get_init_kwargs() == tv.nodes[node].get_init_kwargs()
    for node, parents in queries:
        x = np.array([[0.0], [1.0], [0.25]], np.float32)
        if name == "asia":
            x = x[:2]
        want = np.asarray(jv.cpd(node).log_prob(x, parents))
        got = tv.cpd(node).log_prob(x, parents).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_node_wise_default_fits_gaussian_nn_everywhere():
    _, data = flagship_setup(512, seed=3)
    tv = TVBN({"x0": [], "x1": [], "x2": ["x0", "x1"]}, seed=0, device="cpu")
    tv.set_learning_method("node_wise")
    tv.fit(data)
    assert all(isinstance(c, GaussianNNCPD) for c in tv.nodes.values())
    conf = tv._learning_config["nodes_cpds"]
    assert conf == {n: tdefaults.cpd("gaussian_nn") for n in ("x0", "x1", "x2")}
    assert all(int(tv.params[n]["opt"]["step"]) == 100 for n in tv.nodes)
    assert all(not t.requires_grad
               for t in tv.params["x2"]["net"]["layers"][0].values())
    loc, scale = tv.cpd("x2").conditional_mean_std({"x0": [0.3], "x1": [-0.5]})
    assert abs(float(loc) - (0.5 * 0.3 + 0.2 * 0.5)) < 0.1
    assert 0.0 < float(scale) < 0.5


EMB_FIT = {"epochs": 150, "batch_size": 512, "lr": 5e-3, "weight_decay": 1e-3}


def test_port_embedded_softmax_fit_meets_the_jax_accuracy_limit():
    """``tests/test_emb_accuracy.py``'s fixture and limit, on the port."""
    bn = acquire("random", sizes=[8], max_card=4)[0]
    data = generate_dataset(bn, n_rows=3000, seed=7)
    domain = domain_schema(bn)
    parents = {n: list(info["parents"]) for n, info in domain["nodes"].items()}

    def fit(cpd_name, **extra):
        conf = {}
        for node, info in domain["nodes"].items():
            c = dict(tdefaults.cpd(cpd_name), n_classes=int(info["n_classes"]),
                     **extra)
            pc = [int(domain["nodes"][p]["n_classes"]) for p in info["parents"]]
            if pc:
                c["parent_n_classes"] = pc
            conf[node] = c
        v = TVBN(parents, seed=0, device="cpu")
        v.set_learning_method("node_wise", nodes_cpds=conf)
        v.fit(data)
        return v

    def mean_kl(v):
        kls = []
        for node, info in domain["nodes"].items():
            cards = [int(domain["nodes"][p]["n_classes"]) for p in info["parents"]]
            rows = (np.array(np.meshgrid(*[np.arange(c) for c in cards],
                                         indexing="ij")).reshape(len(cards), -1)
                    .T.astype(np.float32) if cards else None)
            probs = v.cpd(node).conditional(rows)["probs"].numpy()
            true = bn.cpts[node].reshape(-1, bn.cpts[node].shape[-1])
            probs = probs.reshape(true.shape)
            kl = np.sum(true * (np.log(np.maximum(true, 1e-12))
                                - np.log(np.maximum(probs, 1e-12))), axis=-1)
            kls.append(float(np.mean(kl)))
        return float(np.mean(kls))

    kl_tab = mean_kl(fit("categorical_table"))
    kl_emb = mean_kl(fit("categorical_embedded_softmax", embedding_dim=8,
                         fit=dict(EMB_FIT)))
    assert np.isfinite(kl_emb)
    assert kl_emb <= 2.0 * kl_tab + 1e-3, (kl_emb, kl_tab)
