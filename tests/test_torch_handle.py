"""The port's CPD handles and DAG queries against the JAX package's.

The JAX package fits asia (categorical tables) and the 3-node
linear-Gaussian flagship on rows made with numpy from a seed, saves each
checkpoint, and the port loads it on the CPU; both packages' handles then
answer the same calls. Tolerances: the CPD protocol methods compute the
same float32 expressions in the same order (a count row over its sum, a
log-floor and an exp; w.x + b and sqrt(max(var, min_scale^2))), so they
agree within float32 rounding of the two libraries' elementwise kernels:
rtol 1e-6 (probabilities), 1e-5 (log-densities, one more log and sum).
"""

import networkx as nx
import numpy as np
import pytest
import torch

from benchmarking.gaussian_bn import random_gaussian
from benchmarking.networks import asia
from test_torch_checkpoint import asia_setup, flagship_setup
from vectorizedbayesiannetwork_torch import VBN as TVBN
from vectorizedbayesiannetwork_torch.core.dag import StaticDAG as TDAG
from vectorizedbayesiannetwork_tpu import VBN as JVBN
from vectorizedbayesiannetwork_tpu import defaults as jdefaults
from vectorizedbayesiannetwork_tpu.core.dag import StaticDAG as JDAG


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    """(JAX model, the port's load of its checkpoint) for asia and the
    flagship."""
    bn, g, arrays, conf = asia_setup()
    ja = JVBN(g, seed=0)
    ja.set_learning_method("node_wise", nodes_cpds=conf(jdefaults))
    ja.fit(arrays)
    fg, farrays = flagship_setup()
    jf = JVBN(fg, seed=0)
    jf.set_learning_method(
        "node_wise",
        nodes_cpds={k: jdefaults.cpd("linear_gaussian") for k in farrays},
    )
    jf.fit(farrays)
    root = tmp_path_factory.mktemp("handles")
    ja.save(str(root / "asia.npz"))
    jf.save(str(root / "flagship.npz"))
    return {
        "asia": (ja, TVBN.load(str(root / "asia.npz"), device="cpu")),
        "flagship": (jf, TVBN.load(str(root / "flagship.npz"), device="cpu")),
        "bn": bn,
    }


def _gauss8_parents():
    gbn = random_gaussian(8, seed=0)
    return {n: gbn.parents[n] for n in gbn.nodes}


DAGS = {
    "asia": lambda: {n: asia().parents[n] for n in asia().nodes},
    "flagship": lambda: {"x0": [], "x1": [], "x2": ["x0", "x1"]},
    "gauss8": _gauss8_parents,
    "diamond_chain": lambda: {"a": [], "b": ["a"], "c": ["a"],
                              "d": ["b", "c"], "e": ["d"], "f": []},
}


@pytest.mark.parametrize("name", sorted(DAGS))
def test_dag_queries_match_jax(name):
    parents = DAGS[name]()
    ref = nx.DiGraph()
    ref.add_nodes_from(parents)
    ref.add_edges_from((p, n) for n in parents for p in parents[n])
    tdag, jdag = TDAG(parents), JDAG(ref)
    assert tdag.topological_levels() == jdag.topological_levels()
    for node in jdag.nodes():
        assert tdag.level_of(node) == jdag.level_of(node)
        assert tdag.descendants(node) == set(jdag.descendants(node))
        assert tdag.ancestors(node) == set(jdag.ancestors(node))


def _combos(cards):
    """Every parent class combination, [prod(cards), len(cards)]."""
    grids = np.meshgrid(*[np.arange(c) for c in cards], indexing="ij")
    return np.stack([x.reshape(-1) for x in grids], 1).astype(np.float32)


def test_asia_categorical_probs_and_log_prob_match_jax(loaded):
    ja, ta = loaded["asia"]
    bn = loaded["bn"]
    for node in bn.nodes:
        jh, th = ja.cpd(node), ta.cpd(node)
        cards = [bn.card(p) for p in bn.parents[node]]
        pv = _combos(cards) if cards else None
        jc = jh.conditional(pv)
        tc = th.conditional(pv)
        assert jc["type"] == tc["type"] == "categorical_probs"
        np.testing.assert_allclose(tc["probs"].numpy(), np.asarray(jc["probs"]),
                                   rtol=1e-6)
        np.testing.assert_array_equal(tc["support"].numpy(),
                                      np.asarray(jc["support"]))
        for got, want in zip(th.conditional_mean_std(pv),
                             jh.conditional_mean_std(pv)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-7)
        m = 1 if pv is None else pv.shape[0]
        x = (np.arange(m) % bn.card(node)).astype(np.float32).reshape(-1, 1)
        parents = None if pv is None else {
            p: pv[:, j] for j, p in enumerate(bn.parents[node])}
        np.testing.assert_allclose(th.log_prob(x, parents).numpy(),
                                   np.asarray(jh.log_prob(x, parents)),
                                   rtol=1e-5)
        np.testing.assert_allclose(th.pdf(x, parents).numpy(),
                                   np.asarray(jh.pdf(x, parents)), rtol=1e-5)


def test_flagship_conditional_params_and_log_prob_match_jax(loaded):
    jf, tf = loaded["flagship"]
    rng = np.random.default_rng(3)
    pv = rng.normal(size=(64, 2)).astype(np.float32)
    x = rng.normal(size=(64, 1)).astype(np.float32)
    for node, parents in (("x2", pv), ("x0", None)):
        jh, th = jf.cpd(node), tf.get_cpd(node)
        jc, tc = jh.conditional(parents), th.conditional(parents)
        assert jc["type"] == tc["type"] == "normal_params"
        np.testing.assert_allclose(tc["loc"].numpy(), np.asarray(jc["loc"]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tc["scale"].numpy(),
                                   np.asarray(jc["scale"]), rtol=1e-6)
        xx = x if parents is not None else x[:1]
        np.testing.assert_allclose(th.log_prob(xx, parents).numpy(),
                                   np.asarray(jh.log_prob(xx, parents)),
                                   rtol=1e-5)
    # parents by name, one row broadcast against many
    as_dict = {"x0": pv[:, 0], "x1": pv[:1, 1]}
    np.testing.assert_allclose(
        tf.cpd("x2").conditional_mean_std(as_dict)[0].numpy(),
        np.asarray(jf.cpd("x2").conditional_mean_std(as_dict)[0]), rtol=1e-6,
        atol=1e-7)


@pytest.mark.parametrize("model", ["asia", "flagship"])
def test_handle_summaries_and_exports_match_jax(loaded, model):
    jv, tv = loaded[model]
    assert sorted(tv.get_cpds()) == sorted(jv.get_cpds())
    for node, th in tv.get_cpds().items():
        jh = jv.get_cpd(node)
        assert th.summary() == jh.summary()
        assert th.export_config() == jh.export_config()
        spec, params = th.clone_cpd()
        assert spec.static_signature() == th.cpd.static_signature()
        assert params is not th.params
        for k, v in params.items():
            assert torch.equal(v, th.params[k])


def test_handle_samples_and_refusals(loaded):
    _, tf = loaded["flagship"]
    h = tf.cpd("x2")
    draws = h.sample({"x0": [0.5], "x1": [-0.5]}, n_samples=4096)
    assert draws.shape == (1, 4096, 1)
    loc, scale = h.conditional_mean_std({"x0": [0.5], "x1": [-0.5]})
    assert abs(float(draws.mean()) - float(loc)) < 5 * float(scale) / 64
    out = h.forward({"x0": [0.5], "x1": [-0.5]}, n_samples=16)
    torch.testing.assert_close(out.pdf, torch.exp(out.log_prob))
    with pytest.raises(ValueError, match="requires parent values"):
        h.sample(None)
    with pytest.raises(ValueError, match="Missing parent value"):
        h.log_prob([[0.0]], {"x0": [0.0]})
    with pytest.raises(ValueError, match="Unknown node"):
        tf.cpd("nope")
