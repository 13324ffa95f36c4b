"""PyTorch port vs the JAX package: DAG order, plans, checkpoints, fits.

The same data (made with numpy from a seed) is fitted by both packages;
the JAX model is saved and loaded by the port, and both sides must agree on
the topological order, the inference plan and packed query rows, and the
fitted parameters.
"""

import networkx as nx
import numpy as np
import pytest
import torch

from benchmarking.data_gen import generate_dataset
from benchmarking.networks import asia
from vectorizedbayesiannetwork_torch import VBN as TVBN
from vectorizedbayesiannetwork_torch import defaults as tdefaults
from vectorizedbayesiannetwork_torch.config_cast import (
    CPD_SCHEMAS,
    FIT_SCHEMA,
    coerce_numbers,
)
from vectorizedbayesiannetwork_torch.core.base import Query as TQuery
from vectorizedbayesiannetwork_torch.core.dag import StaticDAG as TDAG
from vectorizedbayesiannetwork_torch.core.plan import get_plan as t_get_plan
from vectorizedbayesiannetwork_torch.core.plan import (
    pack_fixed_values as t_pack,
)
from vectorizedbayesiannetwork_tpu import VBN as JVBN
from vectorizedbayesiannetwork_tpu import defaults as jdefaults
from vectorizedbayesiannetwork_tpu.core.base import Query as JQuery
from vectorizedbayesiannetwork_tpu.core.dag import StaticDAG as JDAG
from vectorizedbayesiannetwork_tpu.core.plan import get_plan as j_get_plan
from vectorizedbayesiannetwork_tpu.core.plan import (
    pack_fixed_values as j_pack,
)


def asia_setup():
    bn = asia()
    data = generate_dataset(bn, 4096, seed=0)
    arrays = {
        k: np.asarray(v, np.float32).reshape(-1, 1) for k, v in data.items()
    }
    g = nx.DiGraph()
    g.add_nodes_from(bn.nodes)
    g.add_edges_from(bn.edges())

    def conf(defaults):
        out = {}
        for node in bn.nodes:
            c = dict(defaults.cpd("categorical_table"), n_classes=bn.card(node))
            if bn.parents[node]:
                c["parent_n_classes"] = [bn.card(p) for p in bn.parents[node]]
            out[node] = c
        return out

    return bn, g, arrays, conf


def flagship_setup(n=4096, seed=0):
    g = np.random.default_rng(seed)
    x0 = g.normal(size=n)
    x1 = g.normal(size=n)
    x2 = 0.5 * x0 - 0.2 * x1 + 0.1 * g.normal(size=n)
    arrays = {
        k: v.astype(np.float32).reshape(-1, 1)
        for k, v in {"x0": x0, "x1": x1, "x2": x2}.items()
    }
    return nx.DiGraph([("x0", "x2"), ("x1", "x2")]), arrays


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """JAX fits of asia and the flagship, saved; the port's own fits."""
    bn, g, arrays, conf = asia_setup()
    jv = JVBN(g, seed=0)
    jv.set_learning_method("node_wise", nodes_cpds=conf(jdefaults))
    jv.fit(arrays)
    tv = TVBN(g, seed=0, device="cpu")
    tv.set_learning_method("node_wise", nodes_cpds=conf(tdefaults))
    tv.fit(arrays)

    fg, farrays = flagship_setup()
    jf = JVBN(fg, seed=0)
    jf.set_learning_method(
        "node_wise",
        nodes_cpds={k: jdefaults.cpd("linear_gaussian") for k in farrays},
    )
    jf.fit(farrays)
    tf = TVBN(fg, seed=0, device="cpu")
    tf.set_learning_method(
        "node_wise",
        nodes_cpds={k: tdefaults.cpd("linear_gaussian") for k in farrays},
    )
    tf.fit(farrays)

    root = tmp_path_factory.mktemp("ckpt")
    jv.save(str(root / "asia"))
    jf.save(str(root / "flagship.npz"))
    return {
        "bn": bn,
        "jax_asia": jv,
        "torch_asia": tv,
        "loaded_asia": TVBN.load(str(root / "asia"), device="cpu"),
        "jax_lg": jf,
        "torch_lg": tf,
        "loaded_lg": TVBN.load(str(root / "flagship.npz"), device="cpu"),
        "root": root,
    }


GRAPHS = {
    "asia_digraph": lambda: asia_setup()[1],
    "asia_parents": lambda: {n: asia().parents[n] for n in asia().nodes},
    "flagship_edges": lambda: [("x0", "x2"), ("x1", "x2")],
    "chain_reversed": lambda: [("c", "d"), ("b", "c"), ("a", "b"), ("a", "d")],
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_dag_order_matches_networkx(name):
    graph = GRAPHS[name]()
    if isinstance(graph, dict):
        ref = nx.DiGraph()
        ref.add_nodes_from(graph)
        ref.add_edges_from((p, n) for n in graph for p in graph[n])
    else:
        ref = graph if isinstance(graph, nx.DiGraph) else nx.DiGraph(graph)
    tdag, jdag = TDAG(graph), JDAG(ref)
    assert tdag.topological_order() == tuple(nx.topological_sort(ref))
    assert tdag.topological_order() == jdag.topological_order()
    for node in jdag.nodes():
        assert tdag.parents(node) == jdag.parents(node)
        assert tdag.children(node) == jdag.children(node)
    assert list(tdag.edges()) == list(ref.edges())


def test_dag_rejects_cycle():
    with pytest.raises(ValueError, match="DAG"):
        TDAG([("a", "b"), ("b", "a")])


@pytest.mark.parametrize("which", ["asia", "lg"])
def test_loaded_plan_and_packing_match(fitted, which):
    jv, tv = fitted[f"jax_{which}"], fitted[f"loaded_{which}"]
    assert tv.dag.topological_order() == jv.dag.topological_order()
    if which == "asia":
        ev = {
            "smoke": np.array([[1.0], [0.0], [np.nan]], np.float32),
            "asia": np.array([[0.0], [1.0], [np.inf]], np.float32),
        }
        target, do = "dysp", {"xray": np.ones((3, 1), np.float32)}
    else:
        ev = {"x0": np.array([[0.5], [-2.0], [np.inf]], np.float32)}
        target, do = "x2", {"x1": np.full((3, 1), 0.25, np.float32)}
    jp = j_get_plan(jv, JQuery(target=target, evidence=ev, do=do))
    tp = t_get_plan(tv, TQuery(target=target, evidence=ev, do=do))
    for field in ("topo_order", "node_dims", "node_offsets", "total_dim",
                  "parent_idx", "evidence_mask", "do_mask", "target_idx"):
        assert getattr(tp, field) == getattr(jp, field), field
    for clamp in (False, True):
        np.testing.assert_array_equal(
            t_pack(TQuery(target, ev, do), tp, 3, clamp_obs=clamp),
            j_pack(JQuery(target, ev, do), jp, 3, clamp_obs=clamp),
        )


def _np_params(params):
    return {k: np.asarray(v) for k, v in params.items()}


def test_loaded_params_and_state_match(fitted):
    for which in ("asia", "lg"):
        jv, tv = fitted[f"jax_{which}"], fitted[f"loaded_{which}"]
        for node in jv.dag.nodes():
            jc, tc = jv.nodes[node], tv.nodes[node]
            assert tc.registry_key == jc.registry_key
            assert tc.get_init_kwargs() == jc.get_init_kwargs()
            assert tc.get_extra_state() == jc.get_extra_state()
            jp = _np_params(jv.params[node])
            tp = {k: v.numpy() for k, v in tv.params[node].items()}
            assert sorted(tp) == sorted(jp)
            for k in jp:
                np.testing.assert_array_equal(tp[k], jp[k])
                assert tp[k].dtype == jp[k].dtype


def test_own_fit_counts_equal_jax(fitted):
    jv, tv = fitted["jax_asia"], fitted["torch_asia"]
    for node in jv.dag.nodes():
        jc, tc = jv.nodes[node], tv.nodes[node]
        assert tc._static_fields() == jc._static_fields()
        assert tc._strides == jc._strides
        assert tc._parent_states == jc._parent_states
        for k, v in jv.params[node].items():
            np.testing.assert_array_equal(
                tv.params[node][k].numpy(), np.asarray(v), err_msg=f"{node}/{k}"
            )


@pytest.mark.parametrize("prior,alpha_mode", [
    ("uniform", "per_class"), ("global", "per_class"), ("uniform", "total_mass"),
])
def test_smoothing_variants_equal_jax(prior, alpha_mode):
    """Inferred supports (no declared classes) and every smoothing rule."""
    rng = np.random.default_rng(4)
    a = rng.integers(0, 3, size=500).astype(np.float32) * 2.0  # {0, 2, 4}
    b = ((a / 2 + rng.integers(0, 2, size=500)) % 3).astype(np.float32)
    arrays = {"a": a.reshape(-1, 1), "b": b.reshape(-1, 1)}
    conf = {"cpd": "categorical_table", "alpha": 0.5, "prior": prior,
            "alpha_mode": alpha_mode}
    jv = JVBN(nx.DiGraph([("a", "b")]), seed=0)
    jv.set_learning_method("node_wise", nodes_cpds={"a": conf, "b": conf})
    jv.fit(arrays)
    tv = TVBN([("a", "b")], seed=0, device="cpu")
    tv.set_learning_method("node_wise", nodes_cpds={"a": conf, "b": conf})
    tv.fit(arrays)
    for node in ("a", "b"):
        assert tv.nodes[node].get_extra_state() == jv.nodes[node].get_extra_state()
        for k, v in jv.params[node].items():
            # XLA:CPU divides the uniform prior by an approximate
            # reciprocal, so smoothed counts may differ in the last ulp.
            np.testing.assert_allclose(
                tv.params[node][k].numpy(), np.asarray(v), rtol=1e-6, atol=0,
                err_msg=f"{node}/{k}",
            )


def test_own_fit_lg_close_to_jax(fitted):
    jv, tv = fitted["jax_lg"], fitted["torch_lg"]
    for node in jv.dag.nodes():
        assert tv.nodes[node].get_init_kwargs() == jv.nodes[node].get_init_kwargs()
        for k in ("weight", "bias", "var"):
            np.testing.assert_allclose(
                tv.params[node][k].numpy(), np.asarray(jv.params[node][k]),
                atol=1e-5, err_msg=f"{node}/{k}",
            )


def test_log_prob_flat_matches_jax(fitted):
    """Both CPD families' log-densities agree on the same inputs."""
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    for which, node in (("asia", "dysp"), ("asia", "smoke"), ("lg", "x2")):
        jv, tv = fitted[f"jax_{which}"], fitted[f"loaded_{which}"]
        jc, tc = jv.nodes[node], tv.nodes[node]
        m = 64
        if which == "asia":
            x = rng.integers(0, 2, size=(m, 1)).astype(np.float32)
            p = rng.integers(0, 2, size=(m, jc.input_dim)).astype(np.float32)
        else:
            x = rng.normal(size=(m, 1)).astype(np.float32)
            p = rng.normal(size=(m, jc.input_dim)).astype(np.float32)
        p_j = jnp.asarray(p) if jc.input_dim else None
        p_t = torch.as_tensor(p) if jc.input_dim else None
        want = np.asarray(jc._log_prob_flat(jv.params[node], jnp.asarray(x), p_j))
        got = tc._log_prob_flat(tv.params[node], torch.as_tensor(x), p_t)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_port_save_loads_in_jax(fitted):
    """The port writes the JAX checkpoint format: JAX reads it back."""
    path = str(fitted["root"] / "port_asia")
    fitted["torch_asia"].save(path)
    back = JVBN.load(path)
    tv = fitted["torch_asia"]
    assert back.dag.topological_order() == tv.dag.topological_order()
    for node in tv.dag.nodes():
        assert back.nodes[node].get_extra_state() == tv.nodes[node].get_extra_state()
        for k, v in tv.params[node].items():
            np.testing.assert_array_equal(np.asarray(back.params[node][k]), v.numpy())


@pytest.mark.parametrize("kind,name", [
    ("cpd", "categorical_table"), ("cpd", "linear_gaussian"),
    ("learning", "node_wise"), ("inference", "likelihood_weighting"),
    ("inference", "monte_carlo_marginalization"),
])
def test_defaults_equal_jax_yaml(kind, name):
    """The port's Python-dict defaults are the JAX package's YAML ones, with
    the numbers PyYAML leaves as strings ("1e-3") cast by coerce_numbers."""
    ours = getattr(tdefaults, kind)(name)
    theirs = getattr(jdefaults, kind)(name)
    if kind == "cpd":
        theirs = coerce_numbers(theirs, CPD_SCHEMAS[name])
        for sub in ("fit", "update"):
            theirs[sub] = coerce_numbers(theirs[sub], FIT_SCHEMA)
    else:
        theirs = coerce_numbers(theirs, {"eps": "float"})
    assert ours == theirs
    assert not any(isinstance(v, str) for k, v in ours.items()
                   if k not in ("cpd", "name", "alpha_mode", "prior",
                                "default_cpd"))
