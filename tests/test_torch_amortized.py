"""The port's amortized learner and amortized inference against the JAX
package's, on the CPU, at a small size (a few hundred rows, hidden 16, a
few epochs).

- the catalog: ``defaults.learning("amortized")`` and the new inference
  entries equal the JAX YAML catalog's (PyYAML's "1e-3" strings cast);
- ``amortized_forward`` and ``node_distribution`` on the same net (a
  linear-Gaussian and a categorical one, the JAX fits): within 1e-5;
- training: the masks the port draws (``default_rng(seed + 17)``) equal the
  JAX package's, model-generated rows included; with ``interventional=
  False`` and ``n_obs_sets=0`` the training rows are equal, and training
  from JAX's initial MLP on full batches lands within 1e-4 of JAX's net;
- the model-generated rows: do'd values are the bootstrapped ones, the
  observational block has no do flag, every do'd value is visible;
- checkpoints: a JAX amortized checkpoint loads in the port with no
  warning and serves within 1e-5 (pmf; the served Gaussian draws' pdf is
  JAX's loc and scale's), and a port checkpoint serves in JAX likewise;
- the fallbacks (no net, a do on an observational net, a fixed target)
  carry the JAX package's reason text, and ``infer_posterior_many`` answers
  query by query.
"""

import warnings

import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch

from vectorizedbayesiannetwork_torch import VBN as TVBN
from vectorizedbayesiannetwork_torch import defaults as tdefaults
from vectorizedbayesiannetwork_torch import params_from_tree
from vectorizedbayesiannetwork_torch.config_cast import coerce_numbers
from vectorizedbayesiannetwork_torch.learning import amortized as tam
from vectorizedbayesiannetwork_tpu import VBN as JVBN
from vectorizedbayesiannetwork_tpu import defaults as jdefaults
from vectorizedbayesiannetwork_tpu.learning import amortized as jam

N = 300
SMALL = {"epochs": 2, "batch_size": 256, "hidden_dims": [16], "n_do_sets": 1,
         "n_obs_sets": 1}


@pytest.mark.parametrize("kind,name", [
    ("learning", "amortized"), ("inference", "lbp"),
    ("inference", "rao_blackwellized_marginalization"),
    ("inference", "amortized")])
def test_defaults_equal_jax_catalog(kind, name):
    ours = getattr(tdefaults, kind)(name)
    theirs = coerce_numbers(getattr(jdefaults, kind)(name), {
        "lr": "float", "min_scale": "float", "weight_decay": "float"})
    assert ours == theirs


def _lg_data(n=N, seed=0):
    g = np.random.default_rng(seed)
    x0 = g.normal(size=n)
    x1 = g.normal(size=n)
    x2 = 0.5 * x0 - 0.2 * x1 + 0.1 * g.normal(size=n)
    return {k: v.astype(np.float32).reshape(-1, 1)
            for k, v in {"x0": x0, "x1": x1, "x2": x2}.items()}


def _cat_data(n=N, seed=0):
    g = np.random.default_rng(seed)
    a = g.integers(0, 3, n)
    b = (a + (g.random(n) < 0.2)) % 3
    return {"a": a.astype(np.float32).reshape(-1, 1),
            "b": b.astype(np.float32).reshape(-1, 1)}


CASES = {
    "lg": ([("x0", "x2"), ("x1", "x2")], _lg_data,
           lambda d: d.cpd("linear_gaussian")),
    "cat": ([("a", "b")], _cat_data,
            lambda d: dict(d.cpd("categorical_table"), n_classes=3)),
}


def _fit(pkg, case, **kw):
    edges, data_fn, conf = CASES[case]
    data = data_fn()
    if pkg == "jax":
        v = JVBN(nx.DiGraph(edges), seed=0)
        d = jdefaults
    else:
        v = TVBN(edges, seed=0, device="cpu")
        d = tdefaults
    v.set_learning_method("amortized",
                          nodes_cpds={k: conf(d) for k in data},
                          **dict(SMALL, **kw))
    v.fit(data)
    return v


@pytest.fixture(scope="module")
def jax_fits():
    return {case: _fit("jax", case) for case in CASES}


def _inputs(spec, m=64, seed=0):
    g = np.random.default_rng(seed)
    rows = g.normal(size=(m, spec.total_dim)).astype(np.float32)
    mask = (g.random((m, spec.n_nodes)) < 0.5).astype(np.float32)
    do = (mask * (g.random((m, spec.n_nodes)) < 0.3)).astype(np.float32)
    return rows, mask, do


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_distribution_match_jax(jax_fits, case):
    jv = jax_fits[case]
    jspec, jnet = jv.amortized["spec"], jv.amortized["net"]
    tspec = tam.AmortizedSpec.from_dict(jspec.to_dict())
    assert tspec.to_dict() == jspec.to_dict() and tspec.interventional
    tnet = params_from_tree(jnet, "cpu")
    rows, mask, do = _inputs(tspec)
    jh = jam.amortized_forward(jspec, jnet, jnp.asarray(rows),
                               jnp.asarray(mask), jnp.asarray(do))
    th = tam.amortized_forward(tspec, tnet, torch.as_tensor(rows),
                               torch.as_tensor(mask), torch.as_tensor(do))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5)
    for i in range(tspec.n_nodes):
        for got, want in zip(tam.node_distribution(tspec, tnet, th, i),
                             jam.node_distribution(jspec, jnet, jh, i)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(tam._mask_expand_matrix(tspec),
                                  jam._mask_expand_matrix(jspec))


def _recording(monkeypatch, module, into):
    """Wrap ``module.fit_minibatch_nll`` to record its net, masks and rows
    (the JAX trainer takes (module, name, net, opt, key, parents, x), the
    port's (nll_fn, net, opt, gen, parents, x))."""
    orig = module.fit_minibatch_nll
    at = 2 if module is jam else 1

    def rec(*args, **kw):
        into["net"], into["masks"], into["rows"] = (
            args[at], args[at + 3], args[at + 4])
        return orig(*args, **kw)

    monkeypatch.setattr(module, "fit_minibatch_nll", rec)


@pytest.mark.parametrize("interventional", [False, True],
                         ids=["observational", "interventional"])
def test_training_matches_jax(monkeypatch, interventional):
    """Full batches (batch_size >= rows): the row order cannot change the
    mean NLL but by rounding. Observational with no model rows, the rows
    are the data's and training from JAX's initial MLP lands within 1e-4
    of JAX's net; interventional, the masks (model rows' included) are
    still equal, and so are the data rows and the do'd values."""
    kw = dict(interventional=interventional, batch_size=4096, epochs=3)
    if not interventional:
        kw["n_obs_sets"] = 0
    jrec, trec = {}, {}
    _recording(monkeypatch, jam, jrec)
    jv = _fit("jax", "lg", **kw)
    _recording(monkeypatch, tam, trec)
    init = params_from_tree(jrec["net"], "cpu")
    monkeypatch.setattr(tam, "mlp_init", lambda *a: init)
    tv = _fit("torch", "lg", **kw)
    np.testing.assert_array_equal(trec["masks"].numpy(),
                                  np.asarray(jrec["masks"]))
    jrows, trows = np.asarray(jrec["rows"]), trec["rows"].numpy()
    data_rows = 4 * N
    np.testing.assert_array_equal(trows[:data_rows], jrows[:data_rows])
    if interventional:
        spec = tv.amortized["spec"]
        do = np.asarray(jrec["masks"])[data_rows:, spec.n_nodes:] > 0
        np.testing.assert_array_equal(trows[data_rows:][do],
                                      jrows[data_rows:][do])
        assert do.any()
        return
    assert trows.shape == jrows.shape == (data_rows, 3)
    want, got = jv.amortized["net"], tv.amortized["net"]
    for k in ("mean", "std", "support"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for lg, lw in zip(got["mlp"]["layers"], want["mlp"]["layers"]):
        for k in ("w", "b"):
            np.testing.assert_allclose(lg[k].numpy(), np.asarray(lw[k]),
                                       atol=1e-4)


def test_model_rows_invariants():
    tv = _fit("torch", "lg")
    spec = tv.amortized["spec"]
    learner = tam.AmortizedLearner(n_do_sets=2, n_obs_sets=3)
    rows = np.concatenate([_lg_data()[n] for n in spec.topo], axis=-1)
    vals, obs, dos = learner._model_rows(tv, spec, rows,
                                         np.random.default_rng(0), 2, 3)
    m_int = N * 2
    assert vals.shape == (N * 5, 3) and np.isfinite(vals).all()
    assert (dos[m_int:] == 0).all() and dos[:m_int].any()
    assert (obs >= dos).all()
    # do'd entries hold values drawn from the data's marginals
    for i in range(spec.n_nodes):
        hit = dos[:, i] > 0
        assert np.isin(vals[hit, i], rows[:, i]).all()


def _served_gaussian_matches(pdf, samples, loc, scale):
    """The served draws' pdf is N(draw; loc, scale) within 1e-5 relative."""
    x = samples[..., 0]
    want = np.exp(-0.5 * ((x - loc) / scale) ** 2) / (np.sqrt(2 * np.pi)
                                                       * scale)
    np.testing.assert_allclose(pdf, want, rtol=1e-5, atol=0)


def _heads(pkg, v, query_rows, mask, do):
    mod = jam if pkg == "jax" else tam
    spec, net = v.amortized["spec"], v.amortized["net"]
    if pkg == "jax":
        h = mod.amortized_forward(spec, net, jnp.asarray(query_rows),
                                  jnp.asarray(mask), jnp.asarray(do))
    else:
        h = mod.amortized_forward(spec, net, torch.as_tensor(query_rows),
                                  torch.as_tensor(mask), torch.as_tensor(do))
    return [np.asarray(t) for t in mod.node_distribution(
        spec, net, h, spec.node_index(q_target(v)))]


def q_target(v):
    return "x2" if "x2" in v.amortized["spec"].topo else "b"


QUERY = {"lg": {"target": "x2", "evidence": {"x0": [[1.0]], "x1": [[0.0]]}},
         "cat": {"target": "b", "evidence": {"a": [[1.0]]}}}
QROW = {"lg": ([[1.0, 0.0, 0.0]], [[1.0, 1.0, 0.0]]),
        "cat": ([[1.0, 0.0]], [[1.0, 0.0]])}


def _serve_and_check(case, src_pkg, src, dst_pkg, dst):
    """dst serves the query as src's net predicts it."""
    rows, mask = (np.asarray(a, np.float32) for a in QROW[case])
    want = _heads(src_pkg, src, rows, mask, np.zeros_like(mask))
    got = _heads(dst_pkg, dst, rows, mask, np.zeros_like(mask))
    for g, w in zip(got, want):  # (pmf, support) or (loc, scale)
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)
    dst.set_inference_method("amortized", n_samples=256)
    pdf, samples = (np.asarray(t) for t in dst.infer_posterior(QUERY[case]))
    assert not dst._inference._last_fallback
    if case == "cat":
        np.testing.assert_allclose(pdf, want[0], atol=1e-5)
        np.testing.assert_array_equal(samples[0, :, 0], want[1])
    else:
        assert samples.shape == (1, 256, 1)
        _served_gaussian_matches(pdf, samples, want[0], want[1])


@pytest.mark.parametrize("case", sorted(CASES))
def test_jax_checkpoint_serves_in_port(jax_fits, tmp_path, case):
    jv = jax_fits[case]
    jv.save(str(tmp_path / "am.npz"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tv = TVBN.load(str(tmp_path / "am.npz"), device="cpu")
    assert tv.amortized["spec"].to_dict() == jv.amortized["spec"].to_dict()
    assert tv._learning_config["name"] == "amortized"
    _serve_and_check(case, "jax", jv, "torch", tv)


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_checkpoint_serves_in_jax(tmp_path, case):
    tv = _fit("torch", case)
    tv.save(str(tmp_path / "am.npz"))
    jv = JVBN.load(str(tmp_path / "am.npz"))
    assert jv.amortized["spec"].to_dict() == tv.amortized["spec"].to_dict()
    _serve_and_check(case, "torch", tv, "jax", jv)


def test_fallback_reasons_match_jax(jax_fits):
    jv = jax_fits["lg"]
    tv = _fit("torch", "lg")
    obs_j = _fit("jax", "lg", interventional=False)
    obs_t = _fit("torch", "lg", interventional=False)
    plain_t = TVBN([("x0", "x2"), ("x1", "x2")], seed=0, device="cpu")
    plain_t.set_learning_method("node_wise", nodes_cpds={
        k: tdefaults.cpd("linear_gaussian") for k in ("x0", "x1", "x2")})
    plain_t.fit(_lg_data())
    plain_j = JVBN(nx.DiGraph([("x0", "x2"), ("x1", "x2")]), seed=0)
    plain_j.set_learning_method("node_wise", nodes_cpds={
        k: jdefaults.cpd("linear_gaussian") for k in ("x0", "x1", "x2")})
    plain_j.fit(_lg_data())
    cases = [
        (plain_j, plain_t, {"target": "x2", "evidence": {"x0": [[1.0]]}}),
        (obs_j, obs_t, {"target": "x2", "do": {"x0": [[1.0]]}}),
        (jv, tv, {"target": "x2", "evidence": {"x2": [[1.0]]}}),
    ]
    for j, t, q in cases:
        for v in (j, t):
            v.set_inference_method("amortized", n_samples=128)
            pdf, _ = v.infer_posterior(q)
            assert np.isfinite(np.asarray(pdf)).all()
            assert v._inference._last_fallback
        assert t._inference._last_reason == j._inference._last_reason
    tv.set_inference_method("amortized", n_samples=64)
    res = tv.infer_posterior_many([QUERY["lg"],
                                   {"target": "x0", "evidence": {"x2": [[0.3]]}}])
    assert [r[1].shape for r in res] == [(1, 64, 1)] * 2
    assert not tv._inference._last_fallback
