"""Resampled and plain importance sampling in the port, as a whole, on the
CPU, against the JAX package and exact posteriors.

One model per network is fitted and saved by the JAX package with RIS or
IS set as its inference method, and loaded by the port's ``VBN.load``,
which restores that method. The JAX side runs on the CPU through its XLA
paths and the port through its kernels' plain versions, so their draws
differ and only distributions compare. Monte-Carlo limits: 4 standard
errors, taken from the posterior's exact std and the effective sample
size that the run reports (before resampling, for RIS: a resampled set
holds no more distinct particles than that ESS).
"""

import networkx as nx
import numpy as np
import pytest
import torch

from benchmarking.gaussian_bn import GaussianBN
from vectorizedbayesiannetwork_torch import VBN as TVBN
from vectorizedbayesiannetwork_torch.core.base import Query
from vectorizedbayesiannetwork_torch.core.plan import get_plan
from vectorizedbayesiannetwork_torch.inference.resampled_importance_sampling import (
    live_after,
)
from vectorizedbayesiannetwork_tpu import VBN as JVBN
from vectorizedbayesiannetwork_tpu import defaults as jdefaults

B = 4
S = 1 << 13


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """x0 -> x2 <- x1 fitted by JAX on 4096 rows (tpu_study.py:32-46),
    saved with RIS set, and the port's load of it."""
    g = np.random.default_rng(0)
    n = 4096
    x0, x1 = g.normal(size=n), g.normal(size=n)
    x2 = 0.5 * x0 - 0.2 * x1 + 0.1 * g.normal(size=n)
    jv = JVBN(nx.DiGraph([("x0", "x2"), ("x1", "x2")]), seed=0)
    jv.set_learning_method(
        "node_wise",
        nodes_cpds={k: jdefaults.cpd("linear_gaussian") for k in ("x0", "x1", "x2")},
    )
    jv.fit({"x0": x0[:, None], "x1": x1[:, None], "x2": x2[:, None]})
    jv.set_inference_method("resampled_importance_sampling", n_samples=S,
                            ess_threshold=0.5)
    path = tmp_path_factory.mktemp("flagship")
    jv.save(str(path))
    tv = TVBN.load(str(path), device="cpu")
    m = tv._inference
    assert type(m).__name__ == "ResampledImportanceSampling"
    assert (m.n_samples, m.ess_threshold, m.resample_method) == (
        S, 0.5, "systematic")
    return jv, tv


@pytest.fixture(scope="module")
def cat2(tmp_path_factory):
    """a -> b, 3 classes each (tests/test_inference.py:29-49), saved by JAX
    with IS set."""
    g = np.random.default_rng(0)
    a = g.integers(0, 3, 1200)
    b = (a + g.integers(0, 2, 1200)) % 3
    jv = JVBN(nx.DiGraph([("a", "b")]), seed=0)
    jv.set_learning_method(
        "node_wise",
        nodes_cpds={
            "a": {**jdefaults.cpd("categorical_table"), "n_classes": 3},
            "b": {**jdefaults.cpd("categorical_table"), "n_classes": 3,
                  "parent_n_classes": [3]},
        },
    )
    jv.fit({"a": a.astype(np.float32)[:, None], "b": b.astype(np.float32)[:, None]})
    jv.set_inference_method("importance_sampling", n_samples=S)
    path = tmp_path_factory.mktemp("cat2")
    jv.save(str(path))
    tv = TVBN.load(str(path), device="cpu")
    assert type(tv._inference).__name__ == "ImportanceSampling"
    assert tv._inference.n_samples == S
    return jv, tv


def _diag_query(x2):
    x2 = np.asarray(x2, np.float32).reshape(-1, 1)
    return {"target": "x0", "evidence": {"x2": x2}}


def _closed_form(tv, x2):
    """Exact (mean, std) of x0 | x2 under the port's loaded parameters."""
    fit = GaussianBN(name="fitted")
    for node in tv.dag.topological_order():
        p = tv.params[node]
        fit.nodes.append(node)
        fit.parents[node] = list(tv.dag.parents(node))
        fit.weights[node] = p["weight"][:, 0].double().tolist()
        fit.bias[node] = float(p["bias"][0])
        fit.sigma[node] = float(np.sqrt(max(float(p["var"][0]),
                                            tv.nodes[node].min_scale ** 2)))
    return np.array([fit.conditional("x0", {"x2": float(v)}) for v in x2])


def _moments(vbn, pdf, samples):
    st = vbn._posterior_stats(torch.as_tensor(np.array(pdf)),
                              torch.as_tensor(np.array(samples)))
    return np.stack([np.asarray(st["mean"])[:, 0], np.asarray(st["std"])[:, 0]], 1)


def _within(got, want, sd, ess, k=4.0):
    """|d mean| <= k se and |d std| <= k se / sqrt(2) per row, with
    se = sd * sqrt(sum over the sides of 1/ess + 1/S)."""
    inv = sum(1.0 / np.asarray(e, np.float64) + 1.0 / S for e in ess)
    se = sd * np.sqrt(inv)
    assert np.all(np.abs(got[:, 0] - want[:, 0]) <= k * se), (got, want, se)
    assert np.all(np.abs(got[:, 1] - want[:, 1]) <= k * se / np.sqrt(2)), (
        got, want, se)


@pytest.mark.parametrize("method", ["systematic", "multinomial"])
def test_ris_flagship_matches_jax_and_closed_form(flagship, method):
    jv, tv = flagship
    x2 = np.linspace(-1, 1, B)
    q = _diag_query(x2)
    for v in (jv, tv):
        v.set_inference_method("resampled_importance_sampling", n_samples=S,
                               ess_threshold=0.5, resample_method=method)
    jw, js = jv.infer_posterior(q)
    tw, ts = tv.infer_posterior(q)
    assert tv._inference._last_resampled and jv._inference._last_resampled
    # after the reset every row's weights are uniform
    np.testing.assert_allclose(tw.numpy(), 1.0 / S, rtol=1e-5)
    got, jax_rows = _moments(tv, tw, ts), _moments(tv, jw, js)
    exact = _closed_form(tv, x2)
    t_ess = tv._inference._last_ess.numpy()
    j_ess = np.asarray(jv._inference._last_ess)
    _within(got, exact, exact[:, 1], [t_ess])
    _within(got, jax_rows, exact[:, 1], [t_ess, j_ess])


def test_ris_categorical_pmf_matches_exact(cat2):
    jv, tv = cat2
    tv.set_inference_method("resampled_importance_sampling", n_samples=S,
                            ess_threshold=0.9)
    w, s = tv.infer_posterior({"target": "a", "evidence": {"b": [[2.0]]}})
    assert tv._inference._last_resampled
    pmf = np.bincount(s[0, :, 0].long().numpy(), weights=w[0].double().numpy(),
                      minlength=3)
    pa = tv.params["a"]["counts"][0].double().numpy()
    pb = tv.params["b"]["counts"][0].double().numpy()
    post = pa / pa.sum() * (pb[:, 2] / pb.sum(axis=1))
    post = post / post.sum()
    ess = float(tv._inference._last_ess[0])
    se = np.sqrt(post * (1 - post) * (1.0 / ess + 1.0 / S))
    assert np.all(np.abs(pmf - post) <= 4 * se + 1e-9), (pmf, post, se)


def test_ris_threshold_rules(flagship):
    _jv, tv = flagship
    q = _diag_query([0.2, -0.4])
    tv.set_inference_method("resampled_importance_sampling", n_samples=S,
                            ess_threshold=1e12)  # absolute: always below
    tv.infer_posterior(q)
    assert tv._inference._last_resampled
    tv.set_inference_method("resampled_importance_sampling", n_samples=S,
                            ess_threshold=2.0)  # absolute: never below
    w, _ = tv.infer_posterior(q)
    assert not tv._inference._last_resampled
    assert float(w.std()) > 0  # weights kept, not reset
    tv.set_inference_method("resampled_importance_sampling", n_samples=S,
                            resample=False)
    tv.infer_posterior(q)
    assert not tv._inference._last_resampled
    np.testing.assert_array_equal(tv._inference._last_ess.numpy(), float(S))


def test_live_after_leaves_fixed_nodes_alone(flagship):
    _jv, tv = flagship
    plan = get_plan(tv, Query(target="x0", evidence={"x2": np.zeros((1, 1))},
                              do={"x1": np.zeros((1, 1))}))
    order = list(plan.topo_order)
    i2 = order.index("x2")
    # x1 is fixed (do), x2 is the evidence itself: only the target moves
    assert live_after(plan, i2) == [order.index("x0")]
    plan = get_plan(tv, Query(target="x1", evidence={"x2": np.zeros((1, 1))},
                              do={"x1": np.zeros((1, 1))}))
    assert live_after(plan, i2) == []
    # served: a do'd target keeps its value through the resampling event
    tv.set_inference_method("resampled_importance_sampling", n_samples=S,
                            ess_threshold=0.99)
    _w, s = tv.infer_posterior({"target": "x1", "evidence": {"x2": [[0.8]]},
                                "do": {"x1": [[0.7]]}})
    assert tv._inference._last_resampled
    assert torch.all(s == torch.tensor(0.7, dtype=torch.float32))


@pytest.mark.parametrize("dynamic", [False, True])
def test_is_fallback_and_rows_match_jax(flagship, dynamic):
    """Row 0 keeps its IS weights, row 1 (x2 = 1, 1.8 prior sds out)
    collapses below 0.1 S and takes the LW rerun; each row within MC error
    of the closed form and of JAX's IS on the same checkpoint."""
    jv, tv = flagship
    x2 = np.array([-0.3, 1.0])
    q = _diag_query(x2)
    for v in (jv, tv):
        v.set_inference_method("importance_sampling", n_samples=S,
                               dynamic_masks=dynamic)
    jw, js = jv.infer_posterior(q)
    tw, ts = tv.infer_posterior(q)
    assert tv._inference._last_fallback and jv._inference._last_fallback
    ess_first = tv._inference._last_ess.numpy()
    assert ess_first[0] >= 0.1 * S > ess_first[1]
    t_ess = tv._posterior_stats(tw, ts)["ess"].numpy()
    j_ess = 1.0 / np.sum(np.asarray(jw, np.float64) ** 2, axis=1)
    exact = _closed_form(tv, x2)
    got = _moments(tv, tw, ts)
    _within(got, exact, exact[:, 1], [t_ess])
    _within(got, _moments(tv, jw, js), exact[:, 1], [t_ess, j_ess])


def test_is_dynamic_categorical_rides_the_scan_route(cat2):
    """On an all-categorical network the dynamic IS sweeps take the scan
    kernel's route (its plain version here); rows within MC error of the
    exact posterior and of JAX's dynamic IS, one row per query."""
    jv, tv = cat2
    qs = [{"target": "a", "evidence": {"b": [[v]]}} for v in (0.0, 1.0, 2.0)]
    for v in (jv, tv):
        v.set_inference_method("importance_sampling", n_samples=S,
                               dynamic_masks=True)
    plan = tv._inference._canonical_plan(tv)
    cpds = tuple(tv.cpd_spec(n) for n in plan.topo_order)
    assert tv._inference._fused_dyn_raw(plan, cpds, S, ("logw",)) is not None
    t_rows = tv.infer_posterior_many(qs)
    j_rows = jv.infer_posterior_many(qs)
    pa = tv.params["a"]["counts"][0].double().numpy()
    pb = tv.params["b"]["counts"][0].double().numpy()
    for val, (tw, ts), (jw, js) in zip((0, 1, 2), t_rows, j_rows):
        post = pa / pa.sum() * (pb[:, val] / pb.sum(axis=1))
        post = post / post.sum()
        pmfs = []
        for w, s in ((tw, ts), (jw, js)):
            w = np.asarray(w, np.float64)[0]
            pmfs.append(np.bincount(np.asarray(s)[0, :, 0].astype(int),
                                    weights=w, minlength=3))
        ess = 1.0 / np.sum(np.asarray(tw, np.float64)[0] ** 2)
        se = np.sqrt(post * (1 - post) / ess)
        assert np.all(np.abs(pmfs[0] - post) <= 4 * se + 1e-9)
        assert np.all(np.abs(pmfs[0] - pmfs[1]) <= 4 * np.sqrt(2) * se + 1e-9)


def test_is_dynamic_sanitizes_nan_evidence_on_the_scan_route(cat2):
    """NaN evidence is read as class 0 by both sweeps of the scan route
    (``pack_rows``), so on the same draws it gives the answer, the ESS and
    the collapse decision of evidence 0."""
    _jv, tv = cat2
    tv.set_inference_method("importance_sampling", n_samples=S,
                            dynamic_masks=True)
    at = tv._keys.state()
    out = []
    for v in (float("nan"), 0.0):
        tv._keys.set_state(at)
        w, s = tv.infer_posterior({"target": "a", "evidence": {"b": [[v]]}})
        out.append((w, s, tv._inference._last_ess, tv._inference._last_fallback))
    for a, b in zip(out[0][:3], out[1][:3]):
        assert torch.equal(a, b)
    assert out[0][3] == out[1][3]
    assert torch.isfinite(out[0][0]).all()
