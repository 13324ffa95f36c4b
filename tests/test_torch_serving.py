"""The port's fit -> serve slice as a whole, against exact answers and the
JAX package.

Asia (likelihood weighting, pmf rows) and the linear-Gaussian flagship
(Monte-Carlo marginalization, (mean, std) rows) are served through the
port's public entry points on the CPU, where the fused sweep runs its plain
version. The JAX side serves the same checkpoint through its static fused
path (``VBN_FUSED_SWEEP=always``, interpret mode).
"""

import subprocess
import sys

import networkx as nx
import numpy as np
import pytest
import torch

from benchmarking.data_gen import generate_dataset
from benchmarking.exact import exact_posterior
from benchmarking.networks import asia
from vectorizedbayesiannetwork_torch import VBN as TVBN
from vectorizedbayesiannetwork_torch import defaults as tdefaults
from vectorizedbayesiannetwork_tpu import VBN as JVBN
from vectorizedbayesiannetwork_tpu import defaults as jdefaults

B = 4
S = 1 << 14


def _asia_query(b=B):
    return {
        "target": "dysp",
        "evidence": {
            "smoke": np.ones((b, 1), np.float32),
            "asia": np.zeros((b, 1), np.float32),
        },
    }


def _flagship_query(b=B):
    return {
        "target": "x2",
        "evidence": {
            "x0": np.linspace(-1, 1, b).reshape(b, 1).astype(np.float32),
            "x1": np.linspace(1, -1, b).reshape(b, 1).astype(np.float32),
        },
    }


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """JAX-fitted asia and flagship, and the port's loads of them."""
    bn = asia()
    data = generate_dataset(bn, 4096, seed=0)
    g = nx.DiGraph()
    g.add_nodes_from(bn.nodes)
    g.add_edges_from(bn.edges())
    ja = JVBN(g, seed=0)
    conf = {}
    for node in bn.nodes:
        c = dict(jdefaults.cpd("categorical_table"), n_classes=bn.card(node))
        if bn.parents[node]:
            c["parent_n_classes"] = [bn.card(p) for p in bn.parents[node]]
        conf[node] = c
    ja.set_learning_method("node_wise", nodes_cpds=conf)
    ja.fit({k: np.asarray(v, np.float32).reshape(-1, 1) for k, v in data.items()})
    ja.set_inference_method("likelihood_weighting", n_samples=S)

    rng = np.random.default_rng(0)
    n = 4096
    x0, x1 = rng.normal(size=n), rng.normal(size=n)
    x2 = 0.5 * x0 - 0.2 * x1 + 0.1 * rng.normal(size=n)
    jf = JVBN(nx.DiGraph([("x0", "x2"), ("x1", "x2")]), seed=0)
    jf.set_learning_method(
        "node_wise",
        nodes_cpds={k: jdefaults.cpd("linear_gaussian") for k in ("x0", "x1", "x2")},
    )
    jf.fit({"x0": x0, "x1": x1, "x2": x2})
    jf.set_inference_method("monte_carlo_marginalization", n_samples=S)

    root = tmp_path_factory.mktemp("serve")
    ja.save(str(root / "asia"))
    jf.save(str(root / "flagship"))
    return {
        "bn": bn,
        "jax_asia": ja,
        "jax_lg": jf,
        "asia": TVBN.load(str(root / "asia"), device="cpu"),
        "lg": TVBN.load(str(root / "flagship"), device="cpu"),
    }


def test_loaded_inference_config(models):
    """The checkpoint's inference method and its n_samples carry over."""
    assert models["asia"]._inference_config["name"] == "likelihood_weighting"
    assert models["asia"]._inference.n_samples == S
    assert models["lg"]._inference_config["name"] == "monte_carlo_marginalization"


def test_asia_pmf_matches_exact(models):
    tv = models["asia"]
    pmf, spans = tv.infer_posterior_pmf([_asia_query()], n_classes=2)
    assert tv._last_summary_path == "fused"
    assert pmf.shape == (B, 2) and spans == [(0, B, 7)]
    pmf = pmf / pmf.sum(axis=1, keepdims=True)
    exact = exact_posterior(models["bn"], "dysp", {"smoke": 1, "asia": 0})
    assert np.abs(pmf - exact[None]).max() < 0.05


def test_asia_pmf_matches_jax(models, monkeypatch):
    monkeypatch.setenv("VBN_FUSED_SWEEP", "always")
    jp, _ = models["jax_asia"].infer_posterior_pmf([_asia_query()], n_classes=2)
    tp, _ = models["asia"].infer_posterior_pmf([_asia_query()], n_classes=2)
    jp = jp / jp.sum(axis=1, keepdims=True)
    tp = tp / tp.sum(axis=1, keepdims=True)
    # both are LW estimates at S = 2^14 with constant weights here (the
    # evidence nodes are roots): each row's sd is ~0.004
    assert np.abs(tp.mean(0) - jp.mean(0)).max() < 0.02
    assert np.abs(tp - jp).max() < 0.03


def _closed_form(tv, ev):
    p = tv.params["x2"]
    w = p["weight"][:, 0].double().numpy()
    mean = ev["x0"][:, 0] * w[0] + ev["x1"][:, 0] * w[1] + float(p["bias"][0])
    sigma = np.sqrt(max(float(p["var"][0]), tv.nodes["x2"].min_scale ** 2))
    # MCM weights each draw by the target's own density: N(m, s^2) * N(m, s^2)
    # normalizes to N(m, s^2 / 2)
    return mean, sigma / np.sqrt(2.0)


def test_flagship_moments_match_closed_form_and_jax(models, monkeypatch):
    tv = models["lg"]
    q = _flagship_query()
    mom, spans = tv.infer_posterior_moments([q])
    assert tv._last_summary_path == "fused"
    assert mom.shape == (B, 2) and spans == [(0, B, 2)]
    mean, std = _closed_form(tv, q["evidence"])
    np.testing.assert_allclose(mom[:, 0], mean, atol=5e-3)
    np.testing.assert_allclose(mom[:, 1], std, atol=5e-3)
    monkeypatch.setenv("VBN_FUSED_SWEEP", "always")
    jmom, _ = models["jax_lg"].infer_posterior_moments([q])
    np.testing.assert_allclose(mom, jmom, atol=5e-3)


def test_flagship_posterior_takes_direct_path(models):
    """Both parents observed: MCM evaluates the target's CPD directly."""
    tv = models["lg"]
    q = _flagship_query()
    pdf, samples = tv.infer_posterior(q)
    assert pdf.shape == (B, S) and samples.shape == (B, S, 1)
    stats = tv._posterior_stats(pdf, samples)
    mean, std = _closed_form(tv, q["evidence"])
    np.testing.assert_allclose(stats["mean"][:, 0].numpy(), mean, atol=5e-3)
    np.testing.assert_allclose(stats["std"][:, 0].numpy(), std, atol=5e-3)


def test_asia_stream_posterior_matches_exact(models):
    """infer_posterior (LW) through the fused kernel's stream outputs."""
    tv = models["asia"]
    w, samples = tv.infer_posterior(_asia_query(1))
    assert w.shape == (1, S) and samples.shape == (1, S, 1)
    p1 = float((w[0] * (samples[0, :, 0] > 0.5)).sum() / w[0].sum())
    exact = exact_posterior(models["bn"], "dysp", {"smoke": 1, "asia": 0})
    assert abs(p1 - float(exact[1])) < 0.05


def test_lw_torch_sweep_route_matches_exact(models):
    """n_samples off the kernels' 1024 grid: the torch-op sweep serves."""
    tv = models["asia"]
    w, samples = tv.infer_posterior(_asia_query(1), n_samples=9000)
    p1 = float((w[0] * (samples[0, :, 0] > 0.5)).sum() / w[0].sum())
    exact = exact_posterior(models["bn"], "dysp", {"smoke": 1, "asia": 0})
    assert abs(p1 - float(exact[1])) < 0.05


@pytest.mark.parametrize("n_queries,expect_many", [(2, True), (17, False)])
def test_stream_fallback_routing(models, monkeypatch, n_queries, expect_many):
    """Off the fused path, lists of <= 16 queries go through
    infer_posterior_many and longer ones query by query."""
    tv = models["asia"]
    method = tv._inference
    calls = {"many": 0, "single": 0}
    many, single = method.infer_posterior_many, method.infer_posterior

    def count_many(*a, **k):
        calls["many"] += 1
        return many(*a, **k)

    def count_single(*a, **k):
        calls["single"] += 1
        return single(*a, **k)

    monkeypatch.setattr(method, "infer_posterior_many", count_many)
    monkeypatch.setattr(method, "infer_posterior", count_single)
    q = _asia_query(1)
    pmf, spans = tv.infer_posterior_pmf([q] * n_queries, n_classes=2,
                                        n_samples=1000)
    assert tv._last_summary_path == "stream"
    assert pmf.shape == (n_queries, 2) and len(spans) == n_queries
    assert calls == (
        {"many": 1, "single": 0} if expect_many
        else {"many": 0, "single": n_queries}
    )


def test_stream_moments_match_fused(models):
    tv = models["lg"]
    q = _flagship_query()
    fused, _ = tv.infer_posterior_moments([q])
    stream, _ = tv.infer_posterior_moments([q], n_samples=9000)
    assert tv._last_summary_path == "stream"
    np.testing.assert_allclose(stream, fused, atol=5e-3)


def test_port_fit_serves_like_loaded(models):
    """The port's own fit, on device='cpu', serves the same posterior."""
    bn = models["bn"]
    data = generate_dataset(bn, 4096, seed=0)
    tv = TVBN({n: bn.parents[n] for n in bn.nodes}, seed=1, device="cpu")
    conf = {}
    for node in bn.nodes:
        c = dict(tdefaults.cpd("categorical_table"), n_classes=bn.card(node))
        if bn.parents[node]:
            c["parent_n_classes"] = [bn.card(p) for p in bn.parents[node]]
        conf[node] = c
    tv.set_learning_method("node_wise", nodes_cpds=conf)
    tv.fit(data)
    tv.set_inference_method({"name": "likelihood_weighting", "n_samples": S})
    pmf, _ = tv.infer_posterior_pmf([_asia_query()], n_classes=2)
    pmf = pmf / pmf.sum(axis=1, keepdims=True)
    exact = exact_posterior(bn, "dysp", {"smoke": 1, "asia": 0})
    assert np.abs(pmf - exact[None]).max() < 0.05


def test_dynamic_masks_not_ported(models):
    """``dynamic_masks=True`` used to raise here; it now serves, and its
    reduced pmf rows come back normalized."""
    tv = models["asia"]
    tv.set_inference_method("likelihood_weighting", n_samples=S,
                            dynamic_masks=True)
    try:
        pmf, spans = tv.infer_posterior_pmf([_asia_query()], n_classes=2)
    finally:
        tv.set_inference_method("likelihood_weighting", n_samples=S)
    assert tv._last_summary_path == "fused" and spans == [(0, B, 7)]
    np.testing.assert_allclose(pmf.sum(axis=1), 1.0, atol=1e-6)
    exact = exact_posterior(models["bn"], "dysp", {"smoke": 1, "asia": 0})
    assert np.abs(pmf - exact[None]).max() < 0.05


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists; the no-card error cannot show")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TVBN([("a", "b")], seed=0)


def test_port_imports_no_jax():
    """Importing the port (and the chip script) pulls in neither JAX nor
    the JAX package: checked in a fresh interpreter, since this test
    process has both loaded."""
    code = (
        "import sys, runpy\n"
        "import vectorizedbayesiannetwork_torch\n"
        "import vectorizedbayesiannetwork_torch.ops.sweep\n"
        "import vectorizedbayesiannetwork_torch.ops.sweep_scan\n"
        "import vectorizedbayesiannetwork_torch.ops._build\n"
        "runpy.run_path('chip_smoke.py', run_name='chip_smoke')\n"
        "import benchmarking.bif, benchmarking.data_gen\n"  # chip_smoke's
        "import benchmarking.exact, benchmarking.networks\n"  # lazy imports
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib', 'vectorizedbayesiannetwork_tpu'))]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=root, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")
