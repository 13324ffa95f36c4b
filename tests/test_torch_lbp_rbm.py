"""The port's ``lbp`` and ``rao_blackwellized_marginalization`` against the
JAX package's, on the CPU, on models the JAX package fitted and saved.

- LBP's smoothing: both packages' programs built over the same base
  weights (the base method's program replaced by one that returns them):
  the smoothed weights within 1e-6 of the JAX ``lax.while_loop``, when the
  loop converges and through the fallback (``tol=0``, where both answer
  with the fallback run's weights); the IS base and the MCM base (pdf
  normalized to weights);
- LBP end to end on the linear-Gaussian flagship's diagnosis query
  (x0 | x2) at S = 2^13: posterior means within 5 standard errors of the
  closed form, as the JAX package's own LBP;
- RBM with every parent of the target observed (x2 | x0, x1): the grid
  within 1e-5 of the JAX package's and the pdf within 1e-5 of its peak
  (no draw reaches them);
- RBM on asia, P(dysp | smoke, asia) and P(dysp | xray), the ancestors
  sampled: the pmf within 0.02 of ``categorical_exact`` at 2^14
  particles (5 standard errors of a frequency at p = 1/2);
- the refusals: an observed descendant of the target and an unsupported
  target family (KDE) fall back with the JAX package's reason text, and a
  fixed target answers its own value with weight 1.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_checkpoint import asia_setup, flagship_setup
from vectorizedbayesiannetwork_torch import VBN as TVBN
from vectorizedbayesiannetwork_torch.core.rng import Draw
from vectorizedbayesiannetwork_torch.inference import _base as tbase
from vectorizedbayesiannetwork_tpu import VBN as JVBN
from vectorizedbayesiannetwork_tpu import defaults as jdefaults
from vectorizedbayesiannetwork_tpu.inference import _base as jbase

B = 4


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """The JAX fit of the LG flagship and the port's load of it."""
    fg, farrays = flagship_setup()
    jv = JVBN(fg, seed=0)
    jv.set_learning_method(
        "node_wise",
        nodes_cpds={k: jdefaults.cpd("linear_gaussian") for k in farrays})
    jv.fit(farrays)
    path = tmp_path_factory.mktemp("lbp") / "flag.npz"
    jv.set_inference_method("rao_blackwellized_marginalization",
                            n_samples=64, n_particles=256)
    jv.save(str(path))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tv = TVBN.load(str(path), device="cpu")
    assert type(tv._inference).__name__ == "RaoBlackwellizedMarginalization"
    return jv, tv


@pytest.fixture(scope="module")
def asia_pair(tmp_path_factory):
    _, g, arrays, conf = asia_setup()
    jv = JVBN(g, seed=0)
    jv.set_learning_method("node_wise", nodes_cpds=conf(jdefaults))
    jv.fit(arrays)
    path = tmp_path_factory.mktemp("rbm") / "asia.npz"
    jv.save(str(path))
    return jv, TVBN.load(str(path), device="cpu")


def _closed_form(tv, x2):
    """(mean, std) of x0 | x2 on the fitted flagship."""
    p = tv.params
    w = p["x2"]["weight"].numpy().reshape(-1)
    b = float(p["x2"]["bias"][0])
    v2 = float(p["x2"]["var"][0])
    mu = [float(p[k]["bias"][0]) for k in ("x0", "x1")]
    var = [float(p[k]["var"][0]) for k in ("x0", "x1")]
    m2 = w[0] * mu[0] + w[1] * mu[1] + b
    s2 = w[0] ** 2 * var[0] + w[1] ** 2 * var[1] + v2
    cov = w[0] * var[0]
    mean = mu[0] + cov / s2 * (x2 - m2)
    return mean, np.sqrt(var[0] - cov**2 / s2)


def _stub_weights(s, seed=0):
    """Unnormalized base weights [B, S] (sum ~ 2 a row: the first step
    moves them, the second converges) and target values [B, S, 1]."""
    g = np.random.default_rng(seed)
    w = g.uniform(0.0, 4.0 / s, size=(B, s)).astype(np.float32)
    return w, g.normal(size=(B, s, 1)).astype(np.float32)


def _stub(monkeypatch, method, which, outs_j, outs_t):
    """Replace ``method._<which>.make_program`` in both packages by one that
    returns the given outputs on the real plan and rows."""
    j_sub, t_sub = getattr(method[0], which), getattr(method[1], which)
    j_make, t_make = j_sub.make_program, t_sub.make_program

    def j_prog(vbn, query, **kw):
        p = j_make(vbn, query, **kw)
        return jbase.Program(p.plan, ("stub",), lambda *a: outs_j, p.params,
                             p.fixed, p.post)

    def t_prog(vbn, query, **kw):
        p = t_make(vbn, query, **kw)
        return tbase.Program(p.plan, lambda *a: outs_t, p.params, p.fixed,
                             p.post)

    monkeypatch.setattr(j_sub, "make_program", j_prog)
    monkeypatch.setattr(t_sub, "make_program", t_prog)


@pytest.mark.parametrize("base", ["importance_sampling",
                                  "monte_carlo_marginalization"])
@pytest.mark.parametrize("tol", [1e-4, 0.0], ids=["converged", "fallback"])
def test_lbp_smoothing_matches_jax(flagship, monkeypatch, base, tol):
    jv, tv = flagship
    s = 64
    w, x = _stub_weights(s)
    w_fb, x_fb = _stub_weights(s, seed=1)
    jv.set_inference_method("lbp", n_samples=s, fallback=base)
    tv.set_inference_method("lbp", n_samples=s, fallback=base)
    method = (jv._inference, tv._inference)
    fb_j = (jnp.asarray(w_fb), jnp.asarray(x_fb), None, None)
    fb_t = (torch.as_tensor(w_fb), torch.as_tensor(x_fb), None, None)
    if base == "importance_sampling":
        # IS is both the base and the fallback: the stub answers both, and
        # the fallback's answer is its raw weights
        _stub(monkeypatch, method, "_is", (jnp.asarray(w), jnp.asarray(x),
                                           None, None),
              (torch.as_tensor(w), torch.as_tensor(x), None, None))
        fb_w = w
    else:
        _stub(monkeypatch, method, "_mcm", (jnp.asarray(w), jnp.asarray(x)),
              (torch.as_tensor(w), torch.as_tensor(x)))
        _stub(monkeypatch, method, "_is", fb_j, fb_t)
        fb_w = w_fb
    q = {"target": "x0", "evidence": {"x2": np.zeros((B, 1), np.float32)}}
    jq, tq = jv._normalize_query(q), tv._normalize_query(q)
    jp = jv._inference.make_program(jv, jq, tol=tol)
    tp = tv._inference.make_program(tv, tq, tol=tol)
    jw, js = jp.fn(jp.params, jax.random.PRNGKey(0), jnp.asarray(jp.fixed))
    tw, ts = tp.post(tp.fn(tp.params, Draw(0, torch.device("cpu")),
                           torch.as_tensor(tp.fixed)))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    lbp = tv._inference
    if tol == 0.0:
        assert lbp._last_fallback and lbp._last_iters == 10
        np.testing.assert_array_equal(tw.numpy(), fb_w)
    else:
        # IS hands over its raw weights: one step to normalize them, one
        # to converge; MCM's pdf arrives normalized
        steps = 2 if base == "importance_sampling" else 1
        assert not lbp._last_fallback and lbp._last_iters == steps


def test_lbp_end_to_end_matches_closed_form(flagship):
    jv, tv = flagship
    s = 1 << 13
    x2 = np.linspace(-1, 1, B).reshape(B, 1).astype(np.float32)
    q = {"target": "x0", "evidence": {"x2": x2}}
    mean, std = _closed_form(tv, x2[:, 0].astype(np.float64))
    for v in (jv, tv):
        v.set_inference_method("lbp", n_samples=s)
        pdf, samples = v.infer_posterior(q)
        st = v._posterior_stats(pdf, samples)
        got = np.asarray(st["mean"]).reshape(-1)
        se = std / np.sqrt(np.asarray(st["ess"]).reshape(-1))
        assert np.all(np.abs(got - mean) < 5 * se), (got, mean, se)
    assert tv._inference._last_iters == 1 and not tv._inference._last_fallback


def test_rbm_parents_observed_matches_jax(flagship):
    jv, tv = flagship
    for v in (jv, tv):
        v.set_inference_method("rao_blackwellized_marginalization",
                               n_samples=64, n_particles=256)
    x0 = np.linspace(-1, 1, B).reshape(B, 1).astype(np.float32)
    q = {"target": "x2", "evidence": {"x0": x0, "x1": x0[::-1].copy()}}
    jpdf, jgrid = jv.infer_posterior(q)
    tpdf, tgrid = tv.infer_posterior(q)
    assert tpdf.shape == (B, 64) and tgrid.shape == (B, 64, 1)
    np.testing.assert_allclose(tgrid.numpy(), np.asarray(jgrid), atol=1e-5)
    # the pdf within 1e-5 of its scale (its peak, 1 / (sqrt(2 pi) sigma)):
    # the float32 second moment cancels (loc^2 >> scale^2), so the grid
    # moves by ~1e-6 between the packages and the pdf's slope, ~1/sigma^2,
    # carries that to ~3e-5 at a peak of ~4
    jp = np.asarray(jpdf)
    scale = jp.max(axis=1, keepdims=True)
    assert np.all(np.abs(tpdf.numpy() - jp) <= 1e-5 * scale)
    assert not tv._inference._last_fallback


@pytest.mark.parametrize("evidence", [
    {"smoke": [[1.0], [0.0]], "asia": [[1.0], [0.0]]},
    {"xray": [[1.0], [0.0]]}], ids=["smoke-asia", "xray"])
def test_rbm_categorical_within_mc_of_exact(asia_pair, evidence):
    _, tv = asia_pair
    q = {"target": "dysp", "evidence": evidence}
    tv.set_inference_method("categorical_exact")
    want, _ = tv.infer_posterior(q)
    tv.set_inference_method("rao_blackwellized_marginalization",
                            n_samples=64, n_particles=1 << 14)
    got, support = tv.infer_posterior(q)
    assert not tv._inference._last_fallback
    assert got.shape == (2, 2) and support.shape == (2, 2, 1)
    np.testing.assert_allclose(got.sum(1).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=0.02)
    np.testing.assert_array_equal(support[0, :, 0].numpy(), [0.0, 1.0])


def test_rbm_refusals_match_jax(flagship, asia_pair, tmp_path):
    jv, tv = flagship
    q = {"target": "x0", "evidence": {"x2": [[0.3]]}}
    for v in (jv, tv):
        v.set_inference_method("rao_blackwellized_marginalization",
                               n_samples=64, n_particles=256)
        pdf, _ = v.infer_posterior(q)
        assert np.isfinite(np.asarray(pdf)).all()
    assert tv._inference._last_fallback and jv._inference._last_fallback
    assert tv._inference._last_reason == jv._inference._last_reason == (
        "target has observed/intervened descendants")

    pdf, value = tv.infer_posterior({"target": "x0",
                                     "evidence": {"x0": [[0.5]]}})
    assert pdf.tolist() == [[1.0]] and value.tolist() == [[[0.5]]]

    fg, farrays = flagship_setup(n=256)
    conf = {k: dict(jdefaults.cpd("kde"), max_points=64) for k in farrays}
    jk = JVBN(fg, seed=0)
    jk.set_learning_method("node_wise", nodes_cpds=conf)
    jk.fit(farrays)
    jk.set_inference_method("rao_blackwellized_marginalization",
                            n_samples=64, n_particles=256)
    jk.save(str(tmp_path / "kde.npz"))
    tk = TVBN.load(str(tmp_path / "kde.npz"), device="cpu")
    qk = {"target": "x2", "evidence": {"x0": [[0.2]]}}
    for v in (jk, tk):
        v.infer_posterior(qk)
    assert tk._inference._last_reason == jk._inference._last_reason == (
        "unsupported target CPD for RB marginalization")
