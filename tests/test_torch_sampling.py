"""The port's samplers and the KDE log-density's gradient against the JAX
package, on the CPU.

Both packages get the same checkpoint: the JAX package fits and saves, the
port loads (``VBN.load``). Data comes from numpy with a seed. Draws of the
two packages come from different generators, so samplers are held within
Monte-Carlo error of each other and of an exact answer:

- the JAX sampler contracts (``tests/test_sampling.py``) on every sampler:
  shapes ``[B, n, D]``, finite values, ``sample_joint``'s keys, ``do``, and
  the categorical fallback of HMC and NUTS;
- means and stds against ``gaussian_exact`` on the linear-Gaussian
  flagship: the mean within 5 standard errors, where an MCMC run's error
  is at most ``std / sqrt(n_chains)`` (a chain's mean varies no more than
  one draw), the std within 15 %;
- histograms against ``categorical_exact`` on asia, every class within 5
  standard errors (``sqrt(p (1 - p) / n_eff)``, ``n_eff`` the chains);
- Gibbs on its hoisted-noise and its keyed route (LG and categorical
  tables), and on KDE nodes (keyed: KDE has no noise split), against LW on
  the same model;
- the port's and the JAX package's samplers on the same checkpoint, their
  means within 5 combined standard errors;
- the KDE log-density's closed-form backward (``ops/kde_kernel.py``)
  against ``torch.autograd`` of the plain version and ``jax.grad`` of the
  JAX package's plain ``kde_log_prob`` on root, conditional and wide
  shapes, 1e-5 relative (on the CPU the forward is the plain version, so
  this holds the closed form); and every continuous family's log-density
  gradient in its inputs against ``jax.grad`` of the JAX family's on the
  same params.
"""

import jax
import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch

from benchmarking.data_gen import generate_dataset
from benchmarking.networks import asia
from vectorizedbayesiannetwork_torch import SAMPLING_REGISTRY
from vectorizedbayesiannetwork_torch import VBN as TVBN
from vectorizedbayesiannetwork_torch.models import _mlp as tmlp
from vectorizedbayesiannetwork_torch.models.categorical_table import (
    CategoricalTableCPD as TCT,
)
from vectorizedbayesiannetwork_torch.models.linear_gaussian import (
    LinearGaussianCPD as TLG,
)
from vectorizedbayesiannetwork_torch.ops import kde_fused as tkf
from vectorizedbayesiannetwork_torch.ops import kde_kernel as tkk
from vectorizedbayesiannetwork_tpu import VBN as JVBN
from vectorizedbayesiannetwork_tpu import defaults as jdefaults
from vectorizedbayesiannetwork_tpu.ops import kde_kernel as jkk

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SAMPLERS = sorted(SAMPLING_REGISTRY)
MCMC = {
    "gibbs": {"burn_in": 30, "n_chains": 256},
    "hmc": {"burn_in": 100, "step_size": 0.2, "n_chains": 256},
    "nuts": {"burn_in": 30, "step_size": 0.2, "n_chains": 256,
             "max_tree_depth": 5},
}
DIAG = {"target": "x0", "evidence": {"x2": [[0.5], [-1.0]]}}


def flagship_data(n=1500, seed=0):
    g = np.random.default_rng(seed)
    x0, x1 = g.normal(size=n), g.normal(size=n)
    x2 = 0.5 * x0 - 0.2 * x1 + 0.1 * g.normal(size=n)
    return {k: v.astype(np.float32).reshape(-1, 1)
            for k, v in (("x0", x0), ("x1", x1), ("x2", x2))}


def jax_fit(g, nodes_cpds, data, path):
    jv = JVBN(g, seed=0)
    jv.set_learning_method("node_wise", nodes_cpds=nodes_cpds)
    jv.fit(data)
    jv.save(str(path))
    return jv, TVBN.load(str(path), device="cpu")


@pytest.fixture(scope="module")
def lg(tmp_path_factory):
    """The LG flagship fitted by the JAX package, loaded by the port."""
    g = nx.DiGraph([("x0", "x2"), ("x1", "x2")])
    conf = {k: jdefaults.cpd("linear_gaussian") for k in ("x0", "x1", "x2")}
    return jax_fit(g, conf, flagship_data(),
                   tmp_path_factory.mktemp("lg") / "lg.npz")


@pytest.fixture(scope="module")
def kde(tmp_path_factory):
    """The flagship, all KDE (max_points 256 of 600 rows)."""
    g = nx.DiGraph([("x0", "x2"), ("x1", "x2")])
    conf = {k: dict(jdefaults.cpd("kde"), max_points=256)
            for k in ("x0", "x1", "x2")}
    return jax_fit(g, conf, flagship_data(600),
                   tmp_path_factory.mktemp("kde") / "kde.npz")


@pytest.fixture(scope="module")
def asia_models(tmp_path_factory):
    bn = asia()
    data = {k: np.asarray(v, np.float32).reshape(-1, 1)
            for k, v in generate_dataset(bn, 4096, seed=0).items()}
    g = nx.DiGraph()
    g.add_nodes_from(bn.nodes)
    g.add_edges_from(bn.edges())
    conf = {}
    for node in bn.nodes:
        c = dict(jdefaults.cpd("categorical_table"), n_classes=bn.card(node))
        if bn.parents[node]:
            c["parent_n_classes"] = [bn.card(p) for p in bn.parents[node]]
        conf[node] = c
    jv, tv = jax_fit(g, conf, data, tmp_path_factory.mktemp("asia") / "a.npz")
    return bn, jv, tv


def exact_moments(tv, q):
    tv.set_inference_method("gaussian_exact")
    rows, _ = tv.infer_posterior_moments([q])
    return np.asarray(rows)


def exact_pmf(tv, q, k):
    tv.set_inference_method("categorical_exact")
    rows, _ = tv.infer_posterior_pmf([q], n_classes=k)
    rows = np.asarray(rows, np.float64)
    return rows / rows.sum(axis=1, keepdims=True)


# -- contracts ----------------------------------------------------------------
@pytest.mark.parametrize("name", SAMPLERS)
def test_every_sampler_contract(lg, name):
    _, tv = lg
    tv.set_sampling_method(name)
    kw = {"gibbs": {"burn_in": 5, "n_steps": 1}, "hmc": {"burn_in": 5},
          "nuts": {"burn_in": 5, "max_tree_depth": 4}}.get(name, {})
    s = tv.sample({"target": "x2", "evidence": {"x0": [[0.5], [0.1], [-2.0]]}},
                  n_samples=32, **kw)
    assert isinstance(s, torch.Tensor) and not s.requires_grad
    assert tuple(s.shape) == (3, 32, 1)
    assert torch.isfinite(s).all()


def test_ancestral_joint(lg):
    _, tv = lg
    tv.set_sampling_method("ancestral")
    joint = tv._sampling.sample_joint(
        tv, tv._normalize_query({"target": "x2", "evidence": {}}), 4096)
    assert set(joint) == {"x0", "x1", "x2"}
    resid = joint["x2"] - (0.5 * joint["x0"] - 0.2 * joint["x1"])
    assert abs(float(resid.std()) - 0.1) < 0.01


@pytest.mark.parametrize("name", SAMPLERS)
def test_do_intervention_sampling(lg, name):
    """do(x0 = 2) clamps x0 without evidence: x2's mean is 0.5 * 2 (the
    fitted weight, within 0.02 of 0.5) plus x1's zero-mean term."""
    _, tv = lg
    tv.set_sampling_method(name)
    s = tv.sample({"target": "x2", "evidence": {}, "do": {"x0": [[2.0]]}},
                  n_samples=2048, **MCMC.get(name, {}))
    assert abs(float(s.mean()) - 1.0) < 0.06


@pytest.mark.parametrize("name", ["hmc", "nuts"])
def test_gradient_samplers_fall_back_for_categorical(asia_models, name):
    _, _, tv = asia_models
    tv.set_sampling_method(name)
    s = tv.sample({"target": "dysp", "evidence": {}}, n_samples=64)
    assert tuple(s.shape) == (1, 64, 1)
    assert set(np.unique(s.numpy())) <= {0.0, 1.0}


# -- accuracy -------------------------------------------------------------------
@pytest.mark.parametrize("name", SAMPLERS)
def test_flagship_moments_match_gaussian_exact(lg, name):
    """Ancestral: x2 | x0, x1 (evidence on the parents only, where a
    forward sweep is the posterior), 4096 draws. The MCMC samplers: the
    diagnostic x0 | x2 at two rows, 256 chains of 8 draws."""
    _, tv = lg
    if name == "ancestral":
        q = {"target": "x2", "evidence": {"x0": [[0.5], [-1.0]],
                                          "x1": [[-0.2], [0.7]]}}
        n, n_eff = 4096, 4096
    else:
        q, n, n_eff = DIAG, 2048, 256
    want = exact_moments(tv, q)
    tv.set_sampling_method(name)
    s = tv.sample(q, n_samples=n, **MCMC.get(name, {})).numpy()[..., 0]
    mean, std = s.mean(axis=1), s.std(axis=1)
    np.testing.assert_array_less(np.abs(mean - want[:, 0]),
                                 5.0 * want[:, 1] / np.sqrt(n_eff))
    np.testing.assert_array_less(np.abs(std - want[:, 1]), 0.15 * want[:, 1])


@pytest.mark.parametrize("name", SAMPLERS)
def test_asia_histograms_match_categorical_exact(asia_models, name):
    """P(dysp | smoke, asia), evidence on ancestors (HMC and NUTS fall back
    to ancestral), 4096 draws, each class within 5 standard errors."""
    bn, _, tv = asia_models
    q = {"target": "dysp", "evidence": {"smoke": [[1.0], [0.0]],
                                        "asia": [[1.0], [0.0]]}}
    want = exact_pmf(tv, q, 2)
    tv.set_sampling_method(name)
    s = tv.sample(q, n_samples=4096, **MCMC.get(name, {})).numpy()[..., 0]
    n_eff = MCMC.get(name, {}).get("n_chains", 4096) if name == "gibbs" else 4096
    got = np.stack([(s == k).mean(axis=1) for k in range(2)], axis=1)
    se = np.sqrt(want * (1 - want) / n_eff) + 1e-9
    np.testing.assert_array_less(np.abs(got - want), 5.0 * se + 1e-3)


@pytest.mark.parametrize("hoisted", [True, False])
def test_gibbs_diagnostic_asia_both_routes(asia_models, monkeypatch, hoisted):
    """P(lung | xray, dysp) by Gibbs: the hoisted route draws every step's
    uniforms before the loop, the keyed route (no ``_noise_spec``) in it.
    The chains start from the prior, far from this posterior: 100 steps of
    burn-in (at 30 the class frequency is still 0.02 off)."""
    _, _, tv = asia_models
    if not hoisted:
        monkeypatch.delattr(TCT, "_noise_spec")
    q = {"target": "lung", "evidence": {"xray": [[1.0]], "dysp": [[1.0]]}}
    want = exact_pmf(tv, q, 2)
    tv.set_sampling_method("gibbs")
    s = tv.sample(q, n_samples=4096, burn_in=100, n_chains=512).numpy()[..., 0]
    assert tv._sampling._last_hoisted is hoisted
    got = np.stack([(s == k).mean(axis=1) for k in range(2)], axis=1)
    se = np.sqrt(want * (1 - want) / 512)
    np.testing.assert_array_less(np.abs(got - want), 5.0 * se + 1e-3)


@pytest.mark.parametrize("hoisted", [True, False])
def test_gibbs_lg_both_routes(lg, monkeypatch, hoisted):
    _, tv = lg
    if not hoisted:
        monkeypatch.delattr(TLG, "_noise_spec")
    want = exact_moments(tv, DIAG)
    tv.set_sampling_method("gibbs")
    s = tv.sample(DIAG, n_samples=2048, burn_in=30, n_steps=2,
                  n_chains=256).numpy()[..., 0]
    assert tv._sampling._last_hoisted is hoisted
    np.testing.assert_array_less(np.abs(s.mean(axis=1) - want[:, 0]),
                                 5.0 * want[:, 1] / 16.0)


def lw_moments(tv, q, s=1 << 15):
    tv.set_inference_method("likelihood_weighting", n_samples=s)
    rows, _ = tv.infer_posterior_moments([q])
    return np.asarray(rows)


@pytest.mark.parametrize("name", ["gibbs", "hmc"])
def test_kde_network_samplers_match_lw(kde, name):
    """Gibbs (keyed: KDE has no noise split) and HMC (through
    ``KDELogProb``) over the KDE flagship: x0 | x2 within 5 standard
    errors of LW's mean at S = 2^15 on the same model, std within 15 %."""
    _, tv = kde
    want = lw_moments(tv, DIAG)
    tv.set_sampling_method(name)
    s = tv.sample(DIAG, n_samples=1024, **MCMC[name]).numpy()[..., 0]
    if name == "gibbs":
        assert tv._sampling._last_hoisted is False
    np.testing.assert_array_less(np.abs(s.mean(axis=1) - want[:, 0]),
                                 5.0 * want[:, 1] / 16.0 + 0.01)
    np.testing.assert_array_less(np.abs(s.std(axis=1) - want[:, 1]),
                                 0.15 * want[:, 1])


@pytest.mark.parametrize("name", ["ancestral", "hmc", "nuts"])
def test_port_and_jax_samplers_agree(lg, name):
    """Both packages' samplers on the same checkpoint and query: means
    within 5 combined standard errors (64 chains each; ancestral: x2 | x0
    from 512 draws). Gibbs is left out: the port's step is exact where the
    JAX package's is biased toward the prior (``sampling/gibbs.py``), and
    the tests above hold it against the exact posterior instead."""
    jv, tv = lg
    if name == "ancestral":
        q, kw, n_eff = {"target": "x2", "evidence": {"x0": [[0.5]]}}, {}, 512
    else:
        q, kw, n_eff = ({"target": "x0", "evidence": {"x2": [[0.5]]}},
                        dict(MCMC[name], n_chains=64), 64)
    jv.set_sampling_method(name)
    tv.set_sampling_method(name)
    js = np.asarray(jv.sample(q, n_samples=512, **kw))[0, :, 0]
    ts = tv.sample(q, n_samples=512, **kw).numpy()[0, :, 0]
    sd = exact_moments(tv, q)[0, 1]
    assert abs(js.mean() - ts.mean()) < 5.0 * np.sqrt(2.0 / n_eff) * sd


def test_hmc_adapts_from_a_bad_step_size(lg):
    _, tv = lg
    want = exact_moments(tv, DIAG)
    for name, eps in (("hmc", 2.0), ("nuts", 5.0)):
        tv.set_sampling_method(name)
        s = tv.sample(DIAG, n_samples=2048, burn_in=60, step_size=eps,
                      n_chains=256, adapt_step_size=True).numpy()[..., 0]
        np.testing.assert_array_less(np.abs(s.mean(axis=1) - want[:, 0]),
                                     5.0 * want[:, 1] / 16.0)


# -- the KDE log-density's gradient ---------------------------------------------
KDE_SHAPES = [("root", 2, 0), ("conditional", 1, 3), ("wide", 2, 40)]


@pytest.mark.parametrize("kind,dx,dp", KDE_SHAPES,
                         ids=[s[0] for s in KDE_SHAPES])
def test_kde_gradient_matches_autograd_and_jax(kind, dx, dp):
    g = np.random.default_rng(5)
    n, m, ys, ps = 300, 64, 0.35, 0.6
    data_x = g.normal(size=(n, dx)).astype(np.float32)
    data_p = g.normal(size=(n, dp)).astype(np.float32)
    valid = np.ones(n, np.float32)
    valid[-40:] = 0.0
    log_mask = np.log(np.maximum(valid, 1e-20)).astype(np.float32)
    x = g.normal(size=(m, dx)).astype(np.float32)
    p = g.normal(size=(m, dp)).astype(np.float32) if dp else None
    weights = g.normal(size=m).astype(np.float32)  # a cotangent

    tx = torch.tensor(x, requires_grad=True)
    tp = torch.tensor(p, requires_grad=True) if dp else None
    args = (torch.tensor(data_x), torch.tensor(data_p), torch.tensor(log_mask),
            ys, ps)
    out = tkk.kde_log_prob(tx, tp, *args)
    assert type(out.grad_fn).__name__ == "KDELogProbBackward"
    got = torch.autograd.grad((out * torch.tensor(weights)).sum(),
                              [tx] + ([tp] if dp else []))

    px = torch.tensor(x, requires_grad=True)
    pp = torch.tensor(p, requires_grad=True) if dp else None
    if dp:
        plain = tkf.kde_cond_plain(px, pp, *args)
    else:
        plain = tkf.kde_root_plain(px, args[0], args[2], ys)
    ref = torch.autograd.grad((plain * torch.tensor(weights)).sum(),
                              [px] + ([pp] if dp else []))

    def jfn(xx, pv):
        return jnp.sum(jnp.asarray(weights) * jkk.kde_log_prob(
            xx, pv, jnp.asarray(data_x), jnp.asarray(data_p),
            jnp.asarray(log_mask), ys, ps))

    jref = jax.grad(jfn, argnums=(0, 1) if dp else (0,))(
        jnp.asarray(x), jnp.asarray(p) if dp else None)
    for a, b, c in zip(got, ref, jref):
        scale = float(b.abs().max())
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-5,
                                   atol=1e-5 * scale)


def test_kde_gradient_refuses_a_support_gradient():
    data = torch.zeros((4, 1), requires_grad=True)
    with pytest.raises(ValueError, match="support"):
        tkk.kde_log_prob(torch.zeros((2, 1)), None, data, torch.zeros((4, 0)),
                         torch.zeros(4), 1.0, 1.0)


def test_kde_forward_unchanged_when_a_gradient_is_wanted():
    """The autograd.Function's forward is the dispatch itself."""
    g = torch.Generator().manual_seed(0)
    dx, dp = torch.randn(50, 1, generator=g), torch.randn(50, 2, generator=g)
    x, p = torch.randn(9, 1, generator=g), torch.randn(9, 2, generator=g)
    lm = torch.zeros(50)
    plain = tkk.kde_log_prob(x, p, dx, dp, lm, 0.3, 0.5)
    graded = tkk.kde_log_prob(x.requires_grad_(), p, dx, dp, lm, 0.3, 0.5)
    assert torch.equal(plain, graded.detach())


# -- every continuous family is differentiable in its inputs --------------------
FAMILIES = [
    ("linear_gaussian", {}),
    ("gaussian_nn", {"fit": {"epochs": 2, "batch_size": 256, "lr": 1e-2}}),
    ("gaussian_nn", {"compute_dtype": "bfloat16",
                     "fit": {"epochs": 2, "batch_size": 256, "lr": 1e-2}}),
    ("mdn", {"n_components": 3,
             "fit": {"epochs": 2, "batch_size": 256, "lr": 1e-2}}),
    ("rff_gaussian", {"n_features": 32}),
    ("kde", {"max_points": 128}),
]


@pytest.mark.parametrize("cpd,extra", FAMILIES,
                         ids=[f[0] + ("_bf16" if "compute_dtype" in f[1] else "")
                              for f in FAMILIES])
def test_family_log_prob_gradient_matches_jax(tmp_path, cpd, extra):
    """d log p(x2 | x0, x1) / d(x2, x0, x1) on the same params: the port's
    autograd within 1e-4 of ``jax.grad`` of the JAX family's
    ``_log_prob_flat`` (bf16: the JAX package's bf16 tolerance, rtol 0.05,
    atol 0.15 of the gradient's scale)."""
    g = nx.DiGraph([("x0", "x2"), ("x1", "x2")])
    conf = {k: dict(jdefaults.cpd(cpd), **extra) for k in ("x0", "x1", "x2")}
    jv, tv = jax_fit(g, conf, flagship_data(400), tmp_path / "m.npz")
    r = np.random.default_rng(1)
    x = r.normal(size=(16, 1)).astype(np.float32)
    p = r.normal(size=(16, 2)).astype(np.float32)
    tx, tp = torch.tensor(x, requires_grad=True), torch.tensor(p,
                                                               requires_grad=True)
    out = tv.nodes["x2"]._log_prob_flat(tv.params["x2"], tx, tp)
    got = torch.autograd.grad(out.sum(), [tx, tp])
    jc, jp = jv.nodes["x2"], jv.params["x2"]
    want = jax.grad(lambda a, b: jnp.sum(jc._log_prob_flat(jp, a, b)),
                    argnums=(0, 1))(jnp.asarray(x), jnp.asarray(p))
    bf16 = extra.get("compute_dtype") == "bfloat16"
    for a, b in zip(got, want):
        b = np.asarray(b)
        scale = float(np.abs(b).max())
        assert scale > 0 and np.isfinite(a.numpy()).all()
        if bf16:
            np.testing.assert_allclose(a.numpy(), b, rtol=0.05,
                                       atol=0.15 * scale)
        else:
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                       atol=1e-4 * scale)


def test_bf16_product_backward_is_autograd_of_its_float_form():
    g = torch.Generator().manual_seed(3)
    h = torch.randn(7, 5, generator=g, requires_grad=True)
    w = torch.randn(5, 4, generator=g, requires_grad=True)
    got = torch.autograd.grad(tmlp._bf16_product(h, w).square().sum(), [h, w])
    ref_out = h.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()
    ref = torch.autograd.grad(ref_out.square().sum(), [h, w])
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
