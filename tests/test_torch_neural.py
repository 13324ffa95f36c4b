"""The port's neural CPD modules against the JAX package's, on the CPU.

Each module holds its JAX counterpart on the same inputs, made with numpy
from a seed; the JAX initial parameters cross as numpy arrays, so both
sides start from the same weights:

- ``_mlp.mlp_apply`` for every activation (``gelu`` the tanh form):
  float32 within 1e-5; ``compute_dtype="bfloat16"`` within the JAX
  package's own bf16 tolerance (rtol 0.05, atol 0.15), with a float32
  output;
- ``_optim.adam_step``: five steps with weight decay and clipping, within
  1e-6 (the same float32 expressions, rounded in another order);
- ``_train``: the minibatch schedule (padding, equal batch sizes), and
  full-batch training (``batch_size >= n``, where the permutation cannot
  change the mean NLL but by rounding) of ``gaussian_nn``, ``mdn``,
  ``softmax_nn`` and ``categorical_embedded_softmax`` for 5 epochs: params
  and optimizer state within 1e-4;
- ``rff_gaussian`` fitted on the JAX features: ``coef``, ``bias`` and
  ``var`` within 1e-3 relative (the port solves in float64, JAX in
  float32);
- ``softmax_nn`` bins in every binning mode with discrete detection, and
  ``categorical_embedded_softmax`` supports: equal to JAX's exactly;
- on each family's JAX checkpoint, loaded by the port: ``log_prob``
  within 1e-5, the protocol methods within 1e-6, and the port's draws'
  moments and class frequencies within 5 standard errors at S = 2^14.
"""

import jax
import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch

from vectorizedbayesiannetwork_torch import VBN as TVBN
from vectorizedbayesiannetwork_torch import defaults as tdefaults
from vectorizedbayesiannetwork_torch.core.registry import CPD_REGISTRY as TCPD
from vectorizedbayesiannetwork_torch.models import _mlp as tmlp
from vectorizedbayesiannetwork_torch.models import _optim as toptim
from vectorizedbayesiannetwork_torch.models._train import (
    batch_schedule,
    epoch_indices,
    fit_minibatch_nll,
)
from vectorizedbayesiannetwork_tpu import VBN as JVBN
from vectorizedbayesiannetwork_tpu import defaults as jdefaults
from vectorizedbayesiannetwork_tpu.core.registry import CPD_REGISTRY as JCPD
from vectorizedbayesiannetwork_tpu.models import _mlp as jmlp
from vectorizedbayesiannetwork_tpu.models import _optim as joptim

ACTIVATIONS = ["relu", "tanh", "gelu", "elu"]


def to_torch(tree):
    """A JAX tree (nested dicts/lists of arrays) as torch CPU tensors."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_torch(v) for v in tree]
    return None if tree is None else torch.as_tensor(np.array(tree))


def flat(tree, prefix=""):
    """{'a/#0/b': ndarray} of a JAX or torch tree."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}#{i}/"))
    elif tree is not None:
        if isinstance(tree, torch.Tensor):
            tree = tree.detach().numpy()
        out[prefix[:-1]] = np.asarray(tree)
    return out


def assert_trees_close(got, want, atol, rtol=0.0):
    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k].astype(g[k].dtype), atol=atol,
                                   rtol=rtol, err_msg=k)


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------------------
# _mlp
# ---------------------------------------------------------------------------


def _mlp_case(seed=0):
    net = jmlp.mlp_init(jax.random.PRNGKey(seed), 3, [16, 16], 4)
    x = np.random.default_rng(seed).normal(size=(64, 3)).astype(np.float32)
    return net, x


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_mlp_apply_matches_jax(activation):
    net, x = _mlp_case()
    want = np.asarray(jmlp.mlp_apply(net, jnp.asarray(x), activation))
    got = tmlp.mlp_apply(to_torch(net), torch.as_tensor(x), activation)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_mlp_apply_bf16_matches_jax(activation):
    net, x = _mlp_case(1)
    want = np.asarray(jmlp.mlp_apply(net, jnp.asarray(x), activation,
                                     jnp.bfloat16))
    tnet, tx = to_torch(net), torch.as_tensor(x)
    got = tmlp.mlp_apply(tnet, tx, activation, torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0.05, atol=0.15)
    # the products really took bf16 inputs
    assert not torch.equal(got, tmlp.mlp_apply(tnet, tx, activation))


def test_gelu_is_the_tanh_approximation():
    h = torch.linspace(-4.0, 4.0, 101)
    want = np.asarray(jax.nn.gelu(jnp.asarray(h.numpy())))
    got = tmlp._ACTIVATIONS["gelu"](h).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    erf_form = torch.nn.functional.gelu(h).numpy()
    assert np.abs(erf_form - want).max() > 1e-4


def test_mlp_init_layout_and_bounds():
    net = tmlp.mlp_init(gen(), 5, [16, 8], 3, "cpu")
    want = jmlp.mlp_init(jax.random.PRNGKey(0), 5, [16, 8], 3)
    assert [tuple(l["w"].shape) for l in net["layers"]] == [
        tuple(l["w"].shape) for l in want["layers"]]
    for layer, fan_in in zip(net["layers"], (5, 16, 8)):
        bound = 1.0 / np.sqrt(fan_in)
        for t in layer.values():
            assert t.dtype == torch.float32
            assert float(t.abs().max()) <= bound
    again = tmlp.mlp_init(gen(), 5, [16, 8], 3, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        toptim.tree_leaves(net), toptim.tree_leaves(again)))
    assert tmlp.resolve_compute_dtype("bf16") == torch.bfloat16
    assert tmlp.resolve_compute_dtype("float32") is None
    with pytest.raises(ValueError):
        tmlp.resolve_compute_dtype("float16x")
    with pytest.raises(ValueError):
        tmlp.check_activation("swish")


# ---------------------------------------------------------------------------
# _optim
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weight_decay,max_grad_norm", [
    (0.0, None), (1e-2, 0.5), (1e-2, 100.0)])
def test_adam_five_steps_match_jax(weight_decay, max_grad_norm):
    net, _ = _mlp_case(2)
    rng = np.random.default_rng(5)
    jstate, tstate = joptim.adam_init(net), toptim.adam_init(to_torch(net))
    jp, tp = net, to_torch(net)
    for _ in range(5):
        grads = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)),
            net)
        jp, jstate = joptim.adam_step(jp, grads, jstate, 1e-2, weight_decay,
                                      max_grad_norm)
        tp, tstate = toptim.adam_step(tp, to_torch(grads), tstate, 1e-2,
                                      weight_decay, max_grad_norm)
    assert_trees_close(tp, jp, atol=1e-6)
    assert_trees_close(tstate, jstate, atol=1e-6)
    assert float(tstate["step"]) == 5.0


def test_adam_state_aligns_by_key_not_order():
    """A state whose dicts list their keys in another order (as a
    checkpoint may) updates the same leaves."""
    p = {"a": torch.ones(2), "b": torch.full((3,), 2.0)}
    g = {"b": torch.ones(3), "a": torch.full((2,), -1.0)}
    state = toptim.adam_init(p)
    state["m"] = {"b": state["m"]["b"], "a": state["m"]["a"]}
    new, st = toptim.adam_step(p, g, state, 0.1)
    np.testing.assert_allclose(new["a"].numpy(), [1.1, 1.1], rtol=1e-6)
    np.testing.assert_allclose(new["b"].numpy(), [1.9] * 3, rtol=1e-6)
    np.testing.assert_allclose(st["m"]["a"].numpy(), [-0.1, -0.1], rtol=1e-6)


# ---------------------------------------------------------------------------
# _train: the schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,batch_size", [(10, 4), (12, 4), (7, 100), (1, 3)])
def test_minibatch_schedule_pads_to_equal_batches(n, batch_size):
    bs, n_batches, n_pad = batch_schedule(n, batch_size)
    # the JAX package's arithmetic (models/_train.py)
    assert bs == min(batch_size, n)
    assert n_batches == -(-n // bs) and n_pad == n_batches * bs
    perm = epoch_indices(gen(1), n, n_pad, "cpu")
    assert sorted(perm.tolist()) == sorted((np.arange(n_pad) % n).tolist())
    seen = []

    def nll(net, p, x):
        seen.append(int(x.shape[0]))
        return ((net["w"] * x) ** 2).mean()

    x = torch.arange(n, dtype=torch.float32)[:, None]
    _, opt = fit_minibatch_nll(nll, {"w": torch.ones(1)}, None, gen(), None, x,
                               epochs=2, batch_size=batch_size, lr=1e-3)
    assert seen == [bs] * (2 * n_batches)
    assert float(opt["step"]) == 2 * n_batches


def test_training_returns_detached_params_and_keeps_its_inputs():
    net = {"w": torch.ones(2)}
    x = torch.randn(16, 2, generator=gen())
    out, opt = fit_minibatch_nll(lambda n_, p, x_: ((n_["w"] - x_) ** 2).mean(),
                                 net, None, gen(), None, x, epochs=3,
                                 batch_size=4, lr=0.1, ema_alpha=0.5)
    assert not out["w"].requires_grad and out["w"].grad_fn is None
    assert torch.equal(net["w"], torch.ones(2))
    assert not torch.equal(out["w"], net["w"])


# ---------------------------------------------------------------------------
# full-batch training parity
# ---------------------------------------------------------------------------


def _regression_rows(n=256, seed=0):
    g = np.random.default_rng(seed)
    p = g.normal(size=(n, 2)).astype(np.float32)
    x = (0.7 * p[:, :1] - 0.3 * p[:, 1:] + 0.2 * g.normal(size=(n, 1))
         ).astype(np.float32)
    return p, x


def _discrete_rows(n=256, seed=0):
    p, x = _regression_rows(n, seed)
    return (np.rint(np.clip(p * 1.5 + 2, 0, 4)).astype(np.float32),
            np.rint(np.clip(x * 1.5 + 2, 0, 4)).astype(np.float32))


FIT_CASES = {
    "gaussian_nn": ("gaussian_nn", {"hidden_dims": [16]}, 2),
    "gaussian_nn-root": ("gaussian_nn", {}, 0),
    "mdn": ("mdn", {"hidden_dims": [16], "n_components": 3}, 2),
    "mdn-root": ("mdn", {"n_components": 3}, 0),
    "softmax_nn": ("softmax_nn", {"hidden_dims": [16], "n_classes": 6,
                                  "label_smoothing": 0.1,
                                  "class_weighting": "inverse_freq"}, 2),
    "categorical_embedded_softmax": (
        "categorical_embedded_softmax",
        {"hidden_dims": [16], "embedding_dim": 4, "label_smoothing": 0.05,
         "class_weighting": "inverse_freq"}, 2),
}


@pytest.mark.parametrize("case", sorted(FIT_CASES))
@pytest.mark.parametrize("fit_kw", [
    {"lr": 1e-2}, {"lr": 1e-2, "weight_decay": 1e-2, "max_grad_norm": 0.5}],
    ids=["plain", "decay-clip"])
def test_full_batch_training_matches_jax(case, fit_kw, monkeypatch):
    name, kw, din = FIT_CASES[case]
    discrete = name == "categorical_embedded_softmax"
    p, x = _discrete_rows() if discrete else _regression_rows()
    p = p if din else None
    jc, tc = JCPD[name](din, 1, seed=0, **kw), TCPD[name](din, 1, seed=0, **kw)
    key = jax.random.PRNGKey(3)
    jinit = jc.init(key)
    if case == "gaussian_nn-root":
        # off the standardized data's mean: at loc = 0 the first gradient
        # of loc is rounding noise, whose sign Adam amplifies to +-lr
        jinit["net"]["loc"] = jnp.full((1,), 0.3, jnp.float32)
    fit_kw = dict(fit_kw, epochs=5, batch_size=len(x))
    want = jc.fit(jinit, key, p, x, **fit_kw)
    if discrete:
        # the module is built inside fit; give the port JAX's build
        built = to_torch(jc._build_params(key))
        monkeypatch.setattr(tc, "_build_params", lambda g, d: built)
    got = tc.fit(to_torch(jinit), p, x, device="cpu", gen=gen(), **fit_kw)
    assert_trees_close(got, want, atol=1e-4)
    assert tc.get_extra_state() == jc.get_extra_state()


def test_softmax_root_histogram_matches_jax():
    _, x = _regression_rows()
    jc = JCPD["softmax_nn"](0, 1, seed=0, n_classes=5, label_smoothing=0.1)
    tc = TCPD["softmax_nn"](0, 1, seed=0, n_classes=5, label_smoothing=0.1)
    key = jax.random.PRNGKey(0)
    want = jc.fit(jc.init(key), key, None, x, epochs=3)
    got = tc.fit(tc.init("cpu", gen()), None, x, device="cpu", gen=gen(),
                 epochs=3)
    assert tc.root_ready and jc.root_ready
    np.testing.assert_array_equal(got["root_log_probs"].numpy(),
                                  np.asarray(want["root_log_probs"]))


def _rff_rows(din, n=512, seed=4):
    g = np.random.default_rng(seed)
    p = g.normal(size=(n, max(din, 1))).astype(np.float32)[:, :din]
    x = (np.sin(p.sum(axis=1, keepdims=True)) + 0.1 * g.normal(size=(n, 1))
         ).astype(np.float32)
    return (p if din else None), x


# Well-conditioned Gram matrices (features of short lengthscale, ridge
# 1e-2), where JAX's float32 solve is accurate to ~1e-5 and both solves
# find the same coefficients; see the next test for the default ridge.
RFF_WELL_POSED = {"n_features": 16, "lengthscale": 0.5, "ridge": 1e-2}


@pytest.mark.parametrize("din,use_bias", [(2, True), (3, False), (0, True)])
def test_rff_fit_matches_jax(din, use_bias):
    p, x = _rff_rows(din)
    kw = dict(RFF_WELL_POSED, use_bias=use_bias)
    jc, tc = JCPD["rff_gaussian"](din, 1, **kw), TCPD["rff_gaussian"](din, 1, **kw)
    jinit = jc.init(jax.random.PRNGKey(7))
    want = jc.fit(jinit, jax.random.PRNGKey(7), p, x)
    got = tc.fit(to_torch(jinit), p, x, device="cpu")
    for k in ("coef", "bias", "var"):
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-3,
                                   atol=1e-3 * max(np.abs(w).max(), 1e-6),
                                   err_msg=k)
    assert_trees_close(got["stats"], want["stats"], atol=1e-6, rtol=1e-6)


def test_rff_float64_solve_is_at_least_as_good_as_jax_float32():
    """At the default ridge (1e-6) with 64 features the Gram matrix is
    ill-conditioned: JAX's float32 solve lands coefficients up to ~400
    that differ from the exact ones by most of their size. The port's
    float64 solve reaches a ridge objective no larger than JAX's."""
    p, x = _rff_rows(2)
    kw = {"n_features": 64}
    jc, tc = JCPD["rff_gaussian"](2, 1, **kw), TCPD["rff_gaussian"](2, 1, **kw)
    jinit = jc.init(jax.random.PRNGKey(7))
    want = jc.fit(jinit, jax.random.PRNGKey(7), p, x)
    got = tc.fit(to_torch(jinit), p, x, device="cpu")

    def objective(params):
        f = {k: np.asarray(v, np.float64) for k, v in flat(params).items()}
        pn = (p - f["stats/mean_x"]) / f["stats/std_x"]
        xn = (x - f["stats/mean_y"]) / f["stats/std_y"]
        phi = np.sqrt(2.0 / 64) * np.cos(pn @ f["rff_w"].T + f["rff_b"])
        theta = np.concatenate([f["coef"], f["bias"][None]])
        r = xn - phi @ f["coef"] - f["bias"]
        return float((r**2).sum() + 1e-6 * (theta**2).sum())

    assert objective(got) <= objective(want) * (1 + 1e-6)


def test_rff_init_draws_frozen_features():
    tc = TCPD["rff_gaussian"](2, 1, n_features=4096, lengthscale=0.5)
    params = tc.init("cpu", gen())
    w, b = params["rff_w"].numpy(), params["rff_b"].numpy()
    assert w.shape == (4096, 2) and b.shape == (4096,)
    assert abs(w.std() - 2.0) < 0.1 and abs(w.mean()) < 0.1
    assert 0.0 <= b.min() and b.max() <= 2 * np.pi
    fitted = tc.fit(params, np.zeros((8, 2)), np.arange(8.0), device="cpu")
    assert torch.equal(fitted["rff_w"], params["rff_w"])


# ---------------------------------------------------------------------------
# host-side bins and supports
# ---------------------------------------------------------------------------


def _bin_rows(n=400, c=6, seed=8):
    g = np.random.default_rng(seed)
    return np.stack([
        g.normal(size=n) * 2.0 + 1.0,          # continuous
        g.integers(0, c, size=n) * 0.5 - 1.0,  # exactly c values: discrete
        np.full(n, 3.0),                       # constant: min-width bins
        g.exponential(size=n),                 # skewed
    ], axis=1).astype(np.float32)


@pytest.mark.parametrize("binning", ["uniform", "gaussian", "quantile"])
@pytest.mark.parametrize("min_bin_width", [1e-12, 0.05])
def test_softmax_bins_match_jax(binning, min_bin_width):
    x = _bin_rows()
    kw = {"n_classes": 6, "binning": binning, "min_bin_width": min_bin_width}
    want = JCPD["softmax_nn"](0, 4, **kw)._compute_bins_host(x)
    got = TCPD["softmax_nn"](0, 4, **kw)._compute_bins_host(x)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert list(got[-1]) == [False, True, False, False]


def test_softmax_bin_mapping_matches_jax():
    x = _bin_rows()
    jc = JCPD["softmax_nn"](0, 4, n_classes=6, binning="quantile")
    tc = TCPD["softmax_nn"](0, 4, n_classes=6, binning="quantile")
    jbins = jc._refresh_bins({"bins": None}, x, allow_expand=False, force=True)
    tbins = tc._bins(x, "cpu")
    assert_trees_close(tbins, jbins, atol=0.0)
    q = np.concatenate([x[:50], x[:50] + 0.01, x[:5] - 100.0]).astype(np.float32)
    np.testing.assert_array_equal(
        tc._x_to_bin(tbins, torch.as_tensor(q)).numpy(),
        np.asarray(jc._x_to_bin(jbins, jnp.asarray(q))))
    assert tbins["edges"].shape == (4, 7)


@pytest.mark.parametrize("declared", [False, True])
def test_embedded_supports_match_jax(declared):
    g = np.random.default_rng(9)
    p = np.stack([g.integers(0, 3, 300), g.integers(0, 5, 300) * 2],
                 axis=1).astype(np.float32)
    x = np.stack([g.integers(0, 4, 300), g.integers(1, 3, 300)],
                 axis=1).astype(np.float32)
    kw = ({"n_classes": 4, "parent_n_classes": [3, 9]} if declared else {})
    want = JCPD["categorical_embedded_softmax"](2, 2, **kw)._resolve_supports(p, x)
    got = TCPD["categorical_embedded_softmax"](2, 2, **kw)._resolve_supports(p, x)
    assert got[1] == want[1] and got[4] == want[4]
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got[2:4], want[2:4]):
        np.testing.assert_array_equal(a, b)
    if declared:
        bad = TCPD["categorical_embedded_softmax"](
            2, 2, n_classes=3, parent_n_classes=[3, 9])
        with pytest.raises(ValueError, match="outside support"):
            bad._resolve_supports(p, x)


# ---------------------------------------------------------------------------
# JAX checkpoints of each family, served by the port
# ---------------------------------------------------------------------------

S_DRAWS = 1 << 14

CKPT_CASES = {
    "gaussian_nn": ({"hidden_dims": [16]}, False),
    "mdn": ({"hidden_dims": [16], "n_components": 3}, False),
    # well-posed (see RFF_WELL_POSED): at ridge 1e-6 the fitted
    # coefficients reach ~400, and the two libraries' float32 rounding of
    # the same features, multiplied by them, moves loc by up to 0.06
    "rff_gaussian": (RFF_WELL_POSED, False),
    "softmax_nn": ({"hidden_dims": [16], "n_classes": 6,
                    "within_bin": "triangular"}, False),
    "softmax_nn-discrete": ({"hidden_dims": [16], "n_classes": 5}, True),
    "categorical_embedded_softmax": ({"hidden_dims": [16],
                                      "embedding_dim": 4}, True),
}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Per case: (JAX model, the port's load of its checkpoint, rows)."""
    root = tmp_path_factory.mktemp("neural_ckpt")
    out = {}
    for case, (kw, discrete) in CKPT_CASES.items():
        name = case.split("-")[0]
        p, x = _discrete_rows(512, 1) if discrete else _regression_rows(512, 1)
        data = {"a": p[:, 0], "b": p[:, 1], "y": x[:, 0]}
        g = nx.DiGraph([("a", "y"), ("b", "y")])
        conf = {n: dict(jdefaults.cpd(name), **kw,
                        fit={"epochs": 20, "batch_size": 128, "lr": 1e-2})
                for n in data}
        jv = JVBN(g, seed=0)
        jv.set_learning_method("node_wise", nodes_cpds=conf)
        jv.fit(data)
        path = str(root / f"{case}.npz")
        jv.save(path)
        out[case] = (jv, TVBN.load(path, device="cpu"), p, x)
    return out


def _query_parents(p, m=64, seed=2):
    g = np.random.default_rng(seed)
    return p[g.integers(0, len(p), m)]


@pytest.mark.parametrize("case", sorted(CKPT_CASES))
def test_checkpoint_log_prob_matches_jax(checkpoints, case):
    jv, tv, p, x = checkpoints[case]
    for node in ("a", "y"):
        pv = None if node == "a" else _query_parents(p)
        m = 1 if pv is None else len(pv)
        vals = (x[:m] if node == "y" else p[:1, :1]).astype(np.float32)
        parents = None if pv is None else {"a": pv[:, 0], "b": pv[:, 1]}
        want = np.asarray(jv.cpd(node).log_prob(vals, parents))
        got = tv.cpd(node).log_prob(vals, parents).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _protocol(handle_out):
    keep = {k: v for k, v in handle_out.items() if k != "type"}
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in keep.items()}


@pytest.mark.parametrize("case", sorted(CKPT_CASES))
def test_checkpoint_protocol_methods_match_jax(checkpoints, case):
    jv, tv, p, _ = checkpoints[case]
    pv = _query_parents(p)
    for node, parents in (("a", None), ("y", {"a": pv[:, 0], "b": pv[:, 1]})):
        jc, tc = jv.cpd(node).conditional(parents), tv.cpd(node).conditional(
            parents)
        assert jc["type"] == tc["type"]
        want, got = _protocol(jc), _protocol(tc)
        assert sorted(want) == sorted(got)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                       err_msg=f"{node} {k}")
        for a, b in zip(tv.cpd(node).conditional_mean_std(parents),
                        jv.cpd(node).conditional_mean_std(parents)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-5)


def _draw_moments_ok(draws, mean, std, what):
    se = std / np.sqrt(len(draws))
    assert abs(draws.mean() - mean) <= 5 * se, what
    # the sample std's standard error, for a near-normal spread
    assert abs(draws.std() - std) <= 5 * std / np.sqrt(2 * len(draws)) + 1e-6, what


@pytest.mark.parametrize("case", sorted(CKPT_CASES))
def test_checkpoint_draws_match_jax_distribution(checkpoints, case):
    """The port's draws at one parent row against the JAX model's exact
    conditional: class frequencies, or mean and std, within 5 standard
    errors at S = 2^14."""
    jv, tv, p, _ = checkpoints[case]
    row = {"a": p[3:4, 0], "b": p[3:4, 1]}
    draws = tv.cpd("y").sample(row, n_samples=S_DRAWS).numpy().reshape(-1)
    cond = jv.cpd("y").conditional(row)
    if cond["type"] == "categorical_probs":
        probs = np.asarray(cond["probs"]).reshape(-1)
        support = np.asarray(cond["support"]).reshape(-1)
        jcpd = jv.nodes["y"]
        if case == "softmax_nn":
            # continuous bins: the bin of each draw, then its within-bin
            # spread (triangular: mean the centre, variance width^2 / 24)
            bins = jv.params["y"]["bins"]
            idx = np.asarray(jcpd._x_to_bin(bins, jnp.asarray(draws[:, None])))
            freq = np.bincount(idx[:, 0], minlength=probs.size) / S_DRAWS
            width = np.diff(np.asarray(bins["edges"])[0])
            var = np.sum(probs * (width**2 / 24 + support**2))
            mean = np.sum(probs * support)
            _draw_moments_ok(draws, mean, np.sqrt(var - mean**2), case)
        else:
            assert np.isin(draws, support[probs > 0]).all()
            freq = np.array([(draws == v).mean() for v in support])
        se = np.sqrt(probs * (1 - probs) / S_DRAWS)
        assert np.all(np.abs(freq - probs) <= 5 * se + 1e-12), (freq, probs)
        return
    mean, std = jv.cpd("y").conditional_mean_std(row)
    _draw_moments_ok(draws, float(np.asarray(mean).reshape(-1)[0]),
                     float(np.asarray(std).reshape(-1)[0]), case)
