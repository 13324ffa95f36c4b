"""The port's grouped neural fit against the JAX package's and its own
sequential fit, on the CPU.

- ``fit_many`` of ``gaussian_nn`` (a child and a root) and ``mdn``, from
  the JAX initial weights of three nodes on full batches (``batch_size >=
  n``: the permutation cannot change a node's mean NLL but by rounding),
  plain and with weight decay and clipping: params, standardization and
  Adam state within 1e-4 of JAX ``fit_many``;
- ``VBN_FIT_GROUP=always`` against ``never`` on the star z -> y0..y3 of
  ``tests/test_fit_grouping.py`` (minibatches, each node its own
  generator): every leaf within rtol 2e-3 / atol 2e-4, the JAX test's
  limits, for ``gaussian_nn`` and ``mdn``, plain and clipped;
- the clip is per node: with one node's gradient norm above
  ``max_grad_norm`` and the other's below, the grouped loop equals each
  node's own sequential loop within 1e-5;
- groups form by (class, static fields, dims, fit keys), a group of one
  stays sequential, and an update after a grouped fit runs sequentially.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vectorizedbayesiannetwork_torch import VBN as TVBN
from vectorizedbayesiannetwork_torch import defaults as tdefaults
from vectorizedbayesiannetwork_torch import params_from_tree
from vectorizedbayesiannetwork_torch.core.registry import CPD_REGISTRY as TCPD
from vectorizedbayesiannetwork_torch.models._optim import (
    tree_leaves,
    tree_unflatten,
)
from vectorizedbayesiannetwork_torch.models._train import (
    fit_minibatch_nll,
    fit_minibatch_nll_many,
    stack_trees,
    unstack_fit,
)
from vectorizedbayesiannetwork_tpu.core.registry import CPD_REGISTRY as JCPD

N_SIBLINGS = 4


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


def _rows(g_count, n=192, din=2, seed=0):
    """G nodes' (parents, x): each its own coefficients and noise."""
    g = np.random.default_rng(seed)
    ps, xs = [], []
    for i in range(g_count):
        p = g.normal(size=(n, din)).astype(np.float32)
        x = (p @ g.normal(size=(din, 1)) * (0.5 + i)
             + (0.1 + 0.2 * i) * g.normal(size=(n, 1)) + i)
        ps.append(p if din else None)
        xs.append(x.astype(np.float32))
    return ps, xs


MANY_CASES = {
    "gaussian_nn": ("gaussian_nn", {"hidden_dims": [16]}, 2),
    "gaussian_nn-root": ("gaussian_nn", {}, 0),
    "mdn": ("mdn", {"hidden_dims": [16], "n_components": 3}, 2),
}


@pytest.mark.parametrize("case", sorted(MANY_CASES))
@pytest.mark.parametrize("fit_kw", [
    {"lr": 1e-2}, {"lr": 1e-2, "weight_decay": 1e-2, "max_grad_norm": 0.5}],
    ids=["plain", "decay-clip"])
def test_fit_many_matches_jax(case, fit_kw):
    name, kw, din = MANY_CASES[case]
    ps, xs = _rows(3, din=din)
    jc, tc = JCPD[name](din, 1, seed=0, **kw), TCPD[name](din, 1, seed=0, **kw)
    keys = [jax.random.PRNGKey(10 + i) for i in range(3)]
    jinit = [jc.init(k) for k in keys]
    if case == "gaussian_nn-root":
        # off the standardized data's mean (see test_torch_neural.py)
        for p in jinit:
            p["net"]["loc"] = jnp.full((1,), 0.3, jnp.float32)
    fit_kw = dict(fit_kw, epochs=5, batch_size=len(xs[0]))
    want = jc.fit_many(jinit, keys, ps, xs, **fit_kw)
    gens = [torch.Generator().manual_seed(i) for i in range(3)]
    got = tc.fit_many([params_from_tree(p, "cpu") for p in jinit], ps, xs,
                      device="cpu", gens=gens, **fit_kw)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert_trees_close(g, w, atol=1e-4)


def test_jax_stacked_nets_carry_across():
    """A JAX group's nets stacked on their leading axis become the port's
    stacked tree, leaf for leaf, and unstack to each node's net."""
    jc = JCPD["gaussian_nn"](2, 1, seed=0, hidden_dims=[16])
    nets = [jc.init(jax.random.PRNGKey(i))["net"] for i in range(3)]
    jstack = jax.tree_util.tree_map(lambda *ls: jnp.stack(ls), *nets)
    tstack = params_from_tree(jstack, "cpu")
    assert_trees_close(tstack, jstack, atol=0.0)
    assert_trees_close(stack_trees([params_from_tree(n, "cpu") for n in nets]),
                       jstack, atol=0.0)
    opts = {"m": tstack, "v": tstack, "step": torch.arange(3.0)}
    for i, n in enumerate(nets):
        net, opt = unstack_fit(tstack, opts, i)
        assert_trees_close(net, n, atol=0.0)
        assert float(opt["step"]) == i


def _star_data(n=600, seed=0):
    g = np.random.default_rng(seed)
    z = g.normal(size=n)
    cols = {"z": z}
    for i in range(N_SIBLINGS):
        cols[f"y{i}"] = (0.3 + 0.2 * i) * z + 0.1 * g.normal(size=n)
    return cols


def _star_fit(monkeypatch, cpd_name, grouping, fit_extra=None, confs=None):
    monkeypatch.setenv("VBN_FIT_GROUP", grouping)
    cfg = dict(tdefaults.cpd(cpd_name), hidden_dims=[16])
    cfg["fit"] = {**cfg["fit"], "epochs": 4, "batch_size": 128,
                  **(fit_extra or {})}
    v = TVBN([("z", f"y{i}") for i in range(N_SIBLINGS)], seed=0,
             device="cpu")
    v.set_learning_method("node_wise", nodes_cpds={
        "z": tdefaults.cpd("linear_gaussian"),
        **{f"y{i}": (confs or {}).get(f"y{i}", cfg)
           for i in range(N_SIBLINGS)}})
    v.fit(_star_data())
    return v


@pytest.mark.parametrize("cpd_name", ["gaussian_nn", "mdn"])
@pytest.mark.parametrize("fit_extra", [None, {"max_grad_norm": 0.5}],
                         ids=["plain", "clip"])
def test_grouped_fit_matches_sequential(monkeypatch, cpd_name, fit_extra):
    vg = _star_fit(monkeypatch, cpd_name, "always", fit_extra)
    vs = _star_fit(monkeypatch, cpd_name, "never", fit_extra)
    for i in range(N_SIBLINGS):
        node = f"y{i}"
        assert float(vg.params[node]["opt"]["step"]) == float(
            vs.params[node]["opt"]["step"]) == 20.0
        assert_trees_close(vg.params[node], vs.params[node], atol=2e-4,
                           rtol=2e-3)


def test_clip_binds_per_node():
    """Node 1's data is 100x node 0's: its first gradient's norm is far
    past max_grad_norm while node 0's stays under it, and the grouped loop
    clips each node by its own norm, as its sequential loop does."""
    cpd = TCPD["gaussian_nn"](2, 1, seed=0, hidden_dims=[16])
    ps, xs = _rows(2, n=256)
    xs[1] = xs[1] * 100.0
    p_t = [torch.as_tensor(p) for p in ps]
    x_t = [torch.as_tensor(x) for x in xs]
    nets = [cpd.init("cpu", gen=torch.Generator().manual_seed(i))["net"]
            for i in range(2)]
    mgn = 5.0
    norms = []
    for net, p, x in zip(nets, p_t, x_t):
        leaves = [t.clone().requires_grad_(True) for t in tree_leaves(net)]
        loss = cpd._nll(tree_unflatten(net, leaves), p, x)
        grads = torch.autograd.grad(loss, leaves)
        norms.append(float(torch.sqrt(sum((g * g).sum() for g in grads))))
    assert norms[0] < mgn < norms[1], norms
    kw = dict(epochs=3, batch_size=64, lr=1e-2, max_grad_norm=mgn)
    seq = [fit_minibatch_nll(cpd._nll, net, None,
                             torch.Generator().manual_seed(20 + i), p, x, **kw)
           for i, (net, p, x) in enumerate(zip(nets, p_t, x_t))]
    gens = [torch.Generator().manual_seed(20 + i) for i in range(2)]
    nets_g, opts_g = fit_minibatch_nll_many(
        cpd._nll, stack_trees(nets), gens, torch.stack(p_t),
        torch.stack(x_t), **kw)
    for i, (net_s, opt_s) in enumerate(seq):
        net_g, opt_g = unstack_fit(nets_g, opts_g, i)
        assert_trees_close(net_g, net_s, atol=1e-5, rtol=1e-5)
        assert_trees_close(opt_g, opt_s, atol=1e-5, rtol=1e-5)


def test_groups_form_by_signature(monkeypatch):
    """y0 and y1 share a signature and fit as one group; y2 (other widths)
    and y3 (another fit budget) are groups of one and fit sequentially."""
    calls = []
    cls = TCPD["gaussian_nn"]
    orig = cls.fit_many

    def recording(self, params_list, *a, **k):
        calls.append(len(params_list))
        return orig(self, params_list, *a, **k)

    monkeypatch.setattr(cls, "fit_many", recording)
    base = dict(tdefaults.cpd("gaussian_nn"), hidden_dims=[16])
    base["fit"] = {**base["fit"], "epochs": 2, "batch_size": 128}
    confs = {"y0": base, "y1": dict(base),
             "y2": dict(base, hidden_dims=[8]),
             "y3": dict(base, fit=dict(base["fit"], epochs=3))}
    v = _star_fit(monkeypatch, "gaussian_nn", "always", confs=confs)
    assert calls == [2]
    steps = {n: float(v.params[n]["opt"]["step"]) for n in confs}
    assert steps == {"y0": 10.0, "y1": 10.0, "y2": 10.0, "y3": 15.0}


def test_update_after_grouped_fit_stays_sequential(monkeypatch):
    v = _star_fit(monkeypatch, "gaussian_nn", "always")
    params = [v.params[f"y{i}"] for i in range(2)]
    assert v.nodes["y0"].fit_many(params, [None, None], [None, None],
                                  device="cpu", gens=[None, None]) is None
    new = {k: c[:128] for k, c in _star_data(seed=1).items()}
    v.update(new, update_method="online_sgd")
    assert float(v.params["y0"]["opt"]["step"]) == 21.0
    v.set_inference_method("monte_carlo_marginalization", n_samples=64)
    pdf, s = v.infer_posterior({"target": "y0", "evidence": {"z": [[0.5]]}})
    assert torch.isfinite(pdf).all() and s.shape == (1, 64, 1)
