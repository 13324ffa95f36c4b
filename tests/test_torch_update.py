"""The port's online update policies against the JAX package, on the CPU.

The JAX package fits and saves; the port loads the checkpoint, so both
start from the same params and optimizer state; both then update on the
same new rows (numpy, from a seed):

- ``streaming_stats`` on ``linear_gaussian`` (the port solves in float64,
  JAX in float32: within 1e-5 of scale), ``categorical_table`` (exact) and
  ``rff_gaussian`` (1e-3 relative, as its fits are held);
- ``online_sgd`` and ``ema`` on ``gaussian_nn`` and ``mdn``, and
  ``online_sgd`` on ``softmax_nn`` (a range that grows rebuilds the bins)
  and ``categorical_embedded_softmax``, with full batches (``batch_size``
  >= rows, where the minibatch order cannot matter but by rounding):
  params and optimizer state within 1e-4, as the fits are held;
- KDE on the eager route while the pool fits in ``max_points``: sorted
  supports equal and log-densities within 1e-5; on the Gumbel top-k route
  a uniform subset, all rows kept while they fit;
- ``replay_buffer``: the buffer and the replayed rows equal exactly (both
  draw them from ``np.random.default_rng(0)``);
- the error paths of ``VBN.update``, the host prechecks of the program
  route, the route choice, and checkpoints both ways with a sampling
  method and a replay buffer.
"""

import warnings

import networkx as nx
import numpy as np
import pytest
import torch

from vectorizedbayesiannetwork_torch import UPDATE_REGISTRY
from vectorizedbayesiannetwork_torch import VBN as TVBN
from vectorizedbayesiannetwork_torch import defaults as tdefaults
from vectorizedbayesiannetwork_torch.core.base import BaseCPD as TBase
from vectorizedbayesiannetwork_torch.models.kde import KDECPD as TKDE
from vectorizedbayesiannetwork_tpu import VBN as JVBN
from vectorizedbayesiannetwork_tpu import defaults as jdefaults
from vectorizedbayesiannetwork_tpu.models.kde import KDECPD as JKDE

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CHAIN = nx.DiGraph([("x0", "x2"), ("x1", "x2")])
FULL = {"n_steps": 3, "batch_size": 4096, "lr": 1e-2, "weight_decay": 0.0}


def chain_data(n=800, seed=0, shift=0.0):
    g = np.random.default_rng(seed)
    x0, x1 = g.normal(size=n) + shift, g.normal(size=n)
    x2 = 0.5 * x0 - 0.2 * x1 + 0.1 * g.normal(size=n)
    return {k: v.astype(np.float32).reshape(-1, 1)
            for k, v in (("x0", x0), ("x1", x1), ("x2", x2))}


def discrete_data(n=900, seed=3):
    g = np.random.default_rng(seed)
    a = g.integers(0, 3, size=n)
    b = (a + g.integers(0, 2, size=n)) % 3
    return {"a": a.astype(np.float32).reshape(-1, 1),
            "b": b.astype(np.float32).reshape(-1, 1)}


def pair(tmp_path, g, conf, data):
    """(JAX VBN, the port's load of its checkpoint)."""
    jv = JVBN(g, seed=0)
    jv.set_learning_method("node_wise", nodes_cpds=conf)
    jv.fit(data)
    jv.save(str(tmp_path / "fit.npz"))
    return jv, TVBN.load(str(tmp_path / "fit.npz"), device="cpu")


def flat(tree, prefix=""):
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
        out[prefix[:-1]] = np.asarray(tree, np.float64)
    return out


def assert_params_close(tv, jv, *, rtol, atol_scale, exact=False):
    for node in jv.params:
        t, j = flat(tv.params[node]), flat(jv.params[node])
        assert set(t) == set(j), (node, set(t) ^ set(j))
        for k in j:
            if exact:
                np.testing.assert_array_equal(t[k], j[k], err_msg=f"{node}/{k}")
            else:
                scale = max(float(np.abs(j[k]).max(initial=0.0)), 1.0)
                np.testing.assert_allclose(t[k], j[k], rtol=rtol,
                                           atol=atol_scale * scale,
                                           err_msg=f"{node}/{k}")


def neural(cpd, **extra):
    c = dict(jdefaults.cpd(cpd), **extra)
    c["fit"] = {"epochs": 3, "batch_size": 4096, "lr": 1e-2}
    c["update"] = dict(FULL)
    return c


CASES = [
    ("linear_gaussian", "streaming_stats"),
    ("rff_gaussian", "streaming_stats"),
    ("gaussian_nn", "online_sgd"),
    ("gaussian_nn", "ema"),
    ("mdn", "online_sgd"),
    ("mdn", "ema"),
    ("softmax_nn", "online_sgd"),
]


@pytest.mark.parametrize("cpd,policy", CASES, ids=[f"{c}-{p}" for c, p in CASES])
def test_policy_matches_jax_on_the_chain(tmp_path, cpd, policy):
    """One update on 600 new rows whose x0 is shifted by 0.5 (so
    ``softmax_nn``'s range grows and its bins are rebuilt)."""
    # rff_gaussian: a well-conditioned Gram matrix (ridge 1e-2, as its fit
    # tests take it), where JAX's float32 solve agrees with the port's
    # float64 one
    extra = {"n_components": 3} if cpd == "mdn" else (
        {"n_features": 16, "lengthscale": 0.5, "ridge": 1e-2}
        if cpd == "rff_gaussian" else (
            {"n_classes": 6} if cpd == "softmax_nn" else {}))
    conf = {k: (neural(cpd, **extra) if cpd not in ("linear_gaussian",
                                                     "rff_gaussian")
                else dict(jdefaults.cpd(cpd), **extra))
            for k in ("x0", "x1", "x2")}
    jv, tv = pair(tmp_path, CHAIN, conf, chain_data())
    new = chain_data(600, seed=1, shift=0.5)
    jv.update(new, update_method=policy)
    tv.update(new, update_method=policy)
    assert tv._last_update_route == ("eager" if cpd == "softmax_nn"
                                     else "program")
    if cpd == "linear_gaussian":
        assert_params_close(tv, jv, rtol=0.0, atol_scale=1e-5)
    elif cpd == "rff_gaussian":
        assert_params_close(tv, jv, rtol=1e-3, atol_scale=1e-4)
    else:
        assert_params_close(tv, jv, rtol=0.0, atol_scale=1e-4)
    if cpd == "softmax_nn":
        for k in ("vmin", "vmax", "edges", "centers", "sample_values"):
            np.testing.assert_array_equal(
                tv.params["x0"]["bins"][k].numpy(),
                np.asarray(jv.params["x0"]["bins"][k]))


@pytest.mark.parametrize("cpd", ["categorical_table",
                                 "categorical_embedded_softmax"])
def test_discrete_streaming_update_matches_jax(tmp_path, cpd):
    """Declared supports: the program route on both sides (counts exact;
    the embedded family's training within 1e-4)."""
    ca = dict(jdefaults.cpd(cpd), n_classes=3)
    if cpd == "categorical_embedded_softmax":
        ca["fit"] = {"epochs": 3, "batch_size": 4096, "lr": 1e-2}
        ca["update"] = dict(FULL)
    cb = dict(ca, parent_n_classes=[3])
    jv, tv = pair(tmp_path, nx.DiGraph([("a", "b")]), {"a": ca, "b": cb},
                  discrete_data())
    new = discrete_data(300, seed=4)
    policy = "streaming_stats" if cpd == "categorical_table" else "online_sgd"
    jv.update(new, update_method=policy)
    tv.update(new, update_method=policy)
    assert tv._last_update_route == "program"
    if cpd == "categorical_table":
        assert_params_close(tv, jv, rtol=0.0, atol_scale=0.0, exact=True)
    else:
        assert_params_close(tv, jv, rtol=0.0, atol_scale=1e-4)


def kde_pair(tmp_path, max_points):
    conf = {k: dict(jdefaults.cpd("kde"), max_points=max_points)
            for k in ("x0", "x1", "x2")}
    return pair(tmp_path, CHAIN, conf, chain_data(200))


def sorted_rows(p):
    rows = np.concatenate([np.asarray(p["data_p"]), np.asarray(p["data_x"])], 1)
    rows = rows[np.asarray(p["valid"]) > 0]
    return rows[np.lexsort(rows.T[::-1])]


def test_kde_eager_update_matches_jax(tmp_path, monkeypatch):
    """The eager route (both sides' programs switched off): 200 stored + 100
    new rows fit in 512, so both keep all of them; the sorted supports are
    equal and so are the log-densities (1e-5)."""
    jv, tv = kde_pair(tmp_path, 512)
    monkeypatch.setattr(TKDE, "update_program", lambda self, conf: None)
    monkeypatch.setattr(JKDE, "update_program", lambda self, conf: None)
    new = chain_data(100, seed=2)
    jv.update(new, update_method="streaming_stats")
    tv.update(new, update_method="streaming_stats")
    assert tv._last_update_route == "eager"
    x = np.random.default_rng(3).normal(size=(64, 1)).astype(np.float32)
    p = np.random.default_rng(4).normal(size=(64, 2)).astype(np.float32)
    for node in ("x0", "x1", "x2"):
        np.testing.assert_array_equal(sorted_rows(tv.params[node]),
                                      sorted_rows(jv.params[node]))
        assert int(tv.params[node]["valid"].sum()) == 300
        pp = p if node == "x2" else None
        got = tv.nodes[node]._log_prob_flat(
            tv.params[node], torch.tensor(x),
            None if pp is None else torch.tensor(pp)).numpy()
        want = np.asarray(jv.nodes[node]._log_prob_flat(jv.params[node], x, pp))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("max_points", [512, 256])
def test_kde_program_update_is_a_uniform_subset(tmp_path, max_points):
    """The Gumbel top-k route: all 300 rows kept while they fit (the JAX
    program's set), else ``max_points`` distinct rows of the pool."""
    jv, tv = kde_pair(tmp_path, max_points)
    new = chain_data(100, seed=2)
    pool = {n: sorted_rows(tv.params[n]) for n in ("x0", "x2")}
    tv.update(new, update_method="streaming_stats")
    assert tv._last_update_route == "program"
    if max_points == 512:
        jv.update(new, update_method="streaming_stats")
        for node in ("x0", "x1", "x2"):
            np.testing.assert_array_equal(sorted_rows(tv.params[node]),
                                          sorted_rows(jv.params[node]))
        return
    new_rows = {"x0": new["x0"],
                "x2": np.concatenate([new["x0"], new["x1"], new["x2"]], 1)}
    for node in ("x0", "x2"):
        rows = sorted_rows(tv.params[node])
        assert rows.shape[0] == max_points
        assert len(np.unique(rows, axis=0)) == max_points
        allowed = np.concatenate([pool[node], new_rows[node]])
        assert all((allowed == r).all(axis=1).any() for r in rows)


def test_replay_buffer_matches_jax_exactly(tmp_path):
    conf = {k: dict(jdefaults.cpd("linear_gaussian")) for k in ("x0", "x1", "x2")}
    jv, tv = pair(tmp_path, CHAIN, conf, chain_data())
    for seed in (1, 2):
        new = chain_data(120, seed=seed)
        kw = {"update_method": "replay_buffer", "max_size": 150} if seed == 1 else {}
        jv.update(new, **kw)
        tv.update(new, **kw)
    for node in ("x0", "x1", "x2"):
        jp, jx = jv._update_policy._buffer[node]
        tp, tx = tv._update_policy._buffer[node]
        assert tx.shape[0] == 150
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tx, jx)
    assert_params_close(tv, jv, rtol=0.0, atol_scale=1e-5)


def test_replay_mix_is_the_jax_mix():
    """The mixed rows of one node, for the same buffer and rng state."""
    from vectorizedbayesiannetwork_torch.update.policies import (
        ReplayBufferUpdate as TR,
    )
    from vectorizedbayesiannetwork_tpu.update.policies import (
        ReplayBufferUpdate as JR,
    )

    g = np.random.default_rng(9)
    t, j = TR(max_size=40, replay_ratio=0.7), JR(max_size=40, replay_ratio=0.7)
    for step in range(3):
        p, x = g.normal(size=(25, 2)), g.normal(size=(25, 1))
        for pol in (t, j):
            pol._update_buffer("n", p, x)
        tp, tx = t._mix_with_replay("n", p, x)
        jp, jx = j._mix_with_replay("n", p, x)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tx, jx)


# -- routes ---------------------------------------------------------------------
def test_program_route_equals_eager_route(monkeypatch):
    """LG + gaussian_nn: the program route and the eager one give the same
    params bit for bit (the same generators, the same functions)."""
    def build():
        v = TVBN([("x0", "x1")], seed=0, device="cpu")
        v.set_learning_method("node_wise", nodes_cpds={
            "x0": tdefaults.cpd("linear_gaussian"),
            "x1": dict(tdefaults.cpd("gaussian_nn"),
                       fit={"epochs": 2, "batch_size": 256, "lr": 1e-2})})
        data = chain_data(500)
        v.fit({"x0": data["x0"], "x1": data["x2"]})
        return v, {"x0": data["x0"][:256], "x1": data["x2"][:256]}

    v1, new = build()
    v1.update(new, update_method="online_sgd")
    assert v1._last_update_route == "program"
    v2, new = build()
    for cls in {type(v2.nodes[n]) for n in v2.nodes}:
        monkeypatch.setattr(cls, "update_program", lambda self, conf: None)
    v2.update(new, update_method="online_sgd")
    assert v2._last_update_route == "eager"
    for node in ("x0", "x1"):
        a, b = flat(v1.params[node]), flat(v2.params[node])
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_inferred_supports_take_the_eager_route():
    data = discrete_data()
    v = TVBN([("a", "b")], seed=0, device="cpu")
    v.set_learning_method("node_wise", nodes_cpds={
        n: tdefaults.cpd("categorical_table") for n in ("a", "b")})
    v.fit(data)
    v.update(discrete_data(100, seed=5), update_method="streaming_stats")
    assert v._last_update_route == "eager"


def test_update_trains_under_no_grad():
    """A caller's ``torch.no_grad()`` does not stop a training policy."""
    v = TVBN([("x0", "x2"), ("x1", "x2")], seed=0, device="cpu")
    v.set_learning_method("node_wise", nodes_cpds={
        k: neural("gaussian_nn") for k in ("x0", "x1", "x2")})
    v.fit(chain_data())
    before = v.params["x2"]["net"]["layers"][0]["w"].clone()
    with torch.no_grad():
        v.update(chain_data(100, seed=2), update_method="online_sgd")
    after = v.params["x2"]["net"]["layers"][0]["w"]
    assert not torch.equal(before, after) and not after.requires_grad


def test_update_never_calls_fit(monkeypatch):
    v = TVBN([("x0", "x2"), ("x1", "x2")], seed=0, device="cpu")
    v.set_learning_method("node_wise", nodes_cpds={
        k: neural("gaussian_nn") for k in ("x0", "x1", "x2")})
    v.fit(chain_data())

    def boom(*a, **k):
        raise AssertionError("update must not call fit")

    for node in v.nodes:
        monkeypatch.setattr(type(v.nodes[node]), "fit", boom)
    before = v.params["x2"]["net"]["layers"][0]["w"].clone()
    v.update(chain_data(100, seed=2), update_method="online_sgd")
    assert not torch.equal(before, v.params["x2"]["net"]["layers"][0]["w"])


# -- errors ---------------------------------------------------------------------
@pytest.fixture()
def lg_port():
    v = TVBN([("x0", "x2"), ("x1", "x2")], seed=0, device="cpu")
    v.set_learning_method("node_wise", nodes_cpds={
        k: tdefaults.cpd("linear_gaussian") for k in ("x0", "x1", "x2")})
    v.fit(chain_data())
    return v


def test_update_rejects_training_keys(lg_port):
    with pytest.raises(ValueError, match="per-CPD"):
        lg_port.update(chain_data(50), update_method="online_sgd", lr=0.1)
    lg_port.update(chain_data(50), update_method="online_sgd")
    with pytest.raises(ValueError, match="per-CPD"):
        lg_port.update(chain_data(50), n_steps=3)


def test_ema_rejects_closed_form(lg_port):
    with pytest.raises(NotImplementedError):
        lg_port.update(chain_data(50), update_method="ema")


def test_update_requires_first_method(lg_port):
    with pytest.raises(RuntimeError, match="update_method"):
        lg_port.update(chain_data(50))


def test_update_before_fit():
    v = TVBN([("x0", "x2"), ("x1", "x2")], seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="fit"):
        v.update(chain_data(50), update_method="online_sgd")


def test_unknown_update_method(lg_port):
    with pytest.raises(ValueError, match="Unknown update method"):
        lg_port.update(chain_data(50), update_method="nope")


@pytest.mark.parametrize("bad,match", [
    (None, "must include an 'update' dict"),
    ({"lr": 1e-3, "n_steps": 1}, "missing required keys"),
    ({"lr": 1e-3, "n_steps": 1, "batch_size": 8, "epochs": 2}, "Unknown keys"),
])
def test_node_update_config_errors(lg_port, bad, match):
    conf = lg_port._learning_config["nodes_cpds"]["x2"]
    if bad is None:
        conf.pop("update")
    else:
        conf["update"] = bad
    with pytest.raises(ValueError, match=match):
        lg_port.update(chain_data(50), update_method="streaming_stats")


@pytest.mark.parametrize("cpd", ["categorical_table",
                                 "categorical_embedded_softmax"])
@pytest.mark.parametrize("where", ["target", "parent"])
def test_program_route_prechecks(cpd, where):
    """Rows outside the declared supports raise before any program runs."""
    c = dict(tdefaults.cpd(cpd), n_classes=3)
    if cpd == "categorical_embedded_softmax":
        c["fit"] = {"epochs": 1, "batch_size": 512, "lr": 1e-2}
    v = TVBN([("a", "b")], seed=0, device="cpu")
    v.set_learning_method("node_wise", nodes_cpds={
        "a": c, "b": dict(c, parent_n_classes=[3])})
    v.fit(discrete_data())
    before = {n: flat(v.params[n]) for n in v.params}
    bad = discrete_data(50, seed=6)
    bad["b" if where == "target" else "a"][0, 0] = 7.0
    with pytest.raises(ValueError, match="outside support"):
        v.update(bad, update_method="streaming_stats")
    for n in v.params:  # nothing updated
        for k, a in flat(v.params[n]).items():
            np.testing.assert_array_equal(a, before[n][k])


def test_softmax_discrete_update_refuses_new_classes():
    c = dict(tdefaults.cpd("softmax_nn"), n_classes=3,
             fit={"epochs": 1, "batch_size": 512, "lr": 1e-2})
    v = TVBN([("a", "b")], seed=0, device="cpu")
    v.set_learning_method("node_wise", nodes_cpds={"a": c, "b": c})
    v.fit(discrete_data())
    bad = discrete_data(50, seed=6)
    bad["b"][0, 0] = 1.5
    with pytest.raises(ValueError, match="discrete class set"):
        v.update(bad, update_method="online_sgd")


# -- checkpoints ---------------------------------------------------------------
def test_jax_checkpoint_with_sampling_and_replay_loads_and_continues(tmp_path):
    conf = {k: dict(jdefaults.cpd("linear_gaussian")) for k in ("x0", "x1", "x2")}
    jv = JVBN(CHAIN, seed=0)
    jv.set_learning_method("node_wise", nodes_cpds=conf)
    jv.fit(chain_data())
    jv.update(chain_data(100, seed=1), update_method="replay_buffer",
              max_size=180, replay_ratio=0.4)
    jv.set_sampling_method("gibbs", n_chains=4)
    jv.save(str(tmp_path / "j.npz"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tv = TVBN.load(str(tmp_path / "j.npz"), device="cpu")
    assert tv._sampling_config == {"name": "gibbs", "params": {"n_chains": 4}}
    assert tv._sampling.n_chains == 4
    assert tv._update_policy.max_size == 180
    s = tv.sample({"target": "x0", "evidence": {"x2": [[0.5]]}}, n_samples=16)
    assert tuple(s.shape) == (1, 16, 1)
    jv2 = JVBN.load(str(tmp_path / "j.npz"))  # the same restart on both sides
    new = chain_data(100, seed=2)
    jv2.update(new)
    tv.update(new)
    for node in ("x0", "x1", "x2"):
        np.testing.assert_array_equal(tv._update_policy._buffer[node][1],
                                      jv2._update_policy._buffer[node][1])
    assert_params_close(tv, jv2, rtol=0.0, atol_scale=1e-5)


def test_port_checkpoint_loads_into_jax(tmp_path):
    tv = TVBN([("x0", "x2"), ("x1", "x2")], seed=0, device="cpu")
    tv.set_learning_method("node_wise", nodes_cpds={
        k: tdefaults.cpd("linear_gaussian") for k in ("x0", "x1", "x2")})
    tv.fit(chain_data())
    tv.update(chain_data(100, seed=1), update_method="replay_buffer",
              max_size=150)
    tv.set_sampling_method("hmc", n_chains=2)
    tv.save(str(tmp_path / "t.npz"))
    jv = JVBN.load(str(tmp_path / "t.npz"))
    assert jv._sampling_config["name"] == "hmc"
    assert type(jv._update_policy).__name__ == "ReplayBufferUpdate"
    assert jv._update_policy.max_size == 150
    for node in ("x0", "x1", "x2"):
        for a, b in zip(tv._update_policy._buffer[node],
                        jv._update_policy._buffer[node]):
            np.testing.assert_array_equal(a, b)
    s = np.asarray(jv.sample({"target": "x0", "evidence": {"x2": [[0.5]]}},
                             n_samples=8, burn_in=2))
    assert s.shape == (1, 8, 1)


def test_registries_match_jax():
    from vectorizedbayesiannetwork_tpu import SAMPLING_REGISTRY as JS
    from vectorizedbayesiannetwork_tpu import UPDATE_REGISTRY as JU
    from vectorizedbayesiannetwork_torch import SAMPLING_REGISTRY as TS

    assert sorted(TS) == sorted(JS)
    assert sorted(UPDATE_REGISTRY) == sorted(JU)
    for name in sorted(JS):
        assert tdefaults.sampling(name) == jdefaults.sampling(name)
    for name in sorted(JU):
        assert tdefaults.update(name) == jdefaults.update(name)
    assert TBase.update_program(None, {}) is None
