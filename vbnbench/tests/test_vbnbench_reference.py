"""The plain reference: variable elimination against brute-force
enumeration on asia, the likelihood-weighting variance against the
spread of plain likelihood weighting, and the refits against the port's
own fits on the CPU."""

import itertools

import numpy as np
import pytest
import torch

from vbnbench.networks.discrete import ancestral_sample
from vbnbench.reference.cat_lw import lw_pmf
from vbnbench.reference.fit import categorical_cpts, scott_bandwidths
from vbnbench.reference.ve import Exact

from .test_vbnbench_work import asia


def random_asia(seed=0):
    net = asia()
    rng = np.random.default_rng(seed)
    for n in net.nodes:
        shape = net.cpts[n].shape
        net.cpts[n] = rng.dirichlet(np.full(2, 0.6), size=shape[:-1]).reshape(shape)
    return net


def brute(net, target, evidence, square=False):
    """(P(t, e), M2(t, e)) by enumerating all 2^8 states."""
    p = np.zeros(2)
    m2 = np.zeros(2)
    for states in itertools.product(range(2), repeat=len(net.nodes)):
        x = dict(zip(net.nodes, states))
        if any(x[n] != v for n, v in evidence.items()):
            continue
        q, w = 1.0, 1.0
        for n in net.nodes:
            pr = net.cpts[n][tuple(x[a] for a in net.parents[n]) + (x[n],)]
            if n in evidence:
                w *= pr
            else:
                q *= pr
        p[x[target]] += q * w
        m2[x[target]] += q * w * w
    return p, m2


@pytest.mark.parametrize("target,evidence", [
    ("dysp", {}), ("lung", {"xray": 1}), ("either", {"asia": 0, "dysp": 1}),
    ("smoke", {"xray": 0, "dysp": 1, "tub": 0}), ("asia", {"either": 1})])
def test_ve_against_enumeration(target, evidence):
    net = random_asia(3)
    ex = Exact(net.nodes, net.parents, net.cards, net.cpts)
    p, var = ex.answer(target, evidence)
    pt, m2 = brute(net, target, evidence)
    z = pt.sum()
    np.testing.assert_allclose(p, pt / z, rtol=1e-12)
    want = [((np.arange(2) == c) - (pt / z)[c]) ** 2 @ m2 / z**2 for c in range(2)]
    np.testing.assert_allclose(var, want, rtol=1e-10)


def test_lw_variance_matches_the_spread_of_lw():
    net = random_asia(5)
    ex = Exact(net.nodes, net.parents, net.cards, net.cpts)
    row = ("either", {"asia": 0, "dysp": 1, "xray": 0})
    p, var = ex.answer(*row)
    gen = torch.Generator().manual_seed(11)
    s = 512
    est = lw_pmf(net.nodes, net.parents, net.cards, net.cpts, [row] * 600, s,
                 gen, "cpu")[:, :2]
    for c in range(2):
        assert abs(est[:, c].mean() - p[c]) < 4 * np.sqrt(var[c] / s / 600)
        assert est[:, c].var() == pytest.approx(var[c] / s, rel=0.25)


def test_categorical_refit_matches_the_port():
    from vectorizedbayesiannetwork_torch import VBN, defaults

    net = random_asia(7)
    data = ancestral_sample(net, 2000, seed=1)
    vbn = VBN({n: net.parents[n] for n in net.nodes}, seed=0, device="cpu")
    conf = {}
    for n in net.nodes:
        c = dict(defaults.cpd("categorical_table"), n_classes=2)
        if net.parents[n]:
            c["parent_n_classes"] = [2] * len(net.parents[n])
        conf[n] = c
    vbn.set_learning_method("node_wise", nodes_cpds=conf)
    vbn.fit({k: v.astype(np.float32).reshape(-1, 1) for k, v in data.items()})
    d = defaults.cpd("categorical_table")
    ours = categorical_cpts(net.nodes, net.parents, net.cards, data,
                            alpha=d["alpha"], alpha_mode=d["alpha_mode"],
                            prior=d["prior"])
    for n in net.nodes:
        counts = vbn.params[n]["counts"][0].double().numpy()
        theirs = counts / counts.sum(-1, keepdims=True)
        np.testing.assert_allclose(ours[n].reshape(theirs.shape), theirs,
                                   rtol=1e-6)


def test_scott_bandwidths_match_the_port():
    from vectorizedbayesiannetwork_torch import VBN, defaults

    rng = np.random.default_rng(0)
    x0 = rng.normal(size=3000)
    x1 = 0.7 * x0 + rng.normal(scale=0.5, size=3000)
    vbn = VBN({"x0": [], "x1": ["x0"]}, seed=0, device="cpu")
    vbn.set_learning_method("node_wise", nodes_cpds={
        k: dict(defaults.cpd("kde"), max_points=1024) for k in ("x0", "x1")})
    vbn.fit({"x0": x0.astype(np.float32)[:, None],
             "x1": x1.astype(np.float32)[:, None]})
    for n, x, p in (("x0", x0, np.zeros((3000, 0))), ("x1", x1, x0[:, None])):
        bw, pbw = scott_bandwidths(x[:, None].astype(np.float32),
                                   p.astype(np.float32), 1024)
        assert bw == pytest.approx(vbn.nodes[n].bandwidth, rel=1e-5)
        assert pbw == pytest.approx(vbn.nodes[n].parent_bandwidth, rel=1e-5)
        assert vbn.params[n]["data_p"].shape[1] == p.shape[1]


def test_kde_support_check_counts_rows_as_a_multiset():
    from types import SimpleNamespace

    from vbnbench.reference.kde import support_bad

    x0 = np.array([0.5, 0.5, 2.0], np.float32)  # a row the data holds twice
    x1 = np.array([1.0, 2.0, 3.0], np.float32)
    cell = SimpleNamespace(
        net=SimpleNamespace(nodes=["x0", "x1"], parents={"x0": [], "x1": ["x0"]}),
        data={"x0": x0, "x1": x1})

    def kept(x0_kept, valid=None):
        k = np.asarray(x0_kept, np.float32)[:, None]
        v = np.ones(len(k)) if valid is None else np.asarray(valid, np.float32)
        return {"x0": (np.zeros((len(k), 0), np.float32), k, v),
                "x1": (x0[:, None], x1[:, None], np.ones(3))}

    assert support_bad(cell, kept([2.0, 0.5, 0.5])) == 0  # another order
    assert support_bad(cell, kept([0.5, 0.5, 0.5])) == 2  # 2.0 lost, 0.5 extra
    assert support_bad(cell, kept([0.5, 3.0, 2.0])) == 2  # 0.5 lost, 3.0 extra
    assert support_bad(cell, kept([0.5, 0.5])) == 1  # a row left out
    assert support_bad(cell, kept([0.5, 0.5, 2.0, 2.0], [1, 1, 1, 0])) == 0
