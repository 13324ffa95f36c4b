"""Mask-dynamic serving in the port, as a whole, on the CPU.

Both packages serve one fitted model (the JAX fit, saved and loaded by the
port) with ``dynamic_masks=True``. The JAX package serves it on the CPU
through its XLA sweep and the port through the scan kernels' plain
versions (or its torch-op sweep for mixed families), so their draws differ
and only distributions compare: posteriors are held against the exact ones
(``exact_posterior``, ``GaussianBN.conditional``) and against each other
within Monte-Carlo error at S = 2^14 (a row's sd is about 0.004).
"""

import inspect

import networkx as nx
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from benchmarking.data_gen import generate_dataset
from benchmarking.exact import exact_posterior
from benchmarking.gaussian_bn import GaussianBN, random_gaussian
from benchmarking.networks import random_bn_treewidth
from vectorizedbayesiannetwork_torch import VBN as TVBN
from vectorizedbayesiannetwork_torch import defaults as tdefaults
from vectorizedbayesiannetwork_torch.core.base import Query as TQuery
from vectorizedbayesiannetwork_torch.core.plan import get_plan as t_get_plan
from vectorizedbayesiannetwork_torch.core.rng import Draw
from vectorizedbayesiannetwork_torch.inference import _dynamic_base as tdyn
from vectorizedbayesiannetwork_torch.inference import _dynamic_sweep as tdsw
from vectorizedbayesiannetwork_torch.models.kde import KDECPD as TKDE
from vectorizedbayesiannetwork_torch.ops import kde_fused as tkf
from vectorizedbayesiannetwork_torch.ops._launch import LAUNCHES
from vectorizedbayesiannetwork_torch.ops import sweep as tsweep
from vectorizedbayesiannetwork_torch.ops import sweep_scan as tscan
from vectorizedbayesiannetwork_tpu import VBN as JVBN
from vectorizedbayesiannetwork_tpu import defaults as jdefaults
from vectorizedbayesiannetwork_tpu.inference import _dynamic_base as jdyn
from vectorizedbayesiannetwork_tpu.inference import _dynamic_sweep as jdsw

S = 1 << 14


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread here: the suite runs several test processes at
    once, and the plain versions' small ops gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph(bn):
    g = nx.DiGraph()
    g.add_nodes_from(bn.nodes)
    g.add_edges_from(bn.edges())
    return g


@pytest.fixture(scope="module")
def cat(tmp_path_factory):
    """A 10-node bounded-treewidth network (chains and a two-parent node;
    small, because the JAX side compiles a program per method), JAX-fitted,
    and the port's load of it."""
    bn = random_bn_treewidth(10, seed=3)
    jv = JVBN(_graph(bn), seed=0)
    conf = {}
    for node in bn.nodes:
        c = dict(jdefaults.cpd("categorical_table"), n_classes=bn.card(node))
        if bn.parents[node]:
            c["parent_n_classes"] = [bn.card(p) for p in bn.parents[node]]
        conf[node] = c
    jv.set_learning_method("node_wise", nodes_cpds=conf)
    data = generate_dataset(bn, 4096, seed=0)
    jv.fit({k: np.asarray(v, np.float32).reshape(-1, 1) for k, v in data.items()})
    path = tmp_path_factory.mktemp("cat")
    jv.save(str(path))
    tv = TVBN.load(str(path), device="cpu")
    return bn, jv, tv


@pytest.fixture(scope="module")
def gauss(tmp_path_factory):
    gbn = random_gaussian(9, seed=0)
    jv = JVBN(_graph(gbn), seed=0)
    jv.set_learning_method(
        "node_wise",
        nodes_cpds={n: jdefaults.cpd("linear_gaussian") for n in gbn.nodes})
    jv.fit({k: v.reshape(-1, 1) for k, v in gbn.sample(4096, seed=0).items()})
    path = tmp_path_factory.mktemp("gauss")
    jv.save(str(path))
    return gbn, jv, TVBN.load(str(path), device="cpu")


def _fitted_discrete(bn, tv):
    """The exact engine's network with the port's fitted CPTs."""
    from benchmarking.bif import DiscreteBN

    fit = DiscreteBN(name="fitted")
    for node in tv.dag.topological_order():
        cnt = tv.params[node]["counts"][0].double().numpy()
        cards = tuple(bn.card(p) for p in tv.dag.parents(node))
        fit.nodes.append(node)
        fit.states[node] = bn.states[node]
        fit.parents[node] = list(tv.dag.parents(node))
        fit.cpts[node] = (cnt / cnt.sum(-1, keepdims=True)).reshape(
            cards + (cnt.shape[-1],))
    return fit


def _fitted_gaussian(tv):
    fit = GaussianBN(name="fitted")
    for node in tv.dag.topological_order():
        p = tv.params[node]
        fit.nodes.append(node)
        fit.parents[node] = list(tv.dag.parents(node))
        fit.weights[node] = p["weight"][:, 0].double().tolist()
        fit.bias[node] = float(p["bias"][0])
        fit.sigma[node] = float(np.sqrt(max(float(p["var"][0]),
                                            tv.nodes[node].min_scale ** 2)))
    return fit


def _q(target, evidence=None, do=None):
    col = lambda v: np.full((1, 1), float(v), np.float32)  # noqa: E731
    return {"target": target,
            "evidence": {k: col(v) for k, v in (evidence or {}).items()},
            "do": {k: col(v) for k, v in (do or {}).items()}}


def _cat_queries(bn):
    n = list(bn.nodes)
    return [
        (n[-1], {n[0]: 1}),
        (n[4], {n[-1]: 0, n[7]: 1}),
        (n[1], {}),
        (n[6], {n[2]: 0}),
    ]


def _norm(rows):
    return rows / rows.sum(axis=1, keepdims=True)


def _set(v, method, **kw):
    v.set_inference_method(method, n_samples=S, dynamic_masks=True, **kw)


def test_pack_dynamic_inputs_matches_jax(cat):
    bn, jv, tv = cat
    n = list(bn.nodes)
    rows = lambda *v: np.asarray(v, np.float32).reshape(-1, 1)  # noqa: E731
    qs = [
        dict(target=n[5], evidence={n[0]: rows(1), n[3]: rows(0)}, do={}),
        dict(target=n[6], evidence={n[7]: rows(np.nan, 1)},
             do={n[2]: rows(1, 0)}),
        dict(target=n[0], evidence={n[-1]: rows(1, 0, 1)}, do={}),
    ]
    _set(jv, "likelihood_weighting")
    _set(tv, "likelihood_weighting")
    jplan = jv._inference._canonical_plan(jv)
    tplan = tv._inference._canonical_plan(tv)
    jq = [jv._normalize_query(q) for q in qs]
    tq = [tv._normalize_query(q) for q in qs]
    for pad_to in (1, 6, 8):
        for clamp in (True, False):
            j_in, j_sp, j_b, j_bp = jdyn.pack_dynamic_inputs(
                jplan, jq, clamp_obs=clamp, pad_to=pad_to)
            t_in, t_sp, t_b, t_bp = tdyn.pack_dynamic_inputs(
                tplan, tq, clamp_obs=clamp, pad_to=pad_to)
            assert (t_sp, t_b, t_bp) == (j_sp, j_b, j_bp)
            for a, b in zip(t_in, j_in):
                np.testing.assert_array_equal(a, b)
    assert t_bp == 8 and [sp[:2] for sp in t_sp] == [(0, 1), (1, 3), (3, 6)]


@pytest.mark.parametrize("method", ["likelihood_weighting",
                                    "monte_carlo_marginalization"])
def test_dynamic_pmf_matches_jax(cat, method):
    """Both methods' dynamic pmf rows against the JAX package's (LW also
    against the exact posterior)."""
    bn, jv, tv = cat
    pairs = _cat_queries(bn)
    qs = [_q(t, ev) for t, ev in pairs]
    _set(jv, method)
    _set(tv, method)
    t_rows, t_spans = tv.infer_posterior_pmf(qs, n_classes=4, pad_bucket=8)
    j_rows, j_spans = jv.infer_posterior_pmf(qs, n_classes=4, pad_bucket=8)
    assert tv._last_summary_path == "fused" and t_spans == j_spans
    np.testing.assert_allclose(_norm(t_rows), _norm(np.asarray(j_rows)),
                               atol=0.04)
    if method == "likelihood_weighting":
        # the reduced path's rows are normalized; ESS is not computed there
        np.testing.assert_allclose(t_rows.sum(axis=1), 1.0, atol=1e-6)
        assert tv._inference._last_ess is None
        fit = _fitted_discrete(bn, tv)
        for (lo, _hi, _t), (t, ev) in zip(t_spans, pairs):
            gt = exact_posterior(fit, t, ev)
            np.testing.assert_allclose(t_rows[lo, : len(gt)], gt, atol=0.04)


def test_dynamic_lg_moments_match_closed_form_and_jax(gauss):
    gbn, jv, tv = gauss
    pairs = [("x8", {"x0": 0.3}), ("x2", {"x7": -0.5}),
             ("x5", {"x1": 0.2, "x6": 1.0}), ("x4", {})]
    qs = [_q(t, ev) for t, ev in pairs]
    fit = _fitted_gaussian(tv)
    for method in ("likelihood_weighting", "monte_carlo_marginalization"):
        _set(jv, method)
        _set(tv, method)
        t_mom, t_spans = tv.infer_posterior_moments(qs, pad_bucket=4)
        j_mom, _ = jv.infer_posterior_moments(qs, pad_bucket=4)
        np.testing.assert_allclose(t_mom, np.asarray(j_mom), atol=0.05)
        if method == "likelihood_weighting":
            for (lo, _hi, _t), (t, ev) in zip(t_spans, pairs):
                mean, std = fit.conditional(t, ev)
                assert abs(t_mom[lo, 0] - mean) < 0.05 * std + 0.01
                assert abs(t_mom[lo, 1] - std) < 0.05 * std + 0.01


def test_dynamic_mcm_do_target_delta(cat):
    bn, _jv, tv = cat
    _set(tv, "monte_carlo_marginalization")
    target = list(bn.nodes)[6]
    pdf, samples = tv.infer_posterior(_q(target, do={target: 1}))
    assert torch.all(pdf == 1.0) and torch.all(samples == 1.0)


def test_dynamic_mcm_direct_path_distribution(cat):
    """A target whose parents are all evidence: MCM's draws follow the
    target's CPT row (the JAX direct path, here as the general sweep)."""
    bn, _jv, tv = cat
    target = max(bn.nodes, key=lambda n: len(bn.parents[n]))
    ev = {p: 1 for p in bn.parents[target]}
    _set(tv, "monte_carlo_marginalization")
    _pdf, samples = tv.infer_posterior(_q(target, ev))
    hist = np.bincount(samples[0, :, 0].long().numpy(),
                       minlength=bn.card(target)) / S
    gt = exact_posterior(_fitted_discrete(bn, tv), target, ev)
    np.testing.assert_allclose(hist, gt, atol=0.03)


def test_infer_posterior_many_splits_rows(cat, monkeypatch):
    """One fused sweep for a mixed list; rows come back per query."""
    bn, _jv, tv = cat
    n = list(bn.nodes)
    calls = []
    plain = tscan.categorical_sweep_scan_plain
    monkeypatch.setattr(tscan, "categorical_sweep_scan_plain",
                        lambda *a, **k: calls.append(a[1].shape) or plain(*a, **k))
    two = np.asarray([[0.0], [1.0]], np.float32)
    qs = [_q(n[-1], {n[0]: 1}),
          {"target": n[3], "evidence": {}, "do": {n[3]: two}},
          _q(n[6])]
    _set(tv, "monte_carlo_marginalization")
    res = tv.infer_posterior_many(qs, pad_bucket=8)
    assert calls == [(8, len(n))]
    assert [r[0].shape for r in res] == [(1, S), (2, S), (1, S)]
    assert [r[1].shape for r in res] == [(1, S, 1), (2, S, 1), (1, S, 1)]
    np.testing.assert_array_equal(res[1][1][:, :, 0].numpy(),
                                  np.repeat(two, S, axis=1))
    assert torch.all(res[1][0] == 1.0)
    _set(tv, "likelihood_weighting")
    res = tv.infer_posterior_many(qs[:1] + qs[2:])
    assert tv._inference._last_ess.shape == (2,)


def test_static_large_plan_takes_the_scan_route(monkeypatch):
    """A static 100-node plan is past the unrolled kernel's 80 nodes: it
    rides the scan kernel (its plain version here), not the stream path."""
    bn = random_bn_treewidth(100, seed=1)
    tv = TVBN({n: bn.parents[n] for n in bn.nodes}, seed=0, device="cpu")
    conf = {}
    for node in bn.nodes:
        c = dict(tdefaults.cpd("categorical_table"), n_classes=bn.card(node))
        if bn.parents[node]:
            c["parent_n_classes"] = [bn.card(p) for p in bn.parents[node]]
        conf[node] = c
    tv.set_learning_method("node_wise", nodes_cpds=conf)
    tv.fit(generate_dataset(bn, 4096, seed=0))
    tv.set_inference_method("likelihood_weighting", n_samples=S)
    calls = {"scan": 0, "unrolled": 0}
    scan, unrolled = tscan.categorical_sweep_scan_plain, tsweep.categorical_sweep_plain

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tscan, "categorical_sweep_scan_plain", count("scan", scan))
    monkeypatch.setattr(tsweep, "categorical_sweep_plain", count("unrolled", unrolled))
    nodes = list(bn.nodes)
    q = _q(nodes[-1], {nodes[0]: 1, nodes[50]: 0})
    w, samples = tv.infer_posterior(q)
    pmf, _ = tv.infer_posterior_pmf([q], n_classes=4)
    assert tv._last_summary_path == "fused"
    assert calls == {"scan": 2, "unrolled": 0}
    gt = exact_posterior(_fitted_discrete(bn, tv), nodes[-1],
                         {nodes[0]: 1, nodes[50]: 0})
    p = np.bincount(samples[0, :, 0].long().numpy(),
                    weights=w[0].double().numpy(), minlength=len(gt))
    np.testing.assert_allclose(p / p.sum(), gt, atol=0.04)
    np.testing.assert_allclose(_norm(pmf)[0, : len(gt)], gt, atol=0.04)


def test_mixed_families_take_the_torch_sweep(monkeypatch):
    """A categorical parent of a linear-Gaussian child: both scan gates
    refuse the plan, and the torch-op dynamic sweep serves it."""
    rng = np.random.default_rng(0)
    c = rng.integers(0, 2, size=4096).astype(np.float32)
    x = 1.5 * c - 0.5 + 0.2 * rng.normal(size=4096)
    tv = TVBN([("c", "x")], seed=0, device="cpu")
    tv.set_learning_method("node_wise", nodes_cpds={
        "c": dict(tdefaults.cpd("categorical_table"), n_classes=2),
        "x": tdefaults.cpd("linear_gaussian")})
    tv.fit({"c": c, "x": x})
    calls = []
    trace = tdsw.dynamic_sweep_trace
    import vectorizedbayesiannetwork_torch.inference.likelihood_weighting as lw

    monkeypatch.setattr(lw, "dynamic_sweep_trace",
                        lambda *a, **k: calls.append(1) or trace(*a, **k))
    _set(tv, "likelihood_weighting")
    mom, _ = tv.infer_posterior_moments([_q("x", {"c": 1}), _q("c", {"x": 1.0})])
    assert calls == [1]
    w = tv.params["x"]["weight"][0, 0].item()
    b = tv.params["x"]["bias"][0].item()
    assert abs(mom[0, 0] - (w + b)) < 0.01
    assert mom[1, 0] > 0.99  # x = 1.0 sits on the c = 1 mode


def test_dynamic_target_values_match_jax():
    """The per-row target gather, reading the node-major planes of a packed
    [B, S, total] (its view ``permute(2, 0, 1)``), gives the JAX one-hot
    contraction's values."""
    import types

    plan = types.SimpleNamespace(node_offsets=(0, 1, 3), node_dims=(1, 2, 1),
                                 total_dim=4)
    packed = np.random.default_rng(0).normal(size=(3, 5, 4)).astype(np.float32)
    ti = np.asarray([2, 1, 0], np.int32)
    got = tdsw.dynamic_target_values(
        plan, torch.as_tensor(packed).permute(2, 0, 1), torch.as_tensor(ti))
    want = jdsw.dynamic_target_values(plan, jnp.asarray(packed), jnp.asarray(ti))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stream_fallback_pops_pad_bucket(cat):
    """Off the kernels (n_samples off the 1024 grid) a long list goes query
    by query, and pad_bucket does not reach infer_posterior."""
    bn, _jv, tv = cat
    tv.set_inference_method("likelihood_weighting", n_samples=1000)
    qs = [_q(list(bn.nodes)[-1], {list(bn.nodes)[0]: 1})] * 17
    rows, spans = tv.infer_posterior_pmf(qs, n_classes=4, pad_bucket=32)
    assert tv._last_summary_path == "stream"
    assert rows.shape == (17, 4) and len(spans) == 17


def _kde_net(families):
    """a -> b -> c and a -> c on 1024 rows, each node of the family that
    ``families`` names ("kde" at 128 points, or "linear_gaussian")."""
    rng = np.random.default_rng(4)
    a = rng.normal(size=1024)
    b = 0.6 * a + 0.5 * rng.normal(size=1024)
    c = b - 0.3 * a + 0.4 * rng.normal(size=1024)
    conf = {"kde": dict(tdefaults.cpd("kde"), max_points=128),
            "linear_gaussian": tdefaults.cpd("linear_gaussian")}
    tv = TVBN([("a", "b"), ("a", "c"), ("b", "c")], seed=0, device="cpu")
    tv.set_learning_method("node_wise", nodes_cpds={
        k: conf[f] for k, f in zip("abc", families)})
    tv.fit({"a": a.astype(np.float32), "b": b.astype(np.float32),
            "c": c.astype(np.float32)})
    return tv


@pytest.mark.parametrize("families,flagged", [
    (("kde", "kde", "kde"), {"root": 1, "cond": 2, "pick": 2}),
    (("linear_gaussian", "kde", "linear_gaussian"),
     {"root": 0, "cond": 1, "pick": 1}),
], ids=["kde", "mixed"])
def test_read_flags_leave_the_dynamic_sweep_bit_for_bit(families, flagged,
                                                        monkeypatch):
    """The per-node dynamic sweep passes its KDE nodes read flags (the
    log-density's evidence or target rows, the pick's free rows): its
    weights, target log-densities and target values equal, bit for bit,
    the same sweep with the flags off (``takes_read_flag`` patched to
    False), with evidence, do and a target mask, at 200 particles a row
    (the kernels' blocks then straddle rows). Each sweep passes a flag to
    one plain version a root density, a conditional density and a
    conditional pick (the root pick takes none); no launch here, so the
    ``LAUNCHES`` flagged counts stay 0."""
    tv = _kde_net(families)
    plan = t_get_plan(tv, TQuery(target="c", evidence={}, do={}))
    cpds = tuple(tv.cpd_spec(n) for n in plan.topo_order)
    params = tuple(tv.params[n] for n in plan.topo_order)
    idx = {n: i for i, n in enumerate(plan.topo_order)}
    b, s = 6, 200
    fixed = torch.tensor(np.random.default_rng(5).normal(
        size=(b, plan.total_dim)).astype(np.float32))
    ev, do = torch.zeros((b, 3)), torch.zeros((b, 3))
    for row, nodes in enumerate(["c", "b", "", "ac", "", "b"]):
        for n in nodes:
            ev[row, idx[n]] = 1.0
    do[1, idx["a"]] = do[4, idx["b"]] = 1.0
    ti = torch.tensor([idx[n] for n in "acbbca"], dtype=torch.int32)
    tgt = torch.nn.functional.one_hot(ti.long(), 3).to(torch.float32)
    calls = {"root": 0, "cond": 0, "pick": 0}
    for kind in calls:
        name = f"kde_{kind}_plain"

        def spy(*a, _fn=getattr(tkf, name), _kind=kind, **k):
            got = inspect.signature(_fn).bind(*a, **k).arguments.get("read")
            calls[_kind] += got is not None
            return _fn(*a, **k)

        monkeypatch.setattr(tkf, name, spy)
    flagged_keys = ("kde_root.flagged", "kde_cond.flagged", "kde_pick.flagged")
    before = {k: LAUNCHES[k] for k in flagged_keys}
    outs = {}
    for on in (True, False):
        monkeypatch.setattr(TKDE, "takes_read_flag", on)
        outs[on] = [tdsw.dynamic_sweep_trace(
            plan, cpds, params, Draw(3, torch.device("cpu")), fixed, ev, do,
            s, tgt_mask=t, targets=ti) for t in (tgt, None)]
        if on:
            assert calls == {k: 2 * v for k, v in flagged.items()}
    assert calls == {k: 2 * v for k, v in flagged.items()}  # none flags off
    for got, want in zip(outs[True], outs[False]):
        assert len(got) == len(want)
        for a, w in zip(got, want):
            assert torch.equal(a, w)
    assert bool(torch.isfinite(outs[True][0][1]).all())
    assert {k: LAUNCHES[k] for k in flagged_keys} == before
