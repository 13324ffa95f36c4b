"""The level-grouped per-node sweep (``VBN_LEVEL_GROUP``) against the JAX
package's, on the CPU.

Mirrors ``tests/test_level_grouping.py`` on the port: the same star (z ->
y0..y3 -> t), fitted by the JAX package and loaded by the port, so both
sides hold the same parameters. Checked here:

- the port's ``plan.levels`` and groups (``_sweep.level_groups``) equal
  the JAX package's (``build_plan(...).levels``, ``_group_sig``) on asia,
  gauss8, the star, the JAX test's mixed level and a KDE level;
- the stacked evidence log-density (``_stack_eval_params`` and one
  ``torch.func.vmap``-ed ``_log_prob_flat``) equals JAX's
  ``jax.vmap(cpd0._log_prob_flat)`` within 1e-5 of its scale, for each
  family the JAX package stacks;
- grouped equals ``VBN_LEVEL_GROUP=never`` at the JAX test's tolerances
  (samples rtol 1e-4, atol 1e-4; pdf rtol 1e-4, atol 1e-5): MCM and LW
  with latent siblings and LW with evidence siblings, for ``gaussian_nn``
  and ``linear_gaussian``; categorical families draw the same classes.
  A grouped node draws its ungrouped values bit for bit (one
  ``vbn_uniforms`` launch a draw for the group), so only the batched
  products round apart;
- the grouped posterior agrees with the JAX package's grouped one within
  Monte-Carlo error, and both with the star's closed form;
- row 0 of a grouped batch of two equals a grouped batch of one;
- each family's declared draws (``_draws``) are what its ``_sample_flat``
  asks a row stream for;
- a group that cannot stack or vmap (a bf16 network, KDE, leaves of other
  shapes) runs node by node, and ``_sweep.GROUPS`` shows it.
"""

import os

import jax
import jax.numpy as jnp
import networkx as nx
import numpy as np
import pandas as pd
import pytest
import torch

from vectorizedbayesiannetwork_torch import VBN as TVBN
from vectorizedbayesiannetwork_torch.core.base import Query as TQuery
from vectorizedbayesiannetwork_torch.core.plan import build_plan as tbuild
from vectorizedbayesiannetwork_torch.core.rng import Draw, NodeStream, RowStream
from vectorizedbayesiannetwork_torch.inference import _sweep
from vectorizedbayesiannetwork_tpu import VBN as JVBN
from vectorizedbayesiannetwork_tpu import defaults as jdefaults
from vectorizedbayesiannetwork_tpu.core.base import Query as JQuery
from vectorizedbayesiannetwork_tpu.core.plan import build_plan as jbuild
from vectorizedbayesiannetwork_tpu.inference import _sweep as jsweep

B, S = 3, 64
N_SIB = 4
FAST = {"epochs": 3, "batch_size": 256}
SIBS = [f"y{i}" for i in range(N_SIB)]

# family -> (sibling overrides, discrete data): the seven families the
# JAX package stacks, at the JAX test's sizes
FAMILIES = {
    "linear_gaussian": ({}, False),
    "gaussian_nn": ({"hidden_dims": [16], "fit": FAST}, False),
    "mdn": ({"hidden_dims": [16], "n_components": 3, "fit": FAST}, False),
    "rff_gaussian": ({"n_features": 32}, False),
    "softmax_nn": ({"hidden_dims": [16], "n_classes": 5,
                    "within_bin": "gaussian", "fit": FAST}, False),
    "categorical_table": ({"n_classes": 3, "parent_n_classes": [3]}, True),
    "categorical_embedded_softmax": ({"hidden_dims": [16], "n_classes": 3,
                                      "parent_n_classes": [3],
                                      "embedding_dim": 4, "fit": FAST}, True),
}


def _star_edges(n=N_SIB):
    return ([("z", f"y{i}") for i in range(n)]
            + [(f"y{i}", "t") for i in range(n)])


def _star_data(n=800, seed=0, discrete=False, n_sib=N_SIB):
    """The JAX test's rows (``_make_df``); discrete: each column cut into
    the classes 0, 1, 2 at its terciles."""
    g = np.random.default_rng(seed)
    z = g.normal(size=n)
    cols = {"z": z}
    for i in range(n_sib):
        cols[f"y{i}"] = (0.4 + 0.2 * i) * z + 0.1 * g.normal(size=n)
    cols["t"] = sum(cols[f"y{i}"] for i in range(n_sib)) + 0.1 * g.normal(
        size=n)
    if discrete:
        cols = {k: np.digitize(v, np.quantile(v, [1 / 3, 2 / 3])).astype(
            np.float32) for k, v in cols.items()}
    return pd.DataFrame(cols)


def _fit_both(path, edges, confs, df):
    """(JAX model, the port's load of its checkpoint)."""
    jv = JVBN(nx.DiGraph(edges), seed=0)
    jv.set_learning_method("node_wise", nodes_cpds=confs)
    jv.fit(df)
    jv.save(str(path))
    return jv, TVBN.load(str(path), device="cpu")


def _sib_conf(family):
    kw, discrete = FAMILIES[family]
    conf = dict(jdefaults.cpd(family))
    for k, v in kw.items():
        conf[k] = dict(conf[k], **v) if k == "fit" else v
    return conf, discrete


def _star_confs(family):
    conf, discrete = _sib_conf(family)
    if discrete:
        table = dict(jdefaults.cpd("categorical_table"), n_classes=3)
        ends = {"z": table, "t": dict(table, parent_n_classes=[3] * N_SIB)}
    else:
        ends = {"z": jdefaults.cpd("linear_gaussian"),
                "t": jdefaults.cpd("linear_gaussian")}
    return {**ends, **{y: conf for y in SIBS}}, discrete


@pytest.fixture(scope="module")
def stars(tmp_path_factory):
    """family -> (JAX star, port star), fitted once by the JAX package."""
    root = tmp_path_factory.mktemp("level_group")
    out = {}
    for family in FAMILIES:
        confs, discrete = _star_confs(family)
        out[family] = _fit_both(root / f"{family}.npz", _star_edges(), confs,
                                _star_data(discrete=discrete))
    return out


@pytest.fixture(scope="module")
def plans(tmp_path_factory, stars):
    """name -> (JAX model, port model, query): asia, gauss8, the star, the
    JAX test's mixed level, a KDE level."""
    from benchmarking.data_gen import generate_dataset
    from benchmarking.gaussian_bn import random_gaussian
    from benchmarking.networks import asia

    root = tmp_path_factory.mktemp("level_plans")
    out = {}
    bn = asia()
    confs = {}
    for node in bn.nodes:
        c = dict(jdefaults.cpd("categorical_table"), n_classes=bn.card(node))
        if bn.parents[node]:
            c["parent_n_classes"] = [bn.card(p) for p in bn.parents[node]]
        confs[node] = c
    edges = [(p, n) for n in bn.nodes for p in bn.parents[n]]
    out["asia"] = _fit_both(root / "asia.npz", edges, confs,
                            pd.DataFrame(generate_dataset(bn, 1000, seed=0))) + (
        {"target": "dysp", "evidence": {"smoke": [[1.0]], "asia": [[0.0]]}},)
    gbn = random_gaussian(8, seed=0)
    edges = [(p, n) for n in gbn.nodes for p in gbn.parents[n]]
    confs = {n: jdefaults.cpd("linear_gaussian") for n in gbn.nodes}
    data = pd.DataFrame({k: np.asarray(v).ravel()
                         for k, v in gbn.sample(1000, seed=1).items()})
    leaves = [n for n in gbn.nodes if not any(n in gbn.parents[c]
                                              for c in gbn.nodes)]
    out["gauss8"] = _fit_both(root / "gauss8.npz", edges, confs, data) + (
        {"target": gbn.nodes[0], "evidence": {n: [[0.5]] for n in leaves}},)
    jv, tv = stars["gaussian_nn"]
    out["star"] = (jv, tv, {"target": "t", "evidence": {
        y: [[0.1 * i]] for i, y in enumerate(SIBS[:2])}})
    nn, _ = _sib_conf("gaussian_nn")
    confs = {"z": jdefaults.cpd("linear_gaussian"), "y0": nn, "y1": nn,
             "y2": jdefaults.cpd("linear_gaussian"),
             "t": jdefaults.cpd("linear_gaussian")}
    df = _star_data(n_sib=3)
    out["mixed"] = _fit_both(root / "mixed.npz", _star_edges(3), confs, df) + (
        {"target": "t", "evidence": {"z": [[0.1]]}},)
    kde = dict(jdefaults.cpd("kde"), bandwidth=0.3, max_points=64)
    confs = {"z": jdefaults.cpd("linear_gaussian"),
             **{y: kde for y in SIBS[:3]}, "t": jdefaults.cpd("linear_gaussian")}
    out["kde"] = _fit_both(root / "kde.npz", _star_edges(3), confs,
                           _star_data(n_sib=3)) + (
        {"target": "t", "evidence": {"z": [[0.2]]}},)
    return out


def _plans_of(jv, tv, q):
    ev = {k: np.asarray(v, np.float32) for k, v in q["evidence"].items()}
    jp = jbuild(jv, JQuery(target=q["target"], evidence=ev))
    tp = tbuild(tv, TQuery(target=q["target"], evidence=ev))
    return jp, tp


def _jax_groups(jv, plan, weighted=True):
    """The JAX sweep's groups, level by level (its loop in
    ``inference/_sweep.py::sweep_trace``)."""
    cpds = [jv.cpd_spec(n) for n in plan.topo_order]
    out = []
    for level in plan.levels:
        latent, evidence = {}, {}
        for idx in level:
            if plan.is_fixed(idx):
                if weighted and plan.evidence_mask[idx]:
                    evidence.setdefault(jsweep._group_sig(cpds[idx]),
                                        []).append(idx)
            else:
                latent.setdefault(jsweep._group_sig(cpds[idx]), []).append(idx)
        out.append((tuple(level), list(latent.values()),
                    list(evidence.values())))
    return out


def _port_groups(tv, plan, weighted=True):
    cpds = [tv.cpd_spec(n) for n in plan.topo_order]
    return [(tuple(level), lat, ev) for level, lat, ev
            in _sweep.level_groups(plan, cpds, weighted)]


PLAN_NAMES = ["asia", "gauss8", "star", "mixed", "kde"]


@pytest.mark.parametrize("name", ["asia", "gauss8", "star"])
def test_plan_levels_match_jax(plans, name):
    jv, tv, q = plans[name]
    jp, tp = _plans_of(jv, tv, q)
    assert tp.topo_order == jp.topo_order
    assert tp.levels == jp.levels
    assert sorted(i for lv in tp.levels for i in lv) == list(range(tp.n_nodes))


@pytest.mark.parametrize("name", PLAN_NAMES)
def test_groups_match_jax(plans, name):
    jv, tv, q = plans[name]
    jp, tp = _plans_of(jv, tv, q)
    assert _port_groups(tv, tp) == _jax_groups(jv, jp)
    groups = _port_groups(tv, tp)
    if name == "mixed":  # y0, y1 (gaussian_nn) stack; y2 (LG) alone
        assert groups[1][1] == [[1, 2], [3]]
    if name == "kde":  # one signature, but KDE samples node by node
        assert groups[1][1] == [[1, 2, 3]]


def test_kde_level_opts_out(plans):
    jv, tv, q = plans["kde"]
    out = {}
    for mode in ("auto", "never"):
        os.environ["VBN_LEVEL_GROUP"] = mode
        try:
            tv.set_inference_method("likelihood_weighting", n_samples=S)
            tv._keys.set_state(3)
            _sweep.GROUPS.clear()
            out[mode] = tv.infer_posterior(q)
            groups = dict(_sweep.GROUPS)
        finally:
            os.environ.pop("VBN_LEVEL_GROUP", None)
        if mode == "auto":
            assert groups == {"per_node": 3}
    for a, b in zip(out["auto"], out["never"]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The stacked evidence log-density against JAX's vmapped one
# ---------------------------------------------------------------------------


def _sibling_inputs(discrete, m=256, seed=5):
    g = np.random.default_rng(seed)
    if discrete:
        x = g.integers(0, 3, size=(N_SIB, m, 1)).astype(np.float32)
        p = g.integers(0, 3, size=(N_SIB, m, 1)).astype(np.float32)
    else:
        p = g.normal(size=(N_SIB, m, 1)).astype(np.float32)
        x = (0.6 * p + 0.3 * g.normal(size=(N_SIB, m, 1))).astype(np.float32)
    return x, p


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_stacked_evidence_log_prob_matches_jax(stars, family):
    jv, tv = stars[family]
    x, p = _sibling_inputs(FAMILIES[family][1])
    jc = [jv.cpd_spec(y) for y in SIBS]
    jparams = [jv.params[y] for y in SIBS]
    jstack = jsweep._stack_eval_params(jc, jparams, list(range(N_SIB)))
    assert jstack is not None
    want = np.asarray(jax.vmap(jc[0]._log_prob_flat)(
        jstack, jnp.asarray(x), jnp.asarray(p)))
    tc = [tv.cpd_spec(y) for y in SIBS]
    tparams = [tv.params[y] for y in SIBS]
    tstack = _sweep._stack_eval_params(tc, tparams, list(range(N_SIB)))
    assert tstack is not None
    with torch.no_grad():
        got = torch.func.vmap(tc[0]._log_prob_flat)(
            tstack, torch.as_tensor(x), torch.as_tensor(p))
    assert got.shape == (N_SIB, x.shape[1])
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * scale)


def test_stack_eval_params_refuses_other_shapes_and_drops_opt(stars):
    _, tv = stars["gaussian_nn"]
    tc = [tv.cpd_spec(y) for y in SIBS[:2]]
    tparams = [tv.params[y] for y in SIBS[:2]]
    assert "opt" in tparams[0]
    stacked = _sweep._stack_eval_params(tc, tparams, [0, 1])
    assert "opt" not in stacked
    assert stacked["net"]["layers"][0]["w"].shape[0] == 2
    wide = dict(tparams[1], net={"layers": [
        dict(tparams[1]["net"]["layers"][0],
             w=torch.zeros((1, 17)), b=torch.zeros(17)),
        tparams[1]["net"]["layers"][1]]})
    assert _sweep._stack_eval_params(tc, [tparams[0], wide], [0, 1]) is None
    assert _sweep._stack_eval_params(
        tc, [tparams[0], {k: v for k, v in tparams[1].items()
                          if k != "stats"}], [0, 1]) is None


# ---------------------------------------------------------------------------
# Grouped == ungrouped; grouped == the JAX package's grouped posterior
# ---------------------------------------------------------------------------


def _infer(vbn, mode, query, method, n_samples=S, counter=11):
    os.environ["VBN_LEVEL_GROUP"] = mode
    try:
        vbn.set_inference_method(method, n_samples=n_samples)
        vbn._keys.set_state(counter)
        _sweep.GROUPS.clear()
        w, s = vbn.infer_posterior(query)
        return w.numpy(), s.numpy(), dict(_sweep.GROUPS)
    finally:
        os.environ.pop("VBN_LEVEL_GROUP", None)


LATENT_Q = {"target": "t", "evidence": {"z": [[0.3]] * B}}
EVIDENCE_Q = {"target": "t", "evidence": {y: [[0.2 * i]] * B
                                          for i, y in enumerate(SIBS)}}
CASES = [(family, method, q) for family in ("gaussian_nn", "linear_gaussian")
         for method, q in (("monte_carlo_marginalization", "latent"),
                           ("likelihood_weighting", "latent"),
                           ("likelihood_weighting", "evidence"))]


@pytest.mark.parametrize("family,method,q", CASES)
def test_grouped_matches_never(stars, family, method, q):
    _, tv = stars[family]
    query = LATENT_Q if q == "latent" else EVIDENCE_Q
    pdf_g, s_g, groups = _infer(tv, "auto", query, method)
    pdf_u, s_u, never = _infer(tv, "never", query, method)
    kind = "sample" if q == "latent" else "log_prob"
    assert groups == {f"{kind}_calls": 1, f"{kind}_nodes": N_SIB}
    assert never == {}
    np.testing.assert_allclose(s_g, s_u, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pdf_g, pdf_u, rtol=1e-4, atol=1e-5)


DISCRETE_LATENT_Q = {"target": "t", "evidence": {"z": [[1.0]] * B}}
DISCRETE_EVIDENCE_Q = {"target": "t", "evidence": {
    y: [[float(i % 3)]] * B for i, y in enumerate(SIBS)}}


@pytest.mark.parametrize("family", ["categorical_table",
                                    "categorical_embedded_softmax",
                                    "softmax_nn"])
def test_grouped_categorical_draws_equal_classes(stars, family):
    _, tv = stars[family]
    discrete = FAMILIES[family][1]
    for query in ((DISCRETE_LATENT_Q, DISCRETE_EVIDENCE_Q) if discrete
                  else (LATENT_Q, EVIDENCE_Q)):
        pdf_g, s_g, groups = _infer(tv, "auto", query, "likelihood_weighting")
        pdf_u, s_u, _ = _infer(tv, "never", query, "likelihood_weighting")
        assert groups.get("sample_calls", 0) + groups.get("log_prob_calls",
                                                          0) >= 1
        if discrete:
            np.testing.assert_array_equal(s_g, s_u)
        else:
            np.testing.assert_allclose(s_g, s_u, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(pdf_g, pdf_u, rtol=1e-4, atol=1e-5)


def _moments(w, s):
    w = np.asarray(w, np.float64)
    x = np.asarray(s, np.float64)[..., 0]
    wn = w / w.sum(axis=1, keepdims=True)
    mean = (wn * x).sum(axis=1)
    sd = np.sqrt((wn * (x - mean[:, None]) ** 2).sum(axis=1))
    return mean, sd, 1.0 / (wn ** 2).sum(axis=1)


def test_grouped_posterior_matches_jax_and_closed_form(stars):
    """t | z on the linear-Gaussian star: the port's grouped LW and the JAX
    package's grouped LW within 5 standard errors of each other and of
    ``gaussian_exact``'s mean. S = 4000 each: off the 1024 grid, where no
    fused LG kernel takes the plan and the torch-op sweep serves it."""
    jv, tv = stars["linear_gaussian"]
    q = {"target": "t", "evidence": {"z": [[-0.5], [0.3], [1.1]]}}
    w, s, groups = _infer(tv, "auto", q, "likelihood_weighting",
                          n_samples=4000)
    assert groups == {"sample_calls": 1, "sample_nodes": N_SIB}
    m_t, sd_t, ess_t = _moments(w, s)
    os.environ["VBN_LEVEL_GROUP"] = "auto"
    try:
        jv.set_inference_method("likelihood_weighting", n_samples=4000)
        jw, js = jv.infer_posterior(q)
    finally:
        os.environ.pop("VBN_LEVEL_GROUP", None)
    m_j, sd_j, ess_j = _moments(jw, js)
    tv.set_inference_method("gaussian_exact")
    exact = tv.infer_posterior_moments([q])[0][:, 0]
    se_t, se_j = sd_t / np.sqrt(ess_t), sd_j / np.sqrt(ess_j)
    assert (np.abs(m_t - m_j) <= 5 * np.sqrt(se_t ** 2 + se_j ** 2)).all()
    assert (np.abs(m_t - exact) <= 5 * se_t + 1e-6).all(), (m_t, exact)
    assert (np.abs(m_j - exact) <= 5 * se_j + 1e-6).all(), (m_j, exact)


@pytest.mark.parametrize("family", ["gaussian_nn", "mdn"])
def test_grouped_row0_equals_a_batch_of_one(stars, family):
    _, tv = stars[family]
    outs = []
    for b in (2, 1):
        q = {"target": "t", "evidence": {"z": [[0.3], [-0.7]][:b]}}
        w, s, groups = _infer(tv, "auto", q, "likelihood_weighting",
                              counter=500)
        assert groups["sample_calls"] == 1
        outs.append((w, s))
    (wb, sb), (ws, ss) = outs
    assert np.abs(wb[0] - ws[0]).max() <= 1e-6
    np.testing.assert_array_equal(sb[0], ss[0])


# ---------------------------------------------------------------------------
# Declared draws; groups that run node by node
# ---------------------------------------------------------------------------


class RecordingStream(NodeStream):
    """A node's row stream that records the draws asked of it."""

    def __init__(self, stream, idx):
        super().__init__(stream, idx)
        self.asked = []

    def uniform(self, k=1, at=0):
        self.asked.append((k, at, False))
        return super().uniform(k, at)

    def normal(self, k=1, at=0):
        self.asked.append((k, at, True))
        return super().normal(k, at)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_declared_draws_are_what_sample_flat_asks(stars, family):
    _, tv = stars[family]
    m = 2 * 32
    stream = RowStream(Draw(77, torch.device("cpu")), 2, 32)
    x, p = _sibling_inputs(FAMILIES[family][1], m=m)
    cpd = tv.cpd_spec("y1")
    rec = RecordingStream(stream, 3)
    with torch.no_grad():
        cpd._sample_flat(tv.params["y1"], rec, torch.as_tensor(p[0]), m)
    assert rec.asked == list(cpd._draws())
    drawn = {k: v[0] for k, v in stream.predraw([3], cpd._draws()).items()}
    with torch.no_grad():
        a = cpd._sample_flat(tv.params["y1"], drawn, torch.as_tensor(p[0]), m)
        b = cpd._sample_flat(tv.params["y1"], stream.node(3),
                             torch.as_tensor(p[0]), m)
    assert torch.equal(a, b)


def test_softmax_within_bin_uniform_draws(stars):
    _, tv = stars["softmax_nn"]
    cpd = tv.cpd_spec("y0")
    for mode in ("uniform", "triangular"):
        old, cpd.within_bin = cpd.within_bin, mode
        try:
            rec = RecordingStream(RowStream(Draw(5, torch.device("cpu")), 1, 16),
                                  2)
            with torch.no_grad():
                cpd._sample_flat(tv.params["y0"], rec, torch.zeros((16, 1)), 16)
            assert rec.asked == list(cpd._draws())
            assert cpd._draws()[1][2] is False
        finally:
            cpd.within_bin = old


def test_bf16_group_runs_per_node(stars, tmp_path):
    """A bf16 network's product has no vmap rule: its level runs node by
    node (``GROUPS["per_node"]``), drawing exactly the ungrouped values."""
    conf, _ = _sib_conf("gaussian_nn")
    conf = dict(conf, compute_dtype="bfloat16")
    confs = {"z": jdefaults.cpd("linear_gaussian"),
             **{y: conf for y in SIBS}, "t": jdefaults.cpd("linear_gaussian")}
    _, tv = _fit_both(tmp_path / "bf16.npz", _star_edges(), confs,
                      _star_data())
    for query, want in ((LATENT_Q, {"per_node": N_SIB}),
                        (EVIDENCE_Q, {"per_node": N_SIB})):
        pdf_g, s_g, groups = _infer(tv, "auto", query, "likelihood_weighting")
        pdf_u, s_u, _ = _infer(tv, "never", query, "likelihood_weighting")
        assert groups == want
        np.testing.assert_array_equal(s_g, s_u)
        np.testing.assert_array_equal(pdf_g, pdf_u)
