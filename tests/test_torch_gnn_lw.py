"""The neural Gaussian CPD (``gaussian_nn``) held to a plain float64
likelihood weighting of the same parameters, on the CPU.

The reference below is plain PyTorch in float64. A node with parents
holds an MLP in the published layout, ``{"layers": [{"w": [in, out], "b":
[out]}, ...]}``, ReLU between layers, and its standardization ``stats``:

    h = (pa - mean_x) / std_x
    (a, r) = MLP(h)                      # two output columns
    loc = a * std_y + mean_y
    scale = (softplus(r) + min_scale) * std_y

A root takes ``a = loc`` and ``r = log_scale``. ``softplus(r) = log(1 +
exp(r))``, and ``r`` itself where ``r > 20``: the form of
``ops/gauss.py::safe_softplus``. Plain LW draws each free node once from
one forward a node and adds ``log N(e; loc, scale)`` for each evidence
node.

With seeded random weights (``mlp_init`` and random ``stats``, no fit):

- the forward's (loc, scale) lies within 1e-5 of the reference's (float32
  against float64 of the same parameters), for 1, 2 and 3 parents, and
  bf16 products lie outside 1e-4;
- the per-node dynamic sweep on gauss8 (B=8, S=4096, evidence and do
  mixed by row): the reference's log-weights, recomputed from the sweep's
  own particles, lie within 1e-4 of the sweep's ``log_w``;
- a node's two forwards in one sweep (``_sample_flat``'s, then
  ``_log_prob_flat``'s on the same parents) give (loc, scale) bit for bit;
- the served LW moments lie within z-limits of 2.2 (root mean square) and
  8 (widest) of the reference at 4 x S, and means moved by 5 of their
  standard errors do not;
- under the profiler a served call opens 4 ``vbn.mlp.sample`` and 4
  ``vbn.mlp.log_prob`` spans and its root records ``mlp_rows`` 8 B S; a
  KDE call opens none and records 0; the rows are the same with the
  profiler on; ``MLP`` counts no root and zeroes with the other counters.

The benchmark cell ``gauss8-gnn-lw.mixed96`` runs here at small sizes
(``vbnbench/run.py`` on the CPU): it is correct and its control is not;
bf16 products in the program's place, means moved by 5 standard errors and
a fit of 5 epochs are not correct, each by the limits that should catch
it; the reference (``vbnbench/reference/gnn_lw.py``) leaves the TF32
switches as it found them; the work count is one forward a node; the MLP
metrics read the port's spans and counter, and None where there are none.
"""

import json
import math
import shutil
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vbnbench import check, registry, run
from vbnbench.networks.gaussian import random_gaussian
from vbnbench.reference import gnn_lw
from vbnbench.work import gaussian_nn as work_gnn
from vectorizedbayesiannetwork_torch import VBN, defaults
from vectorizedbayesiannetwork_torch.core.base import Query
from vectorizedbayesiannetwork_torch.core.plan import get_plan
from vectorizedbayesiannetwork_torch.core.rng import Draw
from vectorizedbayesiannetwork_torch.inference import _dynamic_sweep as dsw
from vectorizedbayesiannetwork_torch.models.gaussian_nn import GaussianNNCPD
from vectorizedbayesiannetwork_torch.utils import profiling

NET = random_gaussian(8, seed=0, max_in_degree=3)
MIN_SCALE = 1e-4
Z_RMS, Z_MAX, MIN_REFERENCE_ESS = 2.2, 8.0, 100.0
F64 = torch.float64
LOG_2PI = math.log(2.0 * math.pi)


@dataclass
class GnnNode:
    """One node's CPD in float64."""
    layers: Optional[List[Tuple[torch.Tensor, torch.Tensor]]]  # None: a root
    loc: Optional[torch.Tensor]  # a root's [1]
    log_scale: Optional[torch.Tensor]  # a root's [1]
    mean_x: torch.Tensor  # [dp]
    std_x: torch.Tensor  # [dp]
    mean_y: float
    std_y: float


def ref_node(params) -> GnnNode:
    def t(a):
        return torch.as_tensor(a, dtype=F64).detach()

    net, stats = params["net"], params["stats"]
    layers = loc = log_scale = None
    if "layers" in net:
        layers = [(t(lay["w"]), t(lay["b"])) for lay in net["layers"]]
    else:
        loc, log_scale = t(net["loc"]).reshape(-1), t(net["log_scale"]).reshape(-1)
    return GnnNode(layers=layers, loc=loc, log_scale=log_scale,
                   mean_x=t(stats["mean_x"]).reshape(-1),
                   std_x=t(stats["std_x"]).reshape(-1),
                   mean_y=float(stats["mean_y"].reshape(-1)[0]),
                   std_y=float(stats["std_y"].reshape(-1)[0]))


def softplus(r):
    return torch.where(r > 20.0, r, torch.log1p(torch.exp(torch.clamp(r, max=20.0))))


def loc_scale(node: GnnNode, pa, m: int):
    """(loc [m], scale [m]) in float64; ``pa`` [m, dp] (None for a root)."""
    if node.layers is None:
        a, r = node.loc.expand(m), node.log_scale.expand(m)
    else:
        h = (pa.to(F64) - node.mean_x) / node.std_x
        for i, (w, b) in enumerate(node.layers):
            h = h @ w + b
            if i < len(node.layers) - 1:
                h = torch.relu(h)
        a, r = h[:, 0], h[:, 1]
    return (a * node.std_y + node.mean_y,
            (softplus(r) + MIN_SCALE) * node.std_y)


def log_normal(x, loc, scale):
    z = (x - loc) / scale
    return -0.5 * (z * z + LOG_2PI) - torch.log(scale)


def lw_moments(nodes: Dict[str, GnnNode], rows, s: int, gen) -> np.ndarray:
    """[R, 5] rows: the target's weighted mean and std, the delta-method
    standard error of each, and the effective sample size."""
    out = np.zeros((len(rows), 5))
    for r, (target, ev) in enumerate(rows):
        x: Dict[str, torch.Tensor] = {}
        lw = torch.zeros(s, dtype=F64)
        for n in NET.nodes:
            pa = (torch.stack([x[p] for p in NET.parents[n]], 1)
                  if NET.parents[n] else None)
            loc, scale = loc_scale(nodes[n], pa, s)
            if n in ev:
                x[n] = torch.full((s,), float(ev[n]), dtype=F64)
                lw += log_normal(x[n], loc, scale)
            else:
                x[n] = loc + scale * torch.randn(s, generator=gen, dtype=F64)
        t = x[target]
        w = torch.exp(lw - lw.max())
        w = w / w.sum()
        mean = (w * t).sum()
        dev2 = (t - mean) ** 2
        var = (w * dev2).sum()
        std = torch.sqrt(var)
        out[r] = [float(mean), float(std),
                  float(torch.sqrt((w ** 2 * dev2).sum())),
                  float(torch.sqrt((w ** 2 * (dev2 - var) ** 2).sum()) / (2 * std)),
                  float(1.0 / (w ** 2).sum())]
    return out


def random_params(cpd, gen):
    """``cpd.init``'s weights (``mlp_init`` for a node with parents) and
    random standardization stats."""
    p = cpd.init("cpu", gen)
    dp = cpd.input_dim
    if dp == 0:
        p["net"] = {"loc": 0.5 * torch.randn(1, generator=gen),
                    "log_scale": 0.5 * torch.randn(1, generator=gen)}
    p["stats"] = {"mean_x": torch.randn(dp, generator=gen),
                  "std_x": torch.rand(dp, generator=gen) + 0.5,
                  "mean_y": torch.randn(1, generator=gen),
                  "std_y": torch.rand(1, generator=gen) + 0.5}
    return p


@pytest.fixture(scope="module")
def gnn():
    """gauss8 of ``gaussian_nn`` nodes, its weights then replaced by
    seeded random ones."""
    tv = VBN({n: list(NET.parents[n]) for n in NET.nodes}, seed=0,
             device="cpu")
    conf = dict(defaults.cpd("gaussian_nn"), min_scale=MIN_SCALE,
                fit={"epochs": 1, "batch_size": 128, "lr": 1e-3})
    tv.set_learning_method("node_wise",
                           nodes_cpds={n: dict(conf) for n in NET.nodes})
    rows = NET.sample(256, 0)
    tv.fit({k: v.astype(np.float32).reshape(-1, 1) for k, v in rows.items()})
    gen = torch.Generator().manual_seed(23)
    for n in NET.nodes:
        tv.params[n] = random_params(tv.cpd_spec(n), gen)
    return tv


@pytest.mark.parametrize("dp", [1, 2, 3])
def test_forward_matches_the_reference(dp):
    gen = torch.Generator().manual_seed(100 + dp)
    cpd = GaussianNNCPD(dp, 1, hidden_dims=(32, 32), min_scale=MIN_SCALE)
    params = random_params(cpd, gen)
    pa = 2.0 * torch.randn((4096, dp), generator=gen)
    loc, scale = cpd._denorm_params(params, pa, 4096)
    rl, rs = loc_scale(ref_node(params), pa, 4096)
    assert loc.dtype == torch.float32
    np.testing.assert_allclose(loc[:, 0].double(), rl, rtol=0, atol=1e-5)
    np.testing.assert_allclose(scale[:, 0].double(), rs, rtol=0, atol=1e-5)


# per row of B=8: evidence nodes, do nodes
MASKS = [("", ""), ("x3", ""), ("x7", ""), ("x0x5", ""), ("x6x7", "x1"),
         ("x3x5x7", ""), ("x1", "x3"), ("x4x7", "")]


def _sweep_inputs(tv, b):
    plan = get_plan(tv, Query(target="x7", evidence={}, do={}))
    cpds = tuple(tv.cpd_spec(n) for n in plan.topo_order)
    params = tuple(tv.params[n] for n in plan.topo_order)
    idx = {n: i for i, n in enumerate(plan.topo_order)}
    fixed = torch.tensor(np.random.default_rng(5).normal(
        size=(b, plan.total_dim)).astype(np.float32))
    ev = torch.zeros((b, plan.n_nodes))
    do = torch.zeros((b, plan.n_nodes))
    for row, (e, d) in enumerate(MASKS[:b]):
        for k in range(0, len(e), 2):
            ev[row, idx[e[k:k + 2]]] = 1.0
        for k in range(0, len(d), 2):
            do[row, idx[d[k:k + 2]]] = 1.0
    return plan, cpds, params, fixed, ev, do


def test_sweep_log_weights_match_the_reference(gnn):
    b, s = 8, 4096
    plan, cpds, params, fixed, ev, do = _sweep_inputs(gnn, b)
    packed, log_w = dsw.dynamic_sweep_trace(
        plan, cpds, params, Draw(11, torch.device("cpu")), fixed, ev, do, s)
    want = torch.zeros((b, s), dtype=torch.float64)
    for i, n in enumerate(plan.topo_order):
        node = ref_node(gnn.params[n])
        pidx = plan.parent_idx[i]
        for row in range(b):
            if ev[row, i] > 0 or do[row, i] > 0:
                assert torch.equal(packed[row, :, i],
                                   fixed[row, i].expand(s))
            if ev[row, i] == 0:
                continue
            pa = packed[row][:, list(pidx)] if pidx else None
            loc, scale = loc_scale(node, pa, s)
            want[row] += log_normal(packed[row, :, i].double(), loc, scale)
    assert log_w.dtype == torch.float32
    np.testing.assert_allclose(log_w.double(), want, rtol=0, atol=1e-4)
    assert bool((log_w[0] == 0).all())  # no evidence, no weight


def test_a_nodes_two_forwards_agree_bit_for_bit(gnn, monkeypatch):
    """``_per_node_trace`` runs each MLP node's forward twice on the same
    parents: its draw's (loc, scale) and its log-density's are the same
    tensors' values, bit for bit (a later change may keep one)."""
    b, s = 8, 512
    plan, cpds, params, fixed, ev, do = _sweep_inputs(gnn, b)
    seen = {}
    denorm = GaussianNNCPD._denorm_params

    def spy(self, p, parents, m):
        got = denorm(self, p, parents, m)
        if self.input_dim:
            seen.setdefault(id(self), []).append((parents, got))
        return got

    monkeypatch.setattr(GaussianNNCPD, "_denorm_params", spy)
    dsw.dynamic_sweep_trace(plan, cpds, params, Draw(11, torch.device("cpu")),
                            fixed, ev, do, s)
    assert len(seen) == 4
    for calls in seen.values():
        (pa1, (l1, s1)), (pa2, (l2, s2)) = calls
        assert pa1 is pa2 and pa1.shape == (b * s, pa1.shape[1])
        assert torch.equal(l1, l2) and torch.equal(s1, s2)


QUERIES = [("x7", {}), ("x0", {"x7": 0.3}), ("x5", {"x3": -0.4}),
           ("x3", {"x5": 0.2, "x6": 0.1}), ("x2", {"x3": 0.5, "x7": -0.2}),
           ("x6", {"x4": 0.7}), ("x1", {"x5": -0.3, "x0": 0.2, "x7": 0.1}),
           ("x4", {"x6": -0.5})]


def _served(tv, queries, s):
    tv.set_inference_method("likelihood_weighting", n_samples=s,
                            dynamic_masks=True)
    qs = [{"target": t, "evidence": {n: [[v]] for n, v in ev.items()}}
          for t, ev in queries]
    rows, _spans = tv.infer_posterior_moments(qs, dynamic_masks=True,
                                              pad_bucket=len(qs))
    return rows


def _judged(rows, ref, s, shift=None):
    """``check.judge_moments`` of the served rows, each mean moved by
    ``shift`` (one number a row) first."""
    rows = np.array(rows, np.float64, copy=True)
    if shift is not None:
        rows[:, 0] += shift
    return check.judge_moments(
        ref, 4 * s, [(r, t, ev) for r, (t, ev) in zip(rows, QUERIES)], s,
        MIN_REFERENCE_ESS)


def _reference(tv, s):
    nodes = {n: ref_node(tv.params[n]) for n in NET.nodes}
    return lw_moments(nodes, QUERIES, 4 * s, torch.Generator().manual_seed(77))


def test_lw_moments_within_the_cells_z_limits(gnn):
    s = 4096
    rows = _served(gnn, QUERIES, s)
    got = _judged(rows, _reference(gnn, s), s)
    assert got["rows_bad"] == 0 and got["rows_unjudged"] <= 1, got
    assert got["z_rms"] <= Z_RMS and got["z_max"] <= Z_MAX, got


def test_means_moved_5_se_fail_the_z_limits(gnn):
    """Every served mean moved by 5 of its standard errors (the row's
    std over the root of the port's ESS) reads above the z-limits."""
    s = 4096
    rows = _served(gnn, QUERIES, s)
    ess = gnn._inference._last_ess.double().numpy()[:len(rows)]
    shift = 5.0 * np.asarray(rows, np.float64)[:, 1] / np.sqrt(ess)
    got = _judged(rows, _reference(gnn, s), s, shift)
    assert got["z_rms"] > Z_RMS, got


@pytest.fixture
def empty_spans():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _kde():
    g = np.random.default_rng(0)
    x0, x1 = g.normal(size=200), g.normal(size=200)
    x2 = 0.5 * x0 - 0.2 * x1 + 0.1 * g.normal(size=200)
    k = VBN([("x0", "x2"), ("x1", "x2")], seed=0, device="cpu")
    kde = dict(defaults.cpd("kde"), max_points=64)
    k.set_learning_method("node_wise",
                          nodes_cpds={n: kde for n in ("x0", "x1", "x2")})
    k.fit({"x0": x0, "x1": x1, "x2": x2})
    return k


def test_spans_and_counters_of_the_mlp(gnn, empty_spans):
    s = 256
    before = profiling.counters()["MLP"]
    with profile(activities=[ProfilerActivity.CPU]):
        _served(gnn, QUERIES[:4], s)
        k = _kde()
        k.set_inference_method("likelihood_weighting", n_samples=s,
                               dynamic_masks=True)
        k.infer_posterior_moments(
            [{"target": "x0", "evidence": {"x2": [[0.5]]}}],
            dynamic_masks=True, pad_bucket=1)
    recs = profiling.spans()
    roots = [r for r in recs if r["parent"] < 0 and r["name"] == "vbn.call"]
    assert len(roots) == 2
    names = {}
    for r in recs:
        names.setdefault(r["call"], []).append(r["name"])
    gnn_call, kde_call = (names[r["call"]] for r in roots)
    assert gnn_call.count("vbn.mlp.sample") == 4
    assert gnn_call.count("vbn.mlp.log_prob") == 4
    assert roots[0]["attrs"]["mlp_rows"] == 8 * 4 * s
    assert not any(n.startswith("vbn.mlp.") for n in kde_call)
    assert roots[1]["attrs"]["mlp_rows"] == 0
    after = profiling.counters()["MLP"]
    assert after["forwards"] - before["forwards"] == 8
    assert after["rows"] - before["rows"] == 8 * 4 * s


@pytest.mark.parametrize("dp", [1, 2, 3])
def test_bf16_products_leave_the_forward_tolerance(dp):
    """The same parameters through bf16 products stray past 1e-4 of
    ``std_y`` from the float64 forward: the 1e-5 of the float32 test
    above would see a lower precision."""
    gen = torch.Generator().manual_seed(100 + dp)
    cpd = GaussianNNCPD(dp, 1, hidden_dims=(32, 32), min_scale=MIN_SCALE,
                        compute_dtype="bfloat16")
    params = random_params(cpd, gen)
    pa = 2.0 * torch.randn((4096, dp), generator=gen)
    loc, scale = cpd._denorm_params(params, pa, 4096)
    node = ref_node(params)
    rl, rs = loc_scale(node, pa, 4096)
    gap = max(float((loc[:, 0].double() - rl).abs().max()),
              float((scale[:, 0].double() - rs).abs().max())) / node.std_y
    assert loc.dtype == torch.float32 and gap > 1e-4


def test_a_root_runs_no_mlp_forward(empty_spans):
    """A root's draw and log-density take (loc, log_scale): no span, no
    count."""
    gen = torch.Generator().manual_seed(5)
    cpd = GaussianNNCPD(0, 1, min_scale=MIN_SCALE)
    params = random_params(cpd, gen)
    before = dict(profiling.counters()["MLP"])
    with profile(activities=[ProfilerActivity.CPU]):
        x = cpd._sample_flat(params, gen, None, 64)
        cpd._log_prob_flat(params, x, None)
    assert profiling.counters()["MLP"] == before
    assert not any(r["name"].startswith("vbn.mlp.")
                   for r in profiling.spans())


def test_the_mlp_counter_zeroes_with_the_others(gnn):
    _served(gnn, QUERIES[:2], 64)
    got = profiling.counters()["MLP"]
    assert got["forwards"] > 0 and got["rows"] > 0
    profiling.reset_counters()
    assert profiling.counters()["MLP"] == {"forwards": 0, "rows": 0,
                                           "fused": 0, "fused_rows": 0}


def test_the_mlp_spans_leave_the_rows_bit_for_bit(gnn, empty_spans):
    gnn._keys.set_state(900)
    off = _served(gnn, QUERIES, 512)
    gnn._keys.set_state(900)
    with profile(activities=[ProfilerActivity.CPU]):
        on = _served(gnn, QUERIES, 512)
    assert any(r["name"] == "vbn.mlp.sample" for r in profiling.spans())
    assert np.array_equal(np.asarray(off), np.asarray(on))


# -- the benchmark cell ``gauss8-gnn-lw.mixed96`` on the CPU, at small sizes

CELL = "gauss8-gnn-lw.mixed96"
SMALL = {"n_samples": 4096, "rows_per_call": 8, "sample_rows": 16}
CELL_SEED = 2**31 + 23


def _cell_root(tmp_path, **cpd):
    """A copy of the benchmark's folder whose configuration sets ``cpd``
    (``epochs`` sets the fit's)."""
    root = tmp_path / "vbnbench"
    shutil.copytree(registry.HERE, root,
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    path = root / "configs" / "gauss8-gnn-lw.json"
    conf = json.loads(path.read_text())
    for k, v in cpd.items():
        if k == "epochs":
            conf["cpd"]["params"]["fit"]["epochs"] = v
        else:
            conf["cpd"]["params"][k] = v
    path.write_text(json.dumps(conf))
    return root


def _run_cell(**kw):
    return run.run_cell(CELL, CELL_SEED, 0.5, False, device="cpu",
                        overrides=SMALL, bench=registry.load_benchmark(), **kw)


def test_the_cell_is_correct_on_the_cpu():
    res = _run_cell(control=True)
    line, judged = res["line"], res["judged"]
    assert line["correct"], judged
    assert line["failed"] == 0
    assert set(line["checks"]) == {"z_rms", "z_max", "rows_bad", "fit_nll_gap",
                                   "sample_gap", "log_prob_gap"}
    assert 0 <= judged["numbers"]["truth_rms"] < 5
    lim = registry.limits(CELL)
    ctl = judged["control"]
    assert not check.verdict(ctl, {k: v for k, v in lim.items() if k in ctl}), ctl


def _moved_5_se(seen):
    def wrap(serve):
        def broken(call):
            rows = np.array(serve(call), np.float64, copy=True)
            ess = seen["vbn"]._inference._last_ess.double().numpy()[:len(rows)]
            rows[:, 0] += 5.0 * rows[:, 1] / np.sqrt(ess)
            return rows
        return broken
    return wrap


@pytest.mark.parametrize("fault", ["bf16_products", "means_moved_5_se",
                                   "under_fit"])
def test_a_faulty_program_is_not_correct(fault, tmp_path, monkeypatch):
    """bf16 products in the program's place fail the forward probes; means
    moved by 5 of their standard errors fail the z-limits; a fit of 5
    epochs fails the fit's limits."""
    if fault == "means_moved_5_se":
        seen = {}
        server = run.Cell.server

        def keep(self, vbn):
            seen["vbn"] = vbn
            return server(self, vbn)

        monkeypatch.setattr(run.Cell, "server", keep)
        res = _run_cell(wrap_serve=_moved_5_se(seen))
        failed = {"z_rms"}
    elif fault == "bf16_products":
        res = _run_cell(root=_cell_root(tmp_path, compute_dtype="bfloat16"))
        failed = {"sample_gap", "log_prob_gap"}
    else:
        res = _run_cell(root=_cell_root(tmp_path, epochs=5))
        failed = {"fit_nll_gap"}
    checks = res["line"]["checks"]
    assert not res["line"]["correct"], res["judged"]
    over = {k for k, v in checks.items() if v["value"] > v["limit"]}
    assert failed <= over, checks


def test_the_check_leaves_the_tf32_switches_as_it_found_them(monkeypatch):
    """The reference turns TF32 off around its own products only."""
    seen = []
    relu = torch.relu

    def spy(h):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return relu(h)

    monkeypatch.setattr(torch, "relu", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    gen = torch.Generator().manual_seed(3)
    cpd = GaussianNNCPD(1, 1, hidden_dims=(32, 32), min_scale=MIN_SCALE)
    p = random_params(cpd, gen)
    nodes = {"a": gnn_lw.node({"loc": [0.1], "log_scale": [0.2]},
                              {"mean_x": [], "std_x": [], "mean_y": [0.0],
                               "std_y": [1.0]}, MIN_SCALE, "cpu"),
             "b": gnn_lw.node(p["net"], p["stats"], MIN_SCALE, "cpu")}
    got = gnn_lw.lw_moments(["a", "b"], {"a": [], "b": ["a"]}, nodes,
                            [("a", {"b": 0.3})], 256, gen, "cpu")
    assert np.isfinite(got).all()
    assert seen and all(s == (False, False) for s in seen)
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == (True, True)


def test_the_work_count_is_one_forward_a_node():
    """One forward a node with parents a particle: the MLP nodes of gauss8
    (3, 3, 1 and 2 parents) over a row with no evidence."""
    net = SimpleNamespace(nodes=NET.nodes, parents=NET.parents,
                          hidden=[32, 32])
    call = SimpleNamespace(rows=[("x7", {})])
    got = work_gnn.count(net, call, 1000)

    def forward(dp):
        return 2 * (32 * dp + 32 * 32 + 32 * 2) + 66 + 64 + 2 * dp + 5

    dps = [len(NET.parents[n]) for n in NET.nodes if NET.parents[n]]
    assert sorted(dps) == [1, 2, 3, 3]
    want = sum(forward(dp) for dp in dps) + 8 * (59 + 2) + 7
    assert got["ops"] == 1000 * want and got["tc"] == 0.0
    assert got["sfu"] == 1000 * (2 * 4 + 8 * 3 + 1)


def _traced(tv, queries, s):
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        _served(tv, queries, s)
    return {"calls": [None]}


@pytest.mark.parametrize("port", ["now", "older"])
def test_the_mlp_readers(gnn, empty_spans, monkeypatch, port):
    """On a served gnn call the readers give the root's rows in millions
    and the spans' self time; on a KDE call, or on a port without
    ``mlp_rows`` or spans, None."""
    rows = registry.metric_reader("mlp_rows_per_call")
    ms = registry.metric_reader("mlp_ms_per_call")
    ctx = _traced(gnn, QUERIES[:4], 256)
    if port == "older":
        for r in profiling.spans():
            r["attrs"].pop("mlp_rows", None)
        assert rows.read(ctx) is None
        monkeypatch.delattr(profiling, "spans")
        assert rows.read(ctx) is None and ms.read(ctx) is None
        return
    assert rows.read(ctx) == pytest.approx(8 * 4 * 256 / 1e6)
    assert ms.read(ctx) > 0
    k = _kde()
    k.set_inference_method("likelihood_weighting", n_samples=64,
                           dynamic_masks=True)
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        k.infer_posterior_moments(
            [{"target": "x0", "evidence": {"x2": [[0.5]]}}],
            dynamic_masks=True, pad_bucket=1)
    assert rows.read(ctx) is None and ms.read(ctx) is None


@pytest.mark.parametrize("call", ["gnn", "kde", "older"])
def test_the_fused_share_reader(gnn, empty_spans, call):
    """``mlp_fused_share`` reads the roots' ``mlp_fused_rows`` over their
    ``mlp_rows``: 0 on a CPU gnn call (the plain route serves it), None on
    a KDE call (no MLP rows) and on a port whose roots record no
    ``mlp_fused_rows``."""
    share = registry.metric_reader("mlp_fused_share")
    if call == "kde":
        k = _kde()
        k.set_inference_method("likelihood_weighting", n_samples=64,
                               dynamic_masks=True)
        profiling.reset_spans()
        with profile(activities=[ProfilerActivity.CPU]):
            k.infer_posterior_moments(
                [{"target": "x0", "evidence": {"x2": [[0.5]]}}],
                dynamic_masks=True, pad_bucket=1)
        assert share.read({"calls": [None]}) is None
        return
    ctx = _traced(gnn, QUERIES[:4], 256)
    if call == "older":
        for r in profiling.spans():
            r["attrs"].pop("mlp_fused_rows", None)
        assert share.read(ctx) is None
        return
    assert share.read(ctx) == 0.0
