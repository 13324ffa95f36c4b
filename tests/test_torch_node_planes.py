"""The per-node dynamic sweep's node-major store, on the CPU.

``inference/_dynamic_sweep.py::_per_node_trace`` keeps its values in one
[total_dim, B, S] store, each node writing its own planes, and with
``targets`` returns each row's target block gathered from its planes
(``dynamic_target_values``). ``parent_per_node_trace`` below is the loop it
replaced: the nodes' values in a list, ``torch.cat`` into [B, S, total_dim],
then the per-row gather over that packed tensor
(``chip_smoke.py::packed_target_values``, which times it on the card). On a mixed network (a
categorical root, a linear-Gaussian node of two dims, two of one dim, so
both scan gates refuse the plan) the two agree bit for bit:

- the sweep's outputs as likelihood weighting, importance sampling (its two
  sweeps) and Monte-Carlo marginalization (``tgt_mask``) call it, rows of
  differing targets, the two-dim node among them;
- the served rows of each of those methods;
- without ``targets``, ``packed`` [B, S, total_dim] (the amortizer's
  route), and the amortizer's model rows;
- the stacked forms' route, which hands the gather ``packed.permute(2, 0,
  1)``.

``SWEEPS`` counts the output a per-node sweep gave: ``target_planes`` once
a served sweep, ``packed`` once for the amortizer's.

This file imports no JAX: ``tests/test_torch_cuda.py`` takes the parent
route from it on the card.
"""

from typing import List, Optional

import numpy as np
import pytest
import torch

from chip_smoke import packed_target_values
from vectorizedbayesiannetwork_torch import VBN, defaults
from vectorizedbayesiannetwork_torch.core.base import Query
from vectorizedbayesiannetwork_torch.core.plan import get_plan
from vectorizedbayesiannetwork_torch.core.rng import Draw, RowStream, fold
from vectorizedbayesiannetwork_torch.inference import _dynamic_sweep as dsw
from vectorizedbayesiannetwork_torch.inference._sweep import (
    ROUTES,
    _parents_flat,
)
from vectorizedbayesiannetwork_torch.learning.amortized import (
    AmortizedLearner,
    build_spec,
)
from vectorizedbayesiannetwork_torch.ops.kde_fused import ReadFlag


def parent_per_node_trace(plan, cpds, params_tuple, stream: RowStream, fixed,
                          ev_mask, do_mask, tgt_mask, targets=None):
    """``_per_node_trace`` as it was before the node-major store: a list of
    [B, S, d] values, their ``torch.cat``, then ``packed_target_values``."""
    b, s = fixed.shape[0], stream.s
    m = b * s
    vals: List[Optional[torch.Tensor]] = [None] * plan.n_nodes
    log_w = torch.zeros((b, s), dtype=torch.float32, device=fixed.device)
    lp_tgt = torch.zeros((b, s), dtype=torch.float32, device=fixed.device)
    fix = torch.maximum(ev_mask, do_mask)
    if any(c.takes_read_flag for c in cpds):
        free = 1.0 - fix
        scored = (ev_mask if tgt_mask is None
                  else torch.maximum(ev_mask, tgt_mask))
    for idx in range(plan.n_nodes):
        d = plan.node_dims[idx]
        off = plan.node_offsets[idx]
        pflat = _parents_flat(plan, vals, idx, m)
        pick_kw, lp_kw = {}, {}
        if cpds[idx].takes_read_flag:
            pick_kw = {"read": ReadFlag(free[:, idx], s)}
            lp_kw = {"read": ReadFlag(scored[:, idx], s)}
        sampled = cpds[idx]._sample_flat(params_tuple[idx], stream.node(idx),
                                         pflat, m, **pick_kw)
        fixed_b = fixed[:, None, off : off + d].expand(b, s, d)
        v = torch.where(fix[:, idx][:, None, None] > 0, fixed_b,
                        sampled.reshape(b, s, d))
        vals[idx] = v
        lp = cpds[idx]._log_prob_flat(
            params_tuple[idx], v.reshape(m, d), pflat, **lp_kw
        ).reshape(b, s)
        log_w = log_w + torch.where(ev_mask[:, idx][:, None] > 0, lp, 0.0)
        if tgt_mask is not None:
            lp_tgt = lp_tgt + torch.where(tgt_mask[:, idx][:, None] > 0, lp, 0.0)
    first = torch.cat(vals, dim=-1)
    if targets is not None:
        first = packed_target_values(plan, first, targets)
    if tgt_mask is not None:
        return first, log_w, lp_tgt
    return first, log_w


@pytest.fixture(scope="module")
def mixed():
    """c (3 classes) -> x (two dims) -> y <- c, y -> z; linear-Gaussian
    x, y, z."""
    rng = np.random.default_rng(0)
    n = 2048
    c = rng.integers(0, 3, size=n).astype(np.float32)
    x = np.stack([c - 1.0 + 0.3 * rng.normal(size=n),
                  0.5 * c + 0.3 * rng.normal(size=n)], 1).astype(np.float32)
    y = x[:, 0] - 0.5 * x[:, 1] + 0.2 * rng.normal(size=n)
    z = 0.7 * y + 0.3 * rng.normal(size=n)
    tv = VBN([("c", "x"), ("x", "y"), ("c", "y"), ("y", "z")], seed=0,
             device="cpu")
    tv.set_learning_method("node_wise", nodes_cpds={
        "c": dict(defaults.cpd("categorical_table"), n_classes=3),
        "x": defaults.cpd("linear_gaussian"),
        "y": defaults.cpd("linear_gaussian"),
        "z": defaults.cpd("linear_gaussian")})
    tv.fit({"c": c.reshape(-1, 1), "x": x,
            "y": y.astype(np.float32).reshape(-1, 1),
            "z": z.astype(np.float32).reshape(-1, 1)})
    return tv, {"c": c, "x": x, "y": y, "z": z}


# per row: target, evidence nodes, do nodes
ROWS = [("x", "z", ""), ("y", "c", ""), ("c", "x", ""), ("z", "", "y"),
        ("x", "", ""), ("z", "cx", ""), ("y", "z", "c")]


def _inputs(tv):
    plan = get_plan(tv, Query(target="z", evidence={}, do={}))
    cpds = tuple(tv.cpd_spec(n) for n in plan.topo_order)
    params = tuple(tv.params[n] for n in plan.topo_order)
    idx = plan.node_to_idx()
    b = len(ROWS)
    fixed = torch.tensor(np.random.default_rng(5).normal(
        size=(b, plan.total_dim)).astype(np.float32))
    fixed[:, plan.node_offsets[idx["c"]]] = torch.tensor(
        [0.0, 1.0, 2.0, 1.0, 0.0, 2.0, 1.0])
    ev = torch.zeros((b, plan.n_nodes))
    do = torch.zeros((b, plan.n_nodes))
    for row, (_t, e, d) in enumerate(ROWS):
        for n in e:
            ev[row, idx[n]] = 1.0
        for n in d:
            do[row, idx[n]] = 1.0
    ti = torch.tensor([idx[t] for t, _e, _d in ROWS], dtype=torch.int32)
    return plan, cpds, params, fixed, ev, do, ti


def _method_sweeps(method, plan, cpds, params, fixed, ev, do, ti, s):
    """The sweeps ``method``'s dynamic program runs, called as it calls
    them."""
    draw = Draw(11, torch.device("cpu"))
    if method == "lw":
        return [dsw.dynamic_sweep_trace(plan, cpds, params, draw, fixed, ev,
                                        do, s, targets=ti)]
    if method == "is":
        return [dsw.dynamic_sweep_trace(plan, cpds, params, fold(draw, k),
                                        fixed + k, ev, do, s, targets=ti)
                for k in (0, 1)]
    tgt = torch.nn.functional.one_hot(ti.long(), plan.n_nodes).float()
    return [dsw.dynamic_sweep_trace(
        plan, cpds, params, draw, fixed, torch.zeros_like(ev),
        torch.maximum(ev, do), s, tgt_mask=tgt, targets=ti)]


def _assert_equal(got, want):
    assert len(got) == len(want)
    for a, w in zip(got, want):
        assert len(a) == len(w)
        for x, y in zip(a, w):
            assert x.shape == y.shape and x.dtype == y.dtype
            assert torch.equal(x, y)


@pytest.mark.parametrize("method", ["lw", "is", "mcm"])
def test_the_target_block_equals_the_packed_route(mixed, method, monkeypatch):
    tv, _data = mixed
    args = _inputs(tv)
    s = 300
    before = dict(dsw.SWEEPS)
    got = _method_sweeps(method, *args, s)
    counted = {k: dsw.SWEEPS[k] - before[k] for k in before}
    assert counted == {"target_planes": len(got), "packed": 0}
    monkeypatch.setattr(dsw, "_per_node_trace", parent_per_node_trace)
    want = _method_sweeps(method, *args, s)
    _assert_equal(got, want)
    plan = args[0]
    block = got[0][0]
    assert block.shape == (len(ROWS), s, max(plan.node_dims))
    assert block.is_contiguous()
    # a one-dim target's second column is 0; the two-dim x's is its value
    for row, (t, _e, _d) in enumerate(ROWS):
        assert bool((block[row, :, 1] == 0).all()) == (t != "x")


@pytest.mark.parametrize("method", ["likelihood_weighting",
                                    "importance_sampling",
                                    "monte_carlo_marginalization"])
def test_served_rows_equal_the_packed_route(mixed, method, monkeypatch):
    tv, _data = mixed
    tv.set_inference_method(method, n_samples=256, dynamic_masks=True)
    qs = [{"target": "x", "evidence": {"z": [[0.5]]}},
          {"target": "y", "evidence": {"c": [[1.0]]}},
          {"target": "c", "evidence": {"x": [[0.1, 0.2]]}},
          {"target": "z", "evidence": {}, "do": {"y": [[0.3]]}}]
    served = []
    for patch in (False, True):
        if patch:
            monkeypatch.setattr(dsw, "_per_node_trace", parent_per_node_trace)
        tv._keys.set_state(500)
        before = dict(dsw.SWEEPS)
        served.append(tv.infer_posterior_many(qs))
        counted = dsw.SWEEPS["target_planes"] - before["target_planes"]
        assert counted == (0 if patch else
                           2 if method == "importance_sampling" else 1)
    got, want = served
    assert len(got) == len(want) == len(qs)
    for a, w in zip(got, want):
        for x, y in zip(a, w):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("with_tgt_mask", [False, True])
def test_without_targets_packed_equals_the_concatenation(mixed, with_tgt_mask,
                                                         monkeypatch):
    tv, _data = mixed
    plan, cpds, params, fixed, ev, do, ti = _inputs(tv)
    tgt = (torch.nn.functional.one_hot(ti.long(), plan.n_nodes).float()
           if with_tgt_mask else None)

    def sweep():
        return dsw.dynamic_sweep_trace(plan, cpds, params,
                                       Draw(3, torch.device("cpu")), fixed,
                                       ev, do, 200, tgt_mask=tgt)

    before = dict(dsw.SWEEPS)
    got = sweep()
    assert dict(dsw.SWEEPS) == {"target_planes": before["target_planes"],
                                "packed": before["packed"] + 1}
    monkeypatch.setattr(dsw, "_per_node_trace", parent_per_node_trace)
    want = sweep()
    _assert_equal([got], [want])
    assert got[0].shape == (len(ROWS), 200, plan.total_dim)
    assert got[0].is_contiguous()


def test_the_amortizers_sweep_gives_packed(mixed, monkeypatch):
    """``_model_rows`` (one sweep, S = 1, no targets) counts ``packed``
    once and gives the concatenation's rows."""
    tv, data = mixed
    spec = build_spec(tv, (8,), "relu", 1e-3, interventional=True)
    rows = np.concatenate([np.asarray(data[n], np.float32).reshape(2048, -1)
                           for n in spec.topo], axis=-1)
    learner = AmortizedLearner(hidden_dims=(8,))
    outs = []
    for patch in (False, True):
        if patch:
            monkeypatch.setattr(dsw, "_per_node_trace", parent_per_node_trace)
        before = dict(dsw.SWEEPS)
        outs.append(learner._model_rows(tv, spec, rows,
                                        np.random.default_rng(7), 1, 1))
        counted = {k: dsw.SWEEPS[k] - before[k] for k in before}
        assert counted == {"target_planes": 0, "packed": 0 if patch else 1}
    for a, w in zip(*outs):
        np.testing.assert_array_equal(a, w)


@pytest.mark.parametrize("family", ["categorical_table", "linear_gaussian"])
def test_the_stacked_form_hands_the_gather_its_permuted_view(family,
                                                             monkeypatch):
    """Under ``VBN_DISCRETE_SCAN=always`` a small chain takes a stacked
    form; its target block is the packed route's, bit for bit, and the
    per-node counter does not move."""
    rng = np.random.default_rng(1)
    n = 1024
    if family == "categorical_table":
        a = rng.integers(0, 3, size=n)
        b = (a + (rng.random(n) < 0.3)) % 3
        c = (b + (rng.random(n) < 0.3)) % 3
        conf = dict(defaults.cpd(family), n_classes=3,
                    parent_n_classes=[3])
    else:
        a = rng.normal(size=n)
        b = 0.8 * a + 0.5 * rng.normal(size=n)
        c = -0.6 * b + 0.5 * rng.normal(size=n)
        conf = defaults.cpd(family)
    tv = VBN([("a", "b"), ("b", "c")], seed=0, device="cpu")
    root = {k: v for k, v in conf.items() if k != "parent_n_classes"}
    tv.set_learning_method("node_wise", nodes_cpds={
        "a": root, "b": dict(conf), "c": dict(conf)})
    tv.fit({k: v.astype(np.float32) for k, v in zip("abc", (a, b, c))})
    monkeypatch.setenv("VBN_DISCRETE_SCAN", "always")
    plan = get_plan(tv, Query(target="c", evidence={}, do={}))
    cpds = tuple(tv.cpd_spec(k) for k in plan.topo_order)
    params = tuple(tv.params[k] for k in plan.topo_order)
    fixed = torch.tensor([[0.0, 1.0, 2.0], [1.0, 0.0, 1.0], [2.0, 2.0, 0.0]])
    ev = torch.tensor([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 0.0, 0.0]])
    do = torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    ti = torch.tensor([0, 2, 1], dtype=torch.int32)
    before = dict(dsw.SWEEPS)
    ROUTES.clear()
    outs = [dsw.dynamic_sweep_trace(plan, cpds, params,
                                    Draw(5, torch.device("cpu")), fixed, ev,
                                    do, 64, targets=t) for t in (ti, None)]
    assert dict(ROUTES) == {"discrete" if family == "categorical_table"
                            else "gaussian": 2}
    assert dict(dsw.SWEEPS) == before
    (block, lw_t), (packed, lw_p) = outs
    assert torch.equal(block, packed_target_values(plan, packed, ti))
    assert torch.equal(lw_t, lw_p)
