"""The port's spans and counters (``utils/profiling.py``), on the CPU.

A served call opens one ``vbn.call`` root and a span around each stage
below it. Spans record only under ``torch.profiler``: with none, a call
leaves the buffer empty and a span enters no ``record_function``. Under
the profiler every span of the buffer is a ``record_function`` range of
the same name and nesting, and the rows are the rows served with it off.
Four routes: the static fused pmf (asia, LW), the dynamic scan pmf on the
plain versions (asia, LW ``dynamic_masks``), the KDE per-node dynamic
moments and the stream fallback (static KDE moments).
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmarking.data_gen import generate_dataset
from benchmarking.networks import asia
from vectorizedbayesiannetwork_torch import VBN, defaults
from vectorizedbayesiannetwork_torch.utils import profiling

S = 1024

ASIA_Q = {"target": "dysp", "evidence": {"smoke": [[1.0], [0.0], [1.0]],
                                        "asia": [[0.0], [1.0], [1.0]]}}
ASIA_Q2 = {"target": "lung", "evidence": {"xray": [[1.0]]}}
KDE_Q = {"target": "x0", "evidence": {"x2": [[0.5], [-1.0]]}}
KDE_Q2 = {"target": "x2", "evidence": {"x1": [[0.2]]}}

# route: (network, method keywords, entry, queries, reduce path, a span
# only that route opens)
ROUTES = {
    "static_fused_pmf": ("asia", {}, "pmf", [ASIA_Q], "fused", "vbn.build"),
    "dynamic_scan_pmf": ("asia", {"dynamic_masks": True}, "pmf",
                         [ASIA_Q, ASIA_Q2], "dynamic", "vbn.build"),
    "kde_dynamic_moments": ("kde", {"dynamic_masks": True}, "moments",
                            [KDE_Q, KDE_Q2], "dynamic",
                            "vbn.sweep.per_node"),
    "stream_moments": ("kde", {}, "moments", [KDE_Q], "stream",
                       "vbn.sweep.per_node"),
}


@pytest.fixture(scope="module")
def nets():
    bn = asia()
    data = generate_dataset(bn, 2048, seed=0)
    a = VBN({n: list(bn.parents[n]) for n in bn.nodes}, seed=0, device="cpu")
    conf = {}
    for node in bn.nodes:
        c = dict(defaults.cpd("categorical_table"), n_classes=bn.card(node))
        if bn.parents[node]:
            c["parent_n_classes"] = [bn.card(p) for p in bn.parents[node]]
        conf[node] = c
    a.set_learning_method("node_wise", nodes_cpds=conf)
    a.fit({k: np.asarray(v, np.float32).reshape(-1, 1)
           for k, v in data.items()})

    g = np.random.default_rng(0)
    x0, x1 = g.normal(size=400), g.normal(size=400)
    x2 = 0.5 * x0 - 0.2 * x1 + 0.1 * g.normal(size=400)
    k = VBN([("x0", "x2"), ("x1", "x2")], seed=0, device="cpu")
    kde = dict(defaults.cpd("kde"), max_points=64)
    k.set_learning_method("node_wise",
                          nodes_cpds={n: kde for n in ("x0", "x1", "x2")})
    k.fit({"x0": x0, "x1": x1, "x2": x2})
    return {"asia": a, "kde": k}


@pytest.fixture(autouse=True)
def _empty_buffer():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _serve(nets, route):
    net, kw, entry, queries, _path, _span = ROUTES[route]
    vbn = nets[net]
    vbn.set_inference_method("likelihood_weighting", n_samples=S, **kw)
    if entry == "pmf":
        return vbn, lambda: vbn.infer_posterior_pmf(queries, n_classes=2)
    return vbn, lambda: vbn.infer_posterior_moments(queries)


def _profiled(call, n=1):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        outs = [call() for _ in range(n)]
    return prof, outs


def _by_call(recs):
    calls = {}
    for r in recs:
        calls.setdefault(r["call"], []).append(r)
    return calls


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_no_profiler_leaves_no_spans(nets, route):
    _vbn, call = _serve(nets, route)
    call()
    assert profiling.spans() == []


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_one_root_a_call_and_nested_spans(nets, route):
    _net, _kw, entry, queries, path, only = ROUTES[route]
    _vbn, call = _serve(nets, route)
    _prof, outs = _profiled(call, n=2)
    recs = profiling.spans()
    assert [r["index"] for r in recs] == list(range(len(recs)))
    roots = [r for r in recs if r["parent"] < 0]
    assert [r["name"] for r in roots] == ["vbn.call", "vbn.call"]
    assert len({r["call"] for r in roots}) == 2
    rows = sum(len(next(iter(q["evidence"].values()))) for q in queries)
    for root, (out, _spans) in zip(roots, outs):
        assert root["attrs"]["entry"] == f"infer_posterior_{entry}"
        assert root["attrs"]["queries"] == len(queries)
        assert root["attrs"]["rows"] == rows == len(out)
        assert set(root["attrs"]["builds"]) == {"fn", "tables", "plans"}
    for r in recs:
        assert r["start_ns"] <= r["end_ns"]
        if r["parent"] >= 0:
            up = recs[r["parent"]]
            assert up["index"] < r["index"]
            assert (up["start_ns"] <= r["start_ns"] <= r["end_ns"]
                    <= up["end_ns"])
            assert r["call"] == up["call"]
    for spans in _by_call(recs).values():
        names = [r["name"] for r in spans]
        assert f"vbn.reduce.{path}" in names and only in names
        for stage in ("vbn.normalize", "vbn.plan", "vbn.pack", "vbn.upload",
                      "vbn.fetch"):
            assert stage in names, stage
        assert [n for n in names if n.startswith("vbn.reduce.")] == [
            f"vbn.reduce.{path}"]
        assert names.count("vbn.normalize") == 1


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_spans_are_the_profilers_ranges(nets, route):
    """Every in-memory span is a ``record_function`` event of the same name,
    the k-th of its name in order of start, whose nearest ``vbn.*``
    ancestor is its parent's event."""
    _vbn, call = _serve(nets, route)
    prof, _ = _profiled(call, n=2)
    recs = profiling.spans()
    events = sorted((e for e in prof.events() if e.name.startswith("vbn.")
                     and e.device_type == torch.autograd.DeviceType.CPU),
                    key=lambda e: e.time_range.start)
    assert len(events) == len(recs)
    by_name = {}
    for e in events:
        by_name.setdefault(e.name, []).append(e)
    seen = {}
    matched = []
    for r in recs:
        k = seen.get(r["name"], 0)
        seen[r["name"]] = k + 1
        matched.append(by_name[r["name"]][k])
    for r, e in zip(recs, matched):
        up = e.cpu_parent
        while up is not None and not up.name.startswith("vbn."):
            up = up.cpu_parent
        if r["parent"] < 0:
            assert up is None
        else:
            assert up is matched[r["parent"]]


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_rows_equal_with_the_profiler_on_and_off(nets, route):
    vbn, call = _serve(nets, route)
    vbn._keys.set_state(900)
    off, off_spans = call()
    vbn._keys.set_state(900)
    _prof, [(on, on_spans)] = _profiled(call)
    np.testing.assert_array_equal(np.asarray(on), np.asarray(off))
    assert on_spans == off_spans
    assert profiling.spans()


def test_counters_cover_every_counter_and_reset(nets):
    _vbn, call = _serve(nets, "kde_dynamic_moments")
    call()
    snap = profiling.counters()
    assert {"LAUNCHES", "TRACES", "ROUTES", "GROUPS", "BUILDS"} <= set(snap)
    assert snap["ROUTES"]["per_node"] >= 1 and snap["BUILDS"]["plans"] >= 0
    from vectorizedbayesiannetwork_torch.inference import _sweep
    from vectorizedbayesiannetwork_torch.ops import _launch

    assert snap["LAUNCHES"] == _launch.LAUNCHES
    assert snap["ROUTES"] == dict(_sweep.ROUTES)
    snap["BUILDS"]["fn"] += 1000  # a snapshot, not the counter
    assert profiling.counters()["BUILDS"]["fn"] != snap["BUILDS"]["fn"]
    profiling.reset_counters()
    after = profiling.counters()
    assert set(after) == set(snap)
    assert all(v == 0 for c in after.values() for v in c.values())
    assert set(after["LAUNCHES"]) == set(snap["LAUNCHES"])
    call()  # the fixed keys are still there to bump
    assert profiling.counters()["ROUTES"]["per_node"] == 1


def test_static_categorical_query_rebuilds_on_every_call(nets):
    """Today's static fused path builds its kernel function and its tables
    again on every call: the same query served twice raises ``BUILDS["fn"]``
    and ``BUILDS["tables"]`` by the same amount each time."""
    _vbn, call = _serve(nets, "static_fused_pmf")
    call()  # the plan is cached from here on
    deltas = []
    for _ in range(2):
        before = dict(profiling.BUILDS)
        call()
        deltas.append({k: profiling.BUILDS[k] - before[k] for k in before})
    assert deltas[0] == deltas[1]
    assert deltas[0]["fn"] >= 1 and deltas[0]["tables"] >= 1
    assert deltas[0]["plans"] == 0


def test_a_span_with_no_profiler_is_one_check(monkeypatch):
    """With no profiler a span enters no ``record_function`` and appends
    nothing; under one it does both."""
    entered = []

    class Spy:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Spy)
    f = profiling.spanned("vbn.f")(lambda x: x + 1)
    assert profiling.annotate("vbn.x", a=1) is profiling.annotate("vbn.y")
    with profiling.annotate("vbn.x") as sp:
        sp.set(rows=3)
    assert f(1) == 2
    assert entered == [] and profiling.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("vbn.x", a=1) as sp:
            sp.set(rows=3)
            assert f(1) == 2
    assert entered == ["vbn.x", "vbn.f"]
    outer, inner = profiling.spans()
    assert outer["attrs"] == {"a": 1, "rows": 3,
                              "builds": {"fn": 0, "tables": 0, "plans": 0},
                              "mlp_rows": 0, "mlp_fused_rows": 0}
    assert inner["parent"] == outer["index"] and inner["call"] == outer["call"]


def test_a_wait_syncs_only_under_a_profiler_on_a_card(monkeypatch):
    """``wait`` marks a blocking copy: with no profiler, or on the CPU, it
    does nothing; under one, on a CUDA device, it waits for the stream
    inside a ``vbn.sync`` span below the open span."""
    synced = []

    class Stream:
        def synchronize(self):
            synced.append(True)

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: Stream())
    profiling.wait("cuda")
    profiling.wait(torch.device("cpu"))
    assert synced == [] and profiling.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.wait("cpu")
        assert profiling.spans() == []
        with profiling.annotate("vbn.upload"):
            profiling.wait(torch.device("cuda"))
    assert synced == [True]
    up, sync = profiling.spans()
    assert (up["name"], sync["name"]) == ("vbn.upload", "vbn.sync")
    assert sync["parent"] == up["index"] and sync["call"] == up["call"]


def test_spans_past_the_bound_are_counted(monkeypatch):
    """Past ``MAX_SPANS`` a span still opens and closes, is not kept, and
    counts in ``spans_dropped()`` until ``reset_spans()``."""
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with profiling.annotate("vbn.call"):
                with profiling.annotate("vbn.pack"):
                    pass
    assert [r["name"] for r in profiling.spans()] == [
        "vbn.call", "vbn.pack", "vbn.call"]
    assert profiling.spans_dropped() == 1
    profiling.reset_spans()
    assert profiling.spans() == [] and profiling.spans_dropped() == 0
