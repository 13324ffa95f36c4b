"""The traffic generator and the frozen Stage II copies: a seed repeats
exactly, another seed changes the queries, and the cell shapes hold."""

import numpy as np
import pytest

from vbnbench import networks, registry, traffic
from vbnbench.traffic import stage2

BENCH = registry.load_benchmark()


def _net(config):
    return networks.build(registry.config(BENCH, config)["network"])


def _flat(calls):
    out = []
    for c in calls:
        out.append(sorted(c.kwargs.items()))
        out.extend((t, sorted(ev.items())) for t, ev in c.rows)
    return out


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_calls_repeat_for_a_seed(cell):
    w = registry.cell(BENCH, cell)
    net, mix = _net(w["config"]), registry.mix(w["traffic"])
    a = traffic.make_calls(net, mix, 2**31 + 17)
    b = traffic.make_calls(net, mix, 2**31 + 17)
    c = traffic.make_calls(net, mix, 2**31 + 18)
    assert _flat(a) == _flat(b)
    assert _flat(a) != _flat(c)
    for call in a:
        assert len(call.rows) == mix["rows_per_call"]
        for q in call.queries:
            for v in q["evidence"].values():
                assert v.dtype == np.float32 and v.shape[1] == 1


def test_fixed_calls_share_a_skeleton():
    net, mix = _net("alarm-lw"), registry.mix("fixed512")
    calls = traffic.make_calls(net, mix, 5)
    assert len(calls) == mix["skeletons"]
    skels = set()
    for c in calls:
        assert len(c.queries) == 1
        t, ev = c.rows[0]
        assert 1 <= len(ev) <= mix["max_evidence"]
        assert all(r[0] == t and set(r[1]) == set(ev) for r in c.rows)
        assert c.kwargs["n_classes"] == net.card(t)
        skels.add((t, tuple(sorted(ev))))
    assert len(skels) == mix["skeletons"]


@pytest.mark.parametrize("config,mixname", [("alarm-lw", "mixed256"),
                                            ("gauss8-kde-lw", "mixed96")])
def test_mixed_calls(config, mixname):
    net, mix = _net(config), registry.mix(mixname)
    calls = traffic.make_calls(net, mix, 9)
    assert len(calls) == mix["pool_calls"]
    counts = {len(ev) for c in calls for _t, ev in c.rows}
    assert counts <= set(range(mix["max_evidence"] + 1)) and 0 in counts
    assert all(c.kwargs["dynamic_masks"] and
               c.kwargs["pad_bucket"] == mix["rows_per_call"] for c in calls)
    targets = {t for c in calls for t, _ev in c.rows}
    assert len(targets) > 1


def test_graph_analytics_match_networkx():
    nx = pytest.importorskip("networkx")
    net = _net("alarm-lw")
    adj = stage2.moralized(net)
    g = nx.Graph()
    g.add_nodes_from(net.nodes)
    g.add_edges_from((a, b) for a in adj for b in adj[a])
    ours = stage2.graph_analytics(net)
    assert ours["articulation"] == set(nx.articulation_points(g))
    assert ours["eccentricity"] == dict(nx.eccentricity(g))
    bc = nx.betweenness_centrality(g)
    for n in net.nodes:
        assert ours["betweenness"][n] == pytest.approx(bc[n], abs=1e-12)
