"""The harness finds each piece by its name, and a file dropped into its
folder is taken with no edit to any other."""

import json
import shutil

import pytest

from vbnbench import networks, registry, run

BENCH = registry.load_benchmark()


def test_benchmark_names_only_pieces_that_exist():
    fams, kinds = set(), set()
    for c in BENCH["configs"]:
        conf = registry.config(BENCH, c["name"])
        assert conf["name"] == c["name"]
        assert conf["source"] == c["source"] and conf["reduced"] == c["reduced"]
        fams.add(conf["cpd"]["family"])
        kinds.add(conf["network"]["kind"])
    for w in BENCH["workloads"]:
        assert registry.mix(w["traffic"])["shape"] in ("fixed", "mixed")
        lim = registry.limits(w["name"])
        assert lim["rows_bad"] == 0 and lim["sample_rows"] > 0
    for m in BENCH["per_layer"]:
        assert callable(registry.metric_reader(m["name"]).read)
    for f in fams:
        assert callable(registry.work_counter(f).count)
        assert callable(registry.reference(f).judge)
    for k in kinds:
        assert callable(registry.network_kind(k).build)


def test_metrics_of_a_cell():
    # every cell reports every metric: none is filtered to some cells
    names = {m["name"] for m in BENCH["per_layer"]}
    assert names == {"host_ms_per_call", "kernels_per_call", "lw_roofline_pct",
                     "device_idle_pct", "device_peak_gib"}
    assert not any("workloads" in m for m in BENCH["per_layer"] + BENCH["end_to_end"])


def _copy(tmp_path):
    root = tmp_path / "vbnbench"
    shutil.copytree(registry.HERE, root,
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    return root


@pytest.mark.parametrize("kind", ["metrics", "work", "traffic", "limits",
                                  "reference", "networks"])
def test_a_dropped_file_is_found(tmp_path, kind):
    root = _copy(tmp_path)
    if kind == "metrics":
        (root / "metrics" / "new_metric.py").write_text(
            "def read(ctx):\n    return 2.5 * len(ctx['calls'])\n")
        assert registry.metric_reader("new_metric", root).read({"calls": [1, 2]}) == 5.0
    elif kind == "work":
        (root / "work" / "new_family.py").write_text(
            "def count(net, call, s):\n    return {'ops': float(s)}\n")
        assert registry.work_counter("new_family", root).count(None, None, 7) == {"ops": 7.0}
    elif kind == "traffic":
        (root / "traffic" / "new_mix.json").write_text(json.dumps(
            {"shape": "mixed", "rows_per_call": 4, "pool_calls": 2}))
        assert registry.mix("new_mix", root)["rows_per_call"] == 4
    elif kind == "limits":
        (root / "limits" / "new.cell.json").write_text(json.dumps(
            {"sample_rows": 3, "rows_bad": 0}))
        assert registry.limits("new.cell", root)["sample_rows"] == 3
    elif kind == "reference":
        (root / "reference" / "new_family.py").write_text(
            "def judge(cell, sampled, observed, device, control=False):\n"
            "    return {'numbers': {'rows_bad': len(sampled)}}\n")
        assert registry.reference("new_family", root).judge(
            None, [1, 2], None, "cpu") == {"numbers": {"rows_bad": 2}}
    else:
        (root / "networks" / "chain.py").write_text(CHAIN)
        net = networks.build({"kind": "chain", "n_nodes": 4}, root)
        assert net.nodes == ["x0", "x1", "x2", "x3"]
        assert net.parents["x3"] == ["x2"]


def test_a_dropped_config_is_found(tmp_path):
    conf = dict(registry.config(BENCH, "alarm-lw"), name="alarm-lw-2")
    (tmp_path / "vbnbench" / "configs").mkdir(parents=True)
    (tmp_path / "vbnbench" / "configs" / "alarm-lw-2.json").write_text(json.dumps(conf))
    bench = dict(BENCH, configs=BENCH["configs"] + [
        {"name": "alarm-lw-2", "file": "vbnbench/configs/alarm-lw-2.json"}])
    assert registry.config(bench, "alarm-lw-2", checkout=tmp_path)["name"] == "alarm-lw-2"


# A network kind of its own: a linear-Gaussian chain x0 -> x1 -> ...
CHAIN = """
from vbnbench.networks.gaussian import GaussianNet


def build(spec):
    net = GaussianNet(name="chain")
    for i in range(int(spec["n_nodes"])):
        v = f"x{i}"
        net.nodes.append(v)
        net.parents[v] = [f"x{i - 1}"] if i else []
        net.weights[v] = [0.8] if i else []
        net.bias[v] = 0.1 * i
        net.sigma[v] = 0.6
    return net
"""

# A family's check of its own: linear-Gaussian CPDs refitted by least
# squares from the benchmark's rows, each row's exact posterior mean by
# conditioning the joint Gaussian; the gap in posterior stds.
LG_REFERENCE = """
import numpy as np


def judge(cell, sampled, observed, device, control=False):
    net, data = cell.net, cell.data
    for v in net.nodes:
        ps = net.parents[v]
        a = np.column_stack([np.ones(len(data[v]))] + [data[p] for p in ps])
        coef, *_ = np.linalg.lstsq(a, data[v], rcond=None)
        net.bias[v], net.weights[v] = float(coef[0]), [float(c) for c in coef[1:]]
        net.sigma[v] = float(np.std(data[v] - a @ coef))
    mu, cov = net.system()
    ix = {v: i for i, v in enumerate(net.nodes)}
    gaps, bad = [], 0
    for got, t, ev in sampled:
        if got is None or not np.isfinite(got).all():
            bad += 1
            continue
        e = [ix[v] for v in ev]
        k = cov[ix[t], e] @ np.linalg.inv(cov[np.ix_(e, e)]) if e else np.zeros(0)
        m = mu[ix[t]] + k @ (np.array(list(ev.values())) - mu[e])
        sd = np.sqrt(cov[ix[t], ix[t]] - (k @ cov[e, ix[t]] if e else 0.0))
        gaps.append(abs(got[0] - m) / sd)
    return {"numbers": {"mean_gap": float(max(gaps)), "rows_bad": bad}}
"""


def test_a_dropped_family_and_network_kind_run(tmp_path):
    """A configuration of a CPD family and a network kind that the harness
    has never seen, added as files alone, is served and judged."""
    root = _copy(tmp_path)
    (root / "networks" / "chain.py").write_text(CHAIN)
    (root / "reference" / "linear_gaussian.py").write_text(LG_REFERENCE)
    (root / "work" / "linear_gaussian.py").write_text(
        "def count(net, call, s):\n"
        "    return {'ops': float(2 * len(net.nodes) * len(call.rows) * s)}\n")
    conf = {"name": "chain4-lg-lw",
            "network": {"kind": "chain", "n_nodes": 4},
            "fit_rows": 2000,
            "cpd": {"family": "linear_gaussian", "params": {}},
            "method": {"name": "likelihood_weighting",
                       "params": {"n_samples": 4096, "dynamic_masks": True}},
            "entry": "infer_posterior_moments",
            "control": {"n_samples_divisor": 64}}
    (root / "configs" / "chain4-lg-lw.json").write_text(json.dumps(conf))
    (root / "traffic" / "mixed8.json").write_text(json.dumps(
        {"shape": "mixed", "rows_per_call": 8, "pool_calls": 2,
         "call_kwargs": {"dynamic_masks": True, "pad_bucket": 8},
         "evidence_modes": ["empty", "on_manifold"], "max_evidence": 2}))
    (root / "limits" / "chain4-lg-lw.mixed8.json").write_text(json.dumps(
        {"sample_rows": 16, "mean_gap": 0.3, "rows_bad": 0}))
    bench = dict(
        BENCH,
        configs=[{"name": "chain4-lg-lw", "file": "vbnbench/configs/chain4-lg-lw.json"}],
        workloads=[{"name": "chain4-lg-lw.mixed8", "config": "chain4-lg-lw",
                    "traffic": "mixed8", "chips": 1}])
    res = run.run_cell("chain4-lg-lw.mixed8", 2**31 + 7, 0.5, False, device="cpu",
                       bench=bench, root=root)
    line = res["line"]
    assert set(line["checks"]) == {"mean_gap", "rows_bad"}
    assert line["correct"], res["judged"]
    assert line["failed"] == 0 and line["attempted"] >= 8
