"""The gate verdict line, and the JAX package's route switches, in the port.

The gate line (``ops/sweep.py::gate_log``) is held field by field against
the JAX ``_gate_log`` line of the same plan (the JAX package under
``VBN_FUSED_SWEEP=always``, its interpret mode on the CPU), its paths
mapped (``JAX_PATHS``); it prints under ``VBN_SWEEP_LOG`` or
``VBN_VERBOSITY>=1`` and not otherwise.

The port has one route for a shape: it reads none of the JAX package's
route switches (``VBN_FUSED_SWEEP``, ``VBN_KDE_PALLAS``,
``VBN_RESAMPLE_PALLAS``, ``VBN_CUMSUM_PALLAS``). Set to their opt-out
values they move no wrapper call and no bit of an answer. The torch route
a kernel stands in for is called directly where it is compared with the
kernel (here and in ``chip_smoke.py``'s phase 29): the torch-op sweep
answers the kernel route's question within Monte-Carlo error.

On the CPU no kernel launches, so the route is read from spies on the
kernel wrappers, which the kernel route calls and the torch route does
not.
"""

import re
import types
from collections import Counter

import networkx as nx
import numpy as np
import pytest
import torch

from benchmarking.data_gen import generate_dataset
from benchmarking.networks import asia
from vectorizedbayesiannetwork_torch import VBN as TVBN
from vectorizedbayesiannetwork_torch.inference import _sweep
from vectorizedbayesiannetwork_torch.ops import sweep as tsweep
from vectorizedbayesiannetwork_tpu import VBN as JVBN
from vectorizedbayesiannetwork_tpu import defaults as jdefaults

SWITCHES = ("VBN_FUSED_SWEEP", "VBN_KDE_PALLAS", "VBN_RESAMPLE_PALLAS",
            "VBN_CUMSUM_PALLAS", "VBN_SWEEP_LOG", "VBN_VERBOSITY")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flagship_data(n=1500, seed=0):
    g = np.random.default_rng(seed)
    x0, x1 = g.normal(size=n), g.normal(size=n)
    x2 = 0.5 * x0 - 0.2 * x1 + 0.1 * g.normal(size=n)
    return {k: v.astype(np.float32).reshape(-1, 1)
            for k, v in (("x0", x0), ("x1", x1), ("x2", x2))}


def _jax_fit(g, conf, data, path):
    jv = JVBN(g, seed=0)
    jv.set_learning_method("node_wise", nodes_cpds=conf)
    jv.fit(data)
    jv.save(str(path))
    return jv, TVBN.load(str(path), device="cpu")


@pytest.fixture(scope="module")
def asia_pair(tmp_path_factory):
    bn = asia()
    data = {k: np.asarray(v, np.float32).reshape(-1, 1)
            for k, v in generate_dataset(bn, 4096, seed=0).items()}
    g = nx.DiGraph()
    g.add_nodes_from(bn.nodes)
    g.add_edges_from(bn.edges())
    conf = {}
    for node in bn.nodes:
        c = dict(jdefaults.cpd("categorical_table"), n_classes=bn.card(node))
        if bn.parents[node]:
            c["parent_n_classes"] = [bn.card(p) for p in bn.parents[node]]
        conf[node] = c
    return _jax_fit(g, conf, data, tmp_path_factory.mktemp("asia") / "a.npz")


@pytest.fixture(scope="module")
def lg_pair(tmp_path_factory):
    g = nx.DiGraph([("x0", "x2"), ("x1", "x2")])
    conf = {k: jdefaults.cpd("linear_gaussian") for k in ("x0", "x1", "x2")}
    return _jax_fit(g, conf, _flagship_data(),
                    tmp_path_factory.mktemp("lg") / "lg.npz")


@pytest.fixture(scope="module")
def kde_vbn():
    from vectorizedbayesiannetwork_torch import defaults

    v = TVBN([("x0", "x2"), ("x1", "x2")], seed=0, device="cpu")
    v.set_learning_method("node_wise", nodes_cpds={
        k: dict(defaults.cpd("kde"), max_points=128) for k in ("x0", "x1", "x2")})
    v.fit(_flagship_data(600))
    return v


ASIA_Q = {"target": "dysp", "evidence": {"smoke": [[1.0], [0.0]],
                                        "asia": [[0.0], [1.0]]}}
LG_Q = {"target": "x0", "evidence": {"x2": [[0.5], [-1.0]]}}
LG_Q_MCM = {"target": "x2", "evidence": {"x0": [[0.5], [-0.3]]}}


def _spy(monkeypatch, calls, module, *names):
    """Count the calls of ``module.<name>`` for each name in ``calls``."""
    for name in names:
        real = getattr(module, name)

        def wrapped(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(module, name, wrapped)


def _at(vbn, call, counter=700):
    vbn._keys.set_state(counter)
    out = call()
    return tuple(np.asarray(t) for t in out) if isinstance(out, tuple) \
        else np.asarray(out)


def _weighted_mean(w, x):
    w = np.asarray(w, np.float64)
    x = np.asarray(x, np.float64)[..., 0]
    wn = w / w.sum(axis=1, keepdims=True)
    mean = (wn * x).sum(axis=1)
    sd = np.sqrt((wn * (x - mean[:, None]) ** 2).sum(axis=1))
    return mean, sd, 1.0 / (wn ** 2).sum(axis=1)


def _close_in_mc_error(a, b):
    """Two weighted posteriors' means a row within 5 combined standard
    errors."""
    ma, sa, ea = _weighted_mean(*a)
    mb, sb, eb = _weighted_mean(*b)
    se = np.sqrt(sa ** 2 / ea + sb ** 2 / eb)
    assert (np.abs(ma - mb) <= 5 * se + 1e-6).all(), (ma, mb, se)


@pytest.fixture(scope="module")
def pairs(asia_pair, lg_pair):
    return {"asia": asia_pair, "lg": lg_pair}


# ---------------------------------------------------------------------------
# The JAX route switches: read by no part of the port
# ---------------------------------------------------------------------------


def _served(vbn, monkeypatch, env, method, kw, q, spies):
    """(answer at key counter 700, the spied wrappers' calls) of one
    served call with ``env`` set."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = Counter()
    for module, names in spies:
        _spy(monkeypatch, calls, module, *names)
    vbn.set_inference_method(method, **kw)
    out = _at(vbn, lambda: vbn.infer_posterior(q))
    monkeypatch.undo()
    return out, calls


# switch -> (model, method, settings, query, the wrappers its kernel
# route calls)
OPT_OUTS = {
    "VBN_FUSED_SWEEP": ("asia", "likelihood_weighting",
                        {"n_samples": 1 << 13}, ASIA_Q,
                        ("sweep", ("categorical_sweep_fused",))),
    "VBN_KDE_PALLAS": ("kde", "likelihood_weighting", {"n_samples": 1 << 12},
                       LG_Q, ("models.kde", ("kde_pick",))),
    "VBN_RESAMPLE_PALLAS": ("lg", "resampled_importance_sampling",
                            {"n_samples": 1 << 12, "ess_threshold": 0.99,
                             "resample_method": "multinomial"}, LG_Q,
                            ("resample_merge", ("srg", "spg"))),
    "VBN_CUMSUM_PALLAS": ("lg", "resampled_importance_sampling",
                          {"n_samples": 1 << 12, "ess_threshold": 0.99,
                           "resample_method": "systematic"}, LG_Q,
                          ("resample_merge", ("srg", "spg"))),
}


@pytest.mark.parametrize("name", sorted(OPT_OUTS))
def test_jax_route_switches_do_not_move_the_port(pairs, kde_vbn, monkeypatch,
                                                 name):
    """A JAX opt-out value (``never``, ``0``) leaves the port's route and
    answer as they are: the same wrapper calls, the same bits."""
    import importlib

    tag, method, kw, q, (mod, names) = OPT_OUTS[name]
    vbn = kde_vbn if tag == "kde" else pairs[tag][1]
    prefix = ("vectorizedbayesiannetwork_torch." if "." in mod
              else "vectorizedbayesiannetwork_torch.ops.")
    spies = [(importlib.import_module(prefix + mod), names)]
    want, calls_want = _served(vbn, monkeypatch, {}, method, kw, q, spies)
    value = "never" if name == "VBN_FUSED_SWEEP" else "0"
    got, calls_got = _served(vbn, monkeypatch, {name: value}, method, kw, q,
                             spies)
    assert sum(calls_want.values()) >= 1 and calls_got == calls_want
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _torch_route(vbn, q, s):
    """The torch-op sweep (``inference/_sweep.py::sweep_trace``) a static
    LW or MCM plan's sweep kernel stands in for, called directly: (pdf [B,
    S], target samples [B, S, 1]) as the served call returns them."""
    from vectorizedbayesiannetwork_torch.core.plan import pack_fixed_values

    m = vbn._inference
    query = vbn._normalize_query(q)
    plan, b = m._plan_and_batch(vbn, query)
    lw = hasattr(m, "_weights_from_logw")
    fixed = torch.as_tensor(pack_fixed_values(query, plan, b, clamp_obs=lw),
                            device=vbn.device)
    cpds, params = m._cpds(vbn, plan), m._params_tuple(vbn, plan)
    t = plan.target_idx
    if lw:
        tv, log_w = _sweep.sweep_trace(plan, cpds, params, vbn.next_key(),
                                       fixed, s, weighted=True, target=t)
        return m._weights_from_logw(log_w, m.normalize)[0], tv
    packed, _ = _sweep.sweep_trace(plan, cpds, params, vbn.next_key(), fixed, s)
    lp = _sweep.target_log_prob(plan, cpds, params, packed)
    return torch.exp(lp), _sweep.node_values(plan, packed, t)


# case -> (model, method, query, the wrapper its kernel route calls)
TORCH_ROUTES = {
    "lw_asia": ("asia", "likelihood_weighting", ASIA_Q,
                "categorical_sweep_fused"),
    "mcm_lg": ("lg", "monte_carlo_marginalization", LG_Q_MCM,
               "lg_sweep_fused"),
}


@pytest.mark.parametrize("case", sorted(TORCH_ROUTES))
def test_torch_route_answers_the_kernel_routes_question(pairs, monkeypatch,
                                                        case):
    """The kernel route (the served call) and the torch-op sweep called
    directly, each from key counter 700: the sweep kernel's wrapper runs
    in the first alone, ``_sweep.ROUTES`` counts the second, and the
    answers agree within Monte-Carlo error."""
    tag, method, q, wrapper = TORCH_ROUTES[case]
    vbn = pairs[tag][1]
    s = 1 << 13
    vbn.set_inference_method(method, n_samples=s)
    calls = Counter()
    _spy(monkeypatch, calls, tsweep, wrapper)
    _sweep.ROUTES.clear()
    kernel = _at(vbn, lambda: vbn.infer_posterior(q))
    assert calls[wrapper] == 1 and not _sweep.ROUTES
    torch_route = _at(vbn, lambda: _torch_route(vbn, q, s))
    assert calls[wrapper] == 1 and sum(_sweep.ROUTES.values()) == 1
    assert torch_route[0].shape == kernel[0].shape
    assert torch_route[1].shape == kernel[1].shape
    assert np.isfinite(torch_route[0]).all()
    if tag == "asia":  # a pmf: the class frequencies
        freq = [[(w * (x[..., 0] == c)).sum(1) / w.sum(1) for c in (0, 1)]
                for w, x in (kernel, torch_route)]
        np.testing.assert_allclose(freq[1], freq[0], atol=0.03)
    else:
        _close_in_mc_error(kernel, torch_route)


# ---------------------------------------------------------------------------
# The gate log
# ---------------------------------------------------------------------------

_LINE = re.compile(r"\[fused-sweep\] target=(\S+) n_nodes=(\d+) "
                   r"n_samples=(\d+) mesh=(.*?) path=(\S+)(?: reason=(.*))?$")


def _gate_lines(text):
    """[(target, n_nodes, n_samples, mesh, path, reason)] of the output."""
    return [_LINE.match(line).groups() for line in text.splitlines()
            if line.startswith("[fused-sweep]")]


def _mapped(lines):
    return [(*f[:4], tsweep.JAX_PATHS[f[4]], f[5]) for f in lines]


# case -> (model, method, settings, query)
GATE_CASES = {
    "categorical": ("asia", "likelihood_weighting", {"n_samples": 2048},
                    ASIA_Q),
    "categorical_refused": ("asia", "likelihood_weighting",
                            {"n_samples": 1000}, ASIA_Q),
    "linear_gaussian": ("lg", "monte_carlo_marginalization",
                        {"n_samples": 2048}, LG_Q_MCM),
    "scan_categorical": ("asia", "likelihood_weighting",
                         {"n_samples": 2048, "dynamic_masks": True}, ASIA_Q),
    "scan_linear_gaussian": ("lg", "likelihood_weighting",
                             {"n_samples": 2048, "dynamic_masks": True},
                             LG_Q),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_gate_line_matches_the_jax_line(pairs, monkeypatch, capsys, case):
    """Under ``VBN_SWEEP_LOG=1`` and ``VBN_FUSED_SWEEP=always`` both
    packages print the same gate lines for the same plan: every field
    equal, the JAX path mapped to the port's."""
    tag, method, kw, q = GATE_CASES[case]
    jv, tv = pairs[tag]
    monkeypatch.setenv("VBN_FUSED_SWEEP", "always")
    monkeypatch.setenv("VBN_SWEEP_LOG", "1")
    capsys.readouterr()
    jv.set_inference_method(method, **kw)
    jv.infer_posterior(q)
    want = _gate_lines(capsys.readouterr().out)
    tv.set_inference_method(method, **kw)
    tv.infer_posterior(q)
    got = _gate_lines(capsys.readouterr().out)
    assert want, "the JAX package printed no gate line"
    assert got == _mapped(want)


def test_gate_line_prints_under_verbosity_and_not_otherwise(pairs, capsys,
                                                            monkeypatch):
    tv = pairs["asia"][1]
    tv.set_inference_method("likelihood_weighting", n_samples=2048)
    capsys.readouterr()
    tv.infer_posterior(ASIA_Q)
    assert "[fused-sweep]" not in capsys.readouterr().out
    monkeypatch.setenv("VBN_VERBOSITY", "0")
    tv.infer_posterior(ASIA_Q)
    assert "[fused-sweep]" not in capsys.readouterr().out
    monkeypatch.setenv("VBN_VERBOSITY", "1")
    tv.infer_posterior(ASIA_Q)
    lines = _gate_lines(capsys.readouterr().out)
    assert lines == [("'dysp'", "8", "2048", "None", "cuda-categorical", None)]


def test_gate_line_mesh_field_matches_the_jax_line(asia_pair, capsys,
                                                   monkeypatch):
    """With a (2, 2) mesh the field reads as the JAX mesh's
    ``dict(mesh.shape)``; a meshed batch that does not split is served
    whole on every rank, and its line says why."""
    import jax

    from vectorizedbayesiannetwork_torch.core.plan import get_plan as tplan
    from vectorizedbayesiannetwork_torch.core.base import Query as TQuery
    from vectorizedbayesiannetwork_tpu.core.base import Query as JQuery
    from vectorizedbayesiannetwork_tpu.core.plan import get_plan as jplan
    from vectorizedbayesiannetwork_tpu.ops.sweep_pallas import (
        make_fused_sweep_fn as jmake,
    )
    from vectorizedbayesiannetwork_tpu.parallel.mesh import make_mesh

    jv, tv = asia_pair
    monkeypatch.setenv("VBN_SWEEP_LOG", "1")
    ev = {"smoke": np.zeros((1, 1), np.float32)}
    jp = jplan(jv, JQuery(target="dysp", evidence=ev))
    tp = tplan(tv, TQuery(target="dysp", evidence=ev))
    capsys.readouterr()
    jmesh = make_mesh(n_data=2, devices=jax.devices()[:4])
    jmake(jp, tuple(jv.cpd_spec(n) for n in jp.topo_order), 4096, mesh=jmesh)
    want = _gate_lines(capsys.readouterr().out)
    tmesh = types.SimpleNamespace(size=lambda i: (2, 2)[i])
    raw = tsweep.make_fused_sweep_fn(
        tp, tuple(tv.cpd_spec(n) for n in tp.topo_order), 4096, mesh=tmesh)
    got = _gate_lines(capsys.readouterr().out)
    assert got == _mapped(want)
    assert got[0][3] == "{'data': 2, 'particle': 2}"
    # B = 3 does not split over 'data': served whole (no collective runs)
    params = tuple(tv.params[n] for n in tp.topo_order)
    fixed = torch.zeros((3, tp.n_nodes))
    raw(params, 5, fixed)
    (line,) = _gate_lines(capsys.readouterr().out)
    assert line[4] == "cuda-categorical"
    assert line[5] == "batch 3 not divisible by data axis 2: served whole"
