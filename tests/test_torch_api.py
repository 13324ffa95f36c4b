"""The port's public API beyond the serving paths, against the JAX package.

``VBN.infer_relative`` (exact engines within 1e-5 of the JAX package's on
one checkpoint, LW within Monte-Carlo error), ``_broadcast_batch``,
``to_device`` and ``load(map_location=)``, the config catalog
``VBN.config`` and ``ConfigItem`` in the setters, ``core/cache.py``, the
``core/utils`` helpers and ``utils`` re-exports, ``utils.interventions``,
``utils.profiling``, ``display``, the DAG placeholders and the exports.
Everything runs on the CPU; the card's cases are in
``tests/test_torch_cuda.py``.
"""

import os
import subprocess
import sys
from pathlib import Path

import networkx as nx
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from benchmarking.data_gen import generate_dataset
from benchmarking.networks import asia
import vectorizedbayesiannetwork_torch as tpkg
from vectorizedbayesiannetwork_torch import VBN as TVBN
from vectorizedbayesiannetwork_torch import defaults as tdefaults
from vectorizedbayesiannetwork_torch.core import cache as tcache
from vectorizedbayesiannetwork_torch.core import utils as tutils
from vectorizedbayesiannetwork_torch.core.base import Query as TQuery
from vectorizedbayesiannetwork_torch.core.rng import fold
from vectorizedbayesiannetwork_torch.utils import interventions as tint
from vectorizedbayesiannetwork_torch.utils import profiling as tprof
from vectorizedbayesiannetwork_torch.vbn import ConfigItem
import vectorizedbayesiannetwork_tpu as jpkg
from vectorizedbayesiannetwork_tpu import VBN as JVBN
from vectorizedbayesiannetwork_tpu import defaults as jdefaults
from vectorizedbayesiannetwork_tpu.core import utils as jutils
from vectorizedbayesiannetwork_tpu.core.base import Query as JQuery
from vectorizedbayesiannetwork_tpu.utils import interventions as jint
from vectorizedbayesiannetwork_tpu.vbn import _load_configs as j_load_configs

ROOT = Path(__file__).resolve().parents[1]


def _flagship_rows(n=4096, seed=0):
    g = np.random.default_rng(seed)
    x0, x1 = g.normal(size=n), g.normal(size=n)
    x2 = 0.5 * x0 - 0.2 * x1 + 0.1 * g.normal(size=n)
    return {k: v.astype(np.float32).reshape(-1, 1)
            for k, v in (("x0", x0), ("x1", x1), ("x2", x2))}


def _asia_conf(bn, defaults):
    conf = {}
    for node in bn.nodes:
        c = dict(defaults.cpd("categorical_table"), n_classes=bn.card(node))
        if bn.parents[node]:
            c["parent_n_classes"] = [bn.card(p) for p in bn.parents[node]]
        conf[node] = c
    return conf


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The JAX package's fits of the flagship (LG) and asia, and the
    port's loads of their checkpoints."""
    root = tmp_path_factory.mktemp("api")
    jf = JVBN(nx.DiGraph([("x0", "x2"), ("x1", "x2")]), seed=0)
    jf.set_learning_method("node_wise", nodes_cpds={
        k: jdefaults.cpd("linear_gaussian") for k in ("x0", "x1", "x2")})
    jf.fit(_flagship_rows())
    jf.save(str(root / "flag"))
    bn = asia()
    g = nx.DiGraph()
    g.add_nodes_from(bn.nodes)
    g.add_edges_from(bn.edges())
    ja = JVBN(g, seed=0)
    ja.set_learning_method("node_wise", nodes_cpds=_asia_conf(bn, jdefaults))
    ja.fit({k: np.asarray(v, np.float32).reshape(-1, 1)
            for k, v in generate_dataset(bn, 4096, seed=0).items()})
    ja.save(str(root / "asia"))
    return {
        "flag": (jf, TVBN.load(str(root / "flag"), device="cpu")),
        "asia": (ja, TVBN.load(str(root / "asia"), device="cpu")),
        "root": root,
    }


def _col(*vals):
    return np.asarray(vals, np.float32).reshape(-1, 1)


def _flat(res):
    """infer_relative's nested result as {key: float64 array}."""
    out = {}
    for k, v in res.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                out[f"{k}.{kk}"] = np.asarray(
                    vv.numpy() if isinstance(vv, torch.Tensor) else vv,
                    np.float64)
        elif k != "target":
            out[k] = np.asarray(
                v.numpy() if isinstance(v, torch.Tensor) else v, np.float64)
    return out


RELATIVE_KEYS = {
    "query_stats.mean", "query_stats.std",
    "query_stats.effective_sample_size", "reference_stats.mean",
    "reference_stats.std", "reference_stats.effective_sample_size",
    "delta_mean", "delta_std", "relative_mean_change", "relative_std_change",
}


@pytest.mark.parametrize("case", ["gaussian_exact", "categorical_exact"])
def test_infer_relative_matches_jax_on_exact_engines(models, case):
    if case == "gaussian_exact":
        jv, tv = models["flag"]
        q = {"target": "x2", "evidence": {"x0": _col(0.3, -1.0, 0.8),
                                          "x1": _col(-0.2, 0.5, 0.0)}}
        ref = {"target": "x2", "evidence": {"x0": _col(0.0), "x1": _col(0.0)}}
        kw = {"n_samples": 64}
    else:
        jv, tv = models["asia"]
        q = {"target": "dysp", "evidence": {"smoke": _col(1, 0),
                                            "asia": _col(0, 1)}}
        ref = None
        kw = {}
    jv.set_inference_method(case, **kw)
    tv.set_inference_method(case, **kw)
    got = tv.infer_relative(q, ref)
    want = jv.infer_relative(q, ref)
    assert got["target"] == want["target"] == q["target"]
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w) == RELATIVE_KEYS
    for k in RELATIVE_KEYS:
        assert g[k].shape == w[k].shape, k
        np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_infer_relative_lw_within_monte_carlo_error(models):
    """LW at S = 2^14 on both packages: x2 | x0, x1 against no evidence.
    The sd of a mean is about sigma / sqrt(ESS) < 0.01 here."""
    jv, tv = models["flag"]
    q = {"target": "x2", "evidence": {"x0": _col(0.5, -0.5),
                                      "x1": _col(0.3, 0.1)}}
    for v in (jv, tv):
        v.set_inference_method("likelihood_weighting", n_samples=1 << 14)
    g, w = _flat(tv.infer_relative(q)), _flat(jv.infer_relative(q))
    for k in ("delta_mean", "delta_std", "query_stats.mean",
              "reference_stats.mean", "reference_stats.std"):
        np.testing.assert_allclose(g[k], w[k], atol=0.03, err_msg=k)
    assert g["reference_stats.effective_sample_size"].shape == (2,)


def test_infer_relative_errors(models):
    _jv, tv = models["flag"]
    tv.set_inference_method("likelihood_weighting", n_samples=256)
    with pytest.raises(ValueError, match="same target"):
        tv.infer_relative({"target": "x2", "evidence": {"x0": _col(0.1)}},
                          {"target": "x1", "evidence": {}})
    with pytest.raises(ValueError, match="unless one is 1"):
        tv.infer_relative({"target": "x2", "evidence": {"x0": _col(0.1, 0.2)}},
                          {"target": "x2",
                           "evidence": {"x0": _col(0.1, 0.2, 0.3)}})


def test_broadcast_batch():
    a, b = torch.ones(1, 2), torch.zeros(3, 2)
    x, y = TVBN._broadcast_batch(a, b)
    assert x.shape == y.shape == (3, 2)
    y2, x2 = TVBN._broadcast_batch(b, a)
    assert x2.shape == (3, 2) and torch.equal(y2, b)
    same = TVBN._broadcast_batch(b, b)
    assert same[0] is b and same[1] is b
    with pytest.raises(ValueError):
        TVBN._broadcast_batch(torch.ones(2, 1), torch.ones(3, 1))
    ja, jb = JVBN._broadcast_batch(jnp.ones((1, 2)), jnp.zeros((3, 2)))
    assert tuple(ja.shape) == tuple(x.shape)


# ---------------------------------------------------------------------------
# Devices
# ---------------------------------------------------------------------------


def test_to_device_cpu_keeps_the_rows(models):
    """A moved model at the same key counter serves the same rows bit for
    bit, and its method's built-function cache is emptied."""
    root = models["root"]
    a = TVBN.load(str(root / "asia"), device="cpu")
    b = TVBN.load(str(root / "asia"), map_location="cpu")
    q = {"target": "dysp", "evidence": {"smoke": _col(1, 0)}}
    for v in (a, b):
        v.set_inference_method("likelihood_weighting", n_samples=3000)
    b.infer_posterior(q)  # fills the caches, advances the stream
    b._keys.set_state(a._keys.state())
    b.to_device("cpu")
    assert b.device == torch.device("cpu") and b._keys.device == b.device
    assert not b._plan_cache
    wa, sa = a.infer_posterior(q)
    wb, sb = b.infer_posterior(q)
    assert torch.equal(wa, wb) and torch.equal(sa, sb)
    assert a._keys.state() == b._keys.state()


def test_to_device_moves_every_tensor(models):
    """On the meta device (no card needed) every tensor the model keeps
    has moved: params, the amortized net, a method's last ESS, the
    stream's device, and the counter is kept."""
    _jv, tv = models["flag"]
    v = TVBN.load(str(models["root"] / "flag"), device="cpu")
    v.set_inference_method("likelihood_weighting", n_samples=256)
    v.infer_posterior({"target": "x0", "evidence": {"x2": _col(0.1)}})
    v.amortized = {"spec": None, "net": {"w": [torch.ones(2, 2)]}}
    assert isinstance(v._inference._last_ess, torch.Tensor)
    counter = v._keys.state()
    v.to_device("meta")
    dev = torch.device("meta")
    leaves = [t for p in v.params.values() for t in p.values()]
    assert leaves and all(t.device == dev for t in leaves)
    assert v.amortized["net"]["w"][0].device == dev
    assert v._inference._last_ess.device == dev
    assert v.device == dev and v._keys.device == dev
    assert v._keys.state() == counter


def test_load_device_and_map_location_rules(models):
    path = str(models["root"] / "flag")
    assert TVBN.load(path, map_location="cpu").device == torch.device("cpu")
    assert TVBN.load(path, map_location=torch.device("cpu"),
                     device="cpu").device == torch.device("cpu")
    with pytest.raises(ValueError, match="different devices"):
        TVBN.load(path, device="cpu", map_location="cuda")
    with pytest.raises(TypeError):
        TVBN.load(path, map_location={"cuda:0": "cpu"})
    if not torch.cuda.is_available():  # neither keyword: the card
        with pytest.raises(RuntimeError, match="CUDA"):
            TVBN.load(path)


def test_root_key_and_next_key_spec():
    v = TVBN([("a", "b")], seed=7, device="cpu")
    w = TVBN([("a", "b")], seed=7, device="cpu")
    root, counter = v.next_key_spec()
    assert counter == 0 and v._keys.state() == 1
    assert fold(root, counter).seed == w.next_key().seed
    assert v.root_key.seed == root.seed == 7
    assert fold(v.root_key, 1).seed == w.next_key().seed


# ---------------------------------------------------------------------------
# The config catalog
# ---------------------------------------------------------------------------


def _numbers(x):
    """PyYAML leaves '1e-3' a string: the JAX catalog with such strings
    read as the floats the port's catalog holds."""
    if isinstance(x, dict):
        return {k: _numbers(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_numbers(v) for v in x]
    if isinstance(x, str):
        try:
            return float(x)
        except ValueError:
            return x
    return x


JAX_CATALOG = j_load_configs()
CATALOG_ITEMS = [(c, s) for c, level in JAX_CATALOG.items() for s in level]


@pytest.mark.parametrize("category,stem", CATALOG_ITEMS)
def test_config_catalog_matches_jax(category, stem):
    tv = TVBN([("a", "b")], seed=0, device="cpu")
    ours, theirs = tv.config[category][stem], JAX_CATALOG[category][stem]
    if not hasattr(dict, category):  # config.update is dict.update, as in JAX
        assert getattr(tv.config, category)[stem] is ours
        assert getattr(getattr(tv.config, category), stem) is ours
    assert ours.name == theirs.name and ours.kind == theirs.kind
    assert ours.to_dict() == _numbers(theirs.to_dict())
    assert ours.as_dict() == ours.to_dict()
    d = ours.to_dict()
    d.setdefault("fit", {})["epochs"] = -1  # a fresh dict each call
    assert ours.to_dict() != d


def test_config_catalog_has_every_stem():
    tv = TVBN([("a", "b")], seed=0, device="cpu")
    assert {c: set(l) for c, l in tv.config.items()} == {
        c: set(l) for c, l in JAX_CATALOG.items()}


def test_setters_take_config_items():
    tv = TVBN([("x0", "x2"), ("x1", "x2")], seed=0, device="cpu")
    cfg = tv.config
    tv.set_inference_method(cfg.inference.likelihood_weighting, n_samples=128)
    assert tv._inference_config == {"name": "likelihood_weighting", "params": {
        "n_samples": 128, "eps": 1e-12, "normalize": True}}
    tv.set_sampling_method(cfg.sampling.gibbs)
    assert tv._sampling_config["name"] == "gibbs"
    tv.set_learning_method(cfg.learning.node_wise, nodes_cpds={
        "x0": cfg.cpds.linear_gaussian, "x1": "linear_gaussian",
        "x2": tdefaults.cpd("linear_gaussian")})
    nc = tv._learning_config["nodes_cpds"]
    assert nc["x0"] == nc["x1"] == nc["x2"] == tdefaults.cpd("linear_gaussian")
    with pytest.raises(ValueError, match="Unknown"):
        tv.set_inference_method(ConfigItem("nope", {}, "inference"))
    with pytest.raises(TypeError, match="ConfigItem"):
        tv.set_inference_method(3)
    with pytest.raises(TypeError, match="ConfigItem"):
        tv.set_learning_method("node_wise", nodes_cpds={"x0": 3})


def test_fit_with_config_items_equals_fit_with_dicts():
    rows = _flagship_rows(2048, seed=1)
    fits = []
    for use_items in (True, False):
        tv = TVBN([("x0", "x2"), ("x1", "x2")], seed=0, device="cpu")
        cpd = (tv.config.cpds.linear_gaussian if use_items
               else tdefaults.cpd("linear_gaussian"))
        learn = tv.config.learning.node_wise if use_items else "node_wise"
        tv.set_learning_method(learn, nodes_cpds={k: cpd for k in rows})
        tv.fit(rows)
        fits.append(tv)
    for node in rows:
        for k, t in fits[0].params[node].items():
            assert torch.equal(t, fits[1].params[node][k]), (node, k)
    a, b = fits[0]._learning_config, fits[1]._learning_config
    assert a["name"] == b["name"] and a["nodes_cpds"] == b["nodes_cpds"]
    assert a["params"] == {"default_cpd": "gaussian_nn"}  # the item's own


# ---------------------------------------------------------------------------
# The kernels' build cache
# ---------------------------------------------------------------------------


def test_cache_default_is_build_kernels(monkeypatch):
    monkeypatch.delenv("VBN_COMPILATION_CACHE", raising=False)
    assert tcache.enable_compilation_cache() == str(
        ROOT / "build" / "kernels")
    from vectorizedbayesiannetwork_torch.ops import _build

    assert _build.BUILD_DIR == tcache.DEFAULT_DIR == ROOT / "build" / "kernels"


def test_cache_env_override(monkeypatch, tmp_path):
    monkeypatch.setenv("VBN_COMPILATION_CACHE", str(tmp_path / "kc"))
    assert tcache.enable_compilation_cache() == str(tmp_path / "kc")


@pytest.mark.parametrize("value", ["0", "off", "none", "false", "", "OFF"])
def test_cache_disable_values(monkeypatch, value):
    monkeypatch.setenv("VBN_COMPILATION_CACHE", value)
    assert tcache.enable_compilation_cache() is None


def _run(code, env_value):
    env = {k: v for k, v in os.environ.items()
           if k != "VBN_COMPILATION_CACHE"}
    if env_value is not None:
        env["VBN_COMPILATION_CACHE"] = env_value
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()


def test_cache_is_read_at_first_build_not_at_import(tmp_path):
    """Import resolves nothing; the first library path resolves the
    directory once (an override here), and later changes of the variable
    do not move it; the library keeps its hash-keyed name."""
    code = (
        "import os, vectorizedbayesiannetwork_torch\n"
        "from vectorizedbayesiannetwork_torch.core import cache\n"
        "from vectorizedbayesiannetwork_torch.ops import _build\n"
        "print(cache._DIR)\n"
        "p = _build.library_path('sweep')\n"
        "os.environ['VBN_COMPILATION_CACHE'] = '0'\n"
        "print(p.parent, p.name.startswith('libsweep-'))\n"
        "print(_build.library_path('kde').parent)\n"
    )
    lines = _run(code, str(tmp_path / "kc"))
    assert lines == ["None", f"{tmp_path / 'kc'} True", str(tmp_path / "kc")]


def test_cache_disabled_builds_in_a_fresh_directory():
    code = (
        "from vectorizedbayesiannetwork_torch.core import cache\n"
        "d = cache.kernel_build_dir()\n"
        "print(d, d.is_dir())\n"
    )
    first = _run(code, "0")[0].split()
    second = _run(code, "off")[0].split()
    for d, exists in (first, second):
        assert exists == "True"
        assert Path(d).parent == ROOT / "build"
        assert Path(d).name.startswith("kernels-")
        assert not Path(d).exists()  # removed when its process exited
    assert first[0] != second[0]


# ---------------------------------------------------------------------------
# utils, display, placeholders, exports
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("x", [3.0, [1.0, 2.0], [[1.0, 2.0], [3.0, 4.0]]])
def test_core_utils_helpers_match_jax(x):
    np.testing.assert_array_equal(tutils.as_array(x).numpy(),
                                  np.asarray(jutils.as_array(x)))
    np.testing.assert_array_equal(tutils.ensure_2d(x).numpy(),
                                  np.asarray(jutils.ensure_2d(x)))
    m = np.arange(6, dtype=np.float32).reshape(2, 3)
    np.testing.assert_array_equal(
        tutils.broadcast_samples(torch.from_numpy(m), 4).numpy(),
        np.asarray(jutils.broadcast_samples(jnp.asarray(m), 4)))
    t3 = np.arange(24, dtype=np.float32).reshape(2, 4, 3)
    tf, tb, ts = tutils.flatten_samples(torch.from_numpy(t3))
    jf, jb, js = jutils.flatten_samples(jnp.asarray(t3))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert (tb, ts) == (jb, js) == (2, 4)
    np.testing.assert_array_equal(
        tutils.unflatten_samples(tf, tb, ts).numpy(),
        np.asarray(jutils.unflatten_samples(jf, jb, js)))


def test_core_utils_helper_errors_and_dtypes():
    with pytest.raises(ValueError):
        tutils.ensure_2d(np.zeros((1, 1, 1)))
    with pytest.raises(ValueError):
        tutils.broadcast_samples(torch.zeros(3), 2)
    t = torch.arange(3)
    assert tutils.as_array(t).dtype == torch.float32
    assert tutils.as_array(t, torch.int64) is not None
    assert tutils.ensure_2d(t).shape == (3, 1)


def test_utils_reexports_what_jax_does():
    import vectorizedbayesiannetwork_torch.utils as tu
    import vectorizedbayesiannetwork_tpu.utils as ju

    names = {n for n in dir(ju) if not n.startswith("_")
             and callable(getattr(ju, n))}
    assert names <= set(dir(tu))


@pytest.mark.parametrize("query", [
    dict(target="c", evidence={"a": np.ones((1, 1))}, do={}),
    dict(target="c", evidence={}, do={"b": np.zeros((1, 1))}),
    dict(target="c", evidence={"a": np.ones((1, 1))},
         do={"b": np.full((1, 1), 2.0)}),
])
def test_interventions_match_jax(query):
    tq, jq = TQuery(**query), JQuery(**query)
    for node in ("a", "b", "c"):
        assert tint.is_intervened(node, tq) == jint.is_intervened(node, jq)
        assert tint.is_observed(node, tq) == jint.is_observed(node, jq)
        tv, jv = tint.get_fixed_value(node, tq), jint.get_fixed_value(node, jq)
        assert (tv is None) == (jv is None)
        if tv is not None:
            np.testing.assert_array_equal(np.asarray(tv), np.asarray(jv))
        assert (tint.effective_parents(node, ("p", "q"), tq)
                == jint.effective_parents(node, ("p", "q"), jq))


def test_stage_timer_and_timed_call():
    timer = tprof.StageTimer()
    for _ in range(3):
        with timer.stage("a"):
            pass
    with timer.stage("b"):
        pass
    s = timer.summary()
    assert s["a"]["calls"] == 3 and s["b"]["calls"] == 1
    assert s["a"]["mean_ms"] == pytest.approx(s["a"]["total_ms"] / 3)
    out, ms = tprof.timed_call(lambda x: {"y": [x * 2]}, torch.ones(3))
    assert torch.equal(out["y"][0], torch.full((3,), 2.0)) and ms >= 0.0


def test_trace_and_annotate(tmp_path):
    with tprof.trace(str(tmp_path)) as prof:
        with tprof.annotate("vbn_span"):
            torch.ones(64).sum()
    assert (tmp_path / "trace.json").exists()
    assert any(e.key == "vbn_span" for e in prof.key_averages())


def test_device_logging_once(monkeypatch, capsys):
    from vectorizedbayesiannetwork_torch.utils import device_logging

    monkeypatch.delenv("VBN_LOGGED_DEVICE", raising=False)
    want = "cpu" if not torch.cuda.is_available() else "cuda ["
    assert device_logging.get_device_string().startswith(want)
    device_logging.log_device()
    device_logging.log_device()
    assert capsys.readouterr().out.count("[vbn-torch] devices:") == 1


def _display_inputs(models):
    _jv, tv = models["flag"]
    g = torch.Generator().manual_seed(0)
    pdf = torch.rand((2, 64), generator=g)
    samples = torch.randn((2, 64, 1), generator=g)
    return tv.cpd("x2"), pdf, samples


def test_display_is_a_no_op_under_skip_plots(models, monkeypatch):
    from vectorizedbayesiannetwork_torch import display

    monkeypatch.setenv("VBN_SKIP_PLOTS", "1")
    handle, pdf, samples = _display_inputs(models)
    assert not display.plots_enabled()
    assert display.plot_cpd_fit(handle, [[0.1, 0.2]]) is None
    assert display.plot_inference_posterior(pdf, samples, "x2") is None
    assert display.plot_sampling_outcome(samples, "x2") is None


def test_display_draws_with_agg(models, monkeypatch, tmp_path):
    pytest.importorskip("matplotlib")
    from vectorizedbayesiannetwork_torch import display

    monkeypatch.setenv("VBN_SKIP_PLOTS", "0")
    handle, pdf, samples = _display_inputs(models)
    figs = [
        display.plot_cpd_fit(handle, torch.tensor([[0.1, 0.2], [1.0, -1.0]]),
                             n_samples=64, save_path=str(tmp_path / "a.png")),
        display.plot_inference_posterior(pdf, samples, "x2"),
        display.plot_sampling_outcome(samples, "x2"),
    ]
    import matplotlib

    assert matplotlib.get_backend().lower() == "agg"
    assert all(f is not None and hasattr(f, "savefig") for f in figs)
    assert len(figs[0].axes) == 2 and (tmp_path / "a.png").exists()


@pytest.mark.parametrize("name", ["TemporalDAG", "DynamicDAG"])
def test_dag_placeholders_raise(name):
    with pytest.raises(NotImplementedError):
        getattr(tpkg, name)()


def test_exports_match_jax():
    assert set(jpkg.__all__) <= set(tpkg.__all__)
    for name in tpkg.__all__:
        assert hasattr(tpkg, name), name
    assert tpkg.SAMPLING_REGISTRY.keys() >= {"ancestral", "gibbs", "hmc", "nuts"}
    assert tpkg.UPDATE_REGISTRY.keys() >= {"ema", "online_sgd",
                                           "replay_buffer", "streaming_stats"}


def test_no_forbidden_imports():
    """Importing the port, utils and display loads no jax, yaml,
    networkx, pandas or matplotlib."""
    code = (
        "import sys, vectorizedbayesiannetwork_torch\n"
        "import vectorizedbayesiannetwork_torch.utils\n"
        "import vectorizedbayesiannetwork_torch.display\n"
        "bad = ('jax', 'yaml', 'networkx', 'pandas', 'matplotlib', "
        "'vectorizedbayesiannetwork_tpu')\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in bad))\n"
    )
    assert _run(code, None) == ["[]"]
