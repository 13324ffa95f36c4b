"""The port's sweep kernels' plain versions vs the JAX Pallas kernels.

Both sides get the same fitted model (the JAX model, saved and loaded by
the port) and the same external uniforms, made with numpy from a seed. The
JAX kernels run in interpret mode, as ``tests/test_sweep_pallas.py`` runs
them. Tolerances are the JAX tests' own: categorical target classes exact,
log-weights and target log-densities atol 1e-4; LG targets atol 2e-4 and
log-densities atol 2e-3; pmf and sum-of-weights reductions rtol 2e-4,
moments rtol 2e-3. The CUDA kernels themselves are held against these
plain versions on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from benchmarking.data_gen import generate_dataset
from benchmarking.networks import asia
from conftest import make_chain_df, make_chain_graph
from vectorizedbayesiannetwork_torch import VBN as TVBN
from vectorizedbayesiannetwork_torch.core.base import Query as TQuery
from vectorizedbayesiannetwork_torch.core.plan import get_plan as t_get_plan
from vectorizedbayesiannetwork_torch.core.rng import (
    philox4x32_10,
    philox_uniforms,
)
from vectorizedbayesiannetwork_torch.ops import sweep as tsweep
from vectorizedbayesiannetwork_tpu import VBN as JVBN
from vectorizedbayesiannetwork_tpu import defaults as jdefaults
from vectorizedbayesiannetwork_tpu.core.base import Query as JQuery
from vectorizedbayesiannetwork_tpu.core.plan import get_plan as j_get_plan
from vectorizedbayesiannetwork_tpu.ops import sweep_pallas as jsweep

B, S = 4, 2048


def _sides(jv, tmp_path, query_kw):
    """(jax plan, cpds, params), (port plan, cpds, params) for one query."""
    jv.save(str(tmp_path))
    tv = TVBN.load(str(tmp_path), device="cpu")
    jp = j_get_plan(jv, JQuery(**query_kw))
    tp = t_get_plan(tv, TQuery(**query_kw))
    return (
        (jp, tuple(jv.cpd_spec(n) for n in jp.topo_order),
         tuple(jv.params[n] for n in jp.topo_order)),
        (tp, tuple(tv.cpd_spec(n) for n in tp.topo_order),
         tuple(tv.params[n] for n in tp.topo_order)),
    )


@pytest.fixture(scope="module")
def cat_sides(tmp_path_factory):
    bn = asia()
    data = generate_dataset(bn, 4096, seed=0)
    import networkx as nx

    g = nx.DiGraph()
    g.add_nodes_from(bn.nodes)
    g.add_edges_from(bn.edges())
    jv = JVBN(g, seed=0)
    conf = {}
    for node in bn.nodes:
        c = dict(jdefaults.cpd("categorical_table"), n_classes=bn.card(node))
        if bn.parents[node]:
            c["parent_n_classes"] = [bn.card(p) for p in bn.parents[node]]
        conf[node] = c
    jv.set_learning_method("node_wise", nodes_cpds=conf)
    jv.fit({k: np.asarray(v, np.float32).reshape(-1, 1) for k, v in data.items()})
    q = dict(
        target="dysp",
        evidence={"smoke": np.ones((B, 1), np.float32),
                  "asia": np.zeros((B, 1), np.float32)},
        do={"xray": np.ones((B, 1), np.float32)},
    )
    return _sides(jv, tmp_path_factory.mktemp("cat"), q)


@pytest.fixture(scope="module")
def lg_sides(tmp_path_factory):
    jv = JVBN(make_chain_graph(), seed=0)
    jv.set_learning_method(
        "node_wise",
        nodes_cpds={k: jdefaults.cpd("linear_gaussian") for k in ["x0", "x1", "x2"]},
    )
    jv.fit(make_chain_df())
    q = dict(target="x2", evidence={"x0": np.full((B, 1), 0.5, np.float32)},
             do={})
    return _sides(jv, tmp_path_factory.mktemp("lg"), q)


def test_plan_tuples_match(cat_sides, lg_sides):
    (jp, jc, _), (tp, tc, _) = cat_sides
    assert tsweep.plan_tuple_for(tp, tc) == jsweep.plan_tuple_for(jp, jc)
    (jp, jc, _), (tp, tc, _) = lg_sides
    assert tsweep.lg_plan_tuple_for(tp, tc) == jsweep.lg_plan_tuple_for(jp, jc)


def test_stacked_tables_match(cat_sides, lg_sides):
    (jp, jc, jpar), (tp, tc, tpar) = cat_sides
    _, rows, cmax = jsweep.plan_tuple_for(jp, jc)
    np.testing.assert_array_equal(
        tsweep._stacked_counts(tc, tpar, rows, cmax).numpy(),
        np.asarray(jsweep._stacked_counts(jc, jpar, rows, cmax)),
    )
    (jp, jc, jpar), (tp, tc, tpar) = lg_sides
    _, dmax = jsweep.lg_plan_tuple_for(jp, jc)
    ms = tuple(c.min_scale for c in jc)
    np.testing.assert_allclose(
        tsweep.lg_param_table(tc, tpar, dmax, ms).numpy(),
        np.asarray(jsweep.lg_param_table(jc, jpar, dmax, ms)),
        rtol=1e-7,
    )


def _check_outputs(j_out, t_out, want, *, tgt_exact, tgt_atol, lp_atol, k):
    for label, jo, to in zip(("logw", "tgt", "lpt"), j_out[:3], t_out[:3]):
        assert (jo is None) == (to is None), label
        if jo is None:
            continue
        if label == "tgt" and tgt_exact:
            np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        else:
            atol = tgt_atol if label == "tgt" else lp_atol
            np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=atol)
    assert (j_out[3] is None) == (t_out[3] is None)
    if j_out[3] is None:
        return
    j_sums, j_m = (np.asarray(a) for a in j_out[3])
    t_sums, t_m = (a.numpy() for a in t_out[3])
    np.testing.assert_allclose(t_m, j_m, atol=lp_atol)
    assert t_sums.shape == (B, k)
    np.testing.assert_allclose(t_sums[:, 0], j_sums[:, 0], rtol=2e-4)
    rtol = 2e-4 if want[0].startswith("pmf") else 2e-3
    np.testing.assert_allclose(t_sums, j_sums[:, :k], rtol=rtol)
    assert np.allclose(j_sums[:, k:], 0.0)  # JAX pads to 128 lanes


CAT_WANTS = [("logw", "lpt"), ("logw", "tgt"), ("lpt",), ("pmf_logw",),
             ("pmf_lpt",), ("mom_logw",), ("mom_lpt",)]
LG_WANTS = [("logw", "lpt"), ("logw", "tgt"), ("lpt",), ("mom_logw",),
            ("mom_lpt",)]


@pytest.mark.parametrize("want", CAT_WANTS, ids="-".join)
def test_categorical_plain_matches_pallas(cat_sides, want):
    (jp, jc, jpar), (tp, tc, tpar) = cat_sides
    plan_tuple = jsweep.plan_tuple_for(jp, jc)
    struct, rows, cmax = plan_tuple
    counts = jsweep._stacked_counts(jc, jpar, rows, cmax)
    n = jp.n_nodes
    rng = np.random.default_rng(3)
    u = rng.uniform(1e-6, 1 - 1e-6, size=(B, n, S)).astype(np.float32)
    fixed = np.zeros((B, n), np.int32)
    for i, name in enumerate(jp.topo_order):
        if name in ("smoke", "xray"):
            fixed[:, i] = 1
    j_out = jsweep.categorical_sweep_fused(
        jax.random.PRNGKey(0), jnp.asarray(fixed), counts, struct, S,
        interpret=True, u_ext=jnp.asarray(u), want=want,
    )
    t_out = tsweep.categorical_sweep_fused(
        0, torch.as_tensor(fixed),
        tsweep._stacked_counts(tc, tpar, rows, cmax),
        tsweep.plan_tuple_for(tp, tc)[0], S, u_ext=torch.as_tensor(u),
        want=want,
    )
    k = struct[7][struct[4]] if want[0].startswith("pmf") else 3
    _check_outputs(j_out, t_out, want, tgt_exact=True, tgt_atol=0.0,
                   lp_atol=1e-4, k=k)


@pytest.mark.parametrize("want", LG_WANTS, ids="-".join)
def test_lg_plain_matches_pallas(lg_sides, want):
    (jp, jc, jpar), (tp, tc, tpar) = lg_sides
    struct, dmax = jsweep.lg_plan_tuple_for(jp, jc)
    ms = tuple(c.min_scale for c in jc)
    n = jp.n_nodes
    rng = np.random.default_rng(5)
    u = rng.uniform(1e-6, 1 - 1e-6, size=(B, 2 * n, S)).astype(np.float32)
    fixed = np.zeros((B, n), np.float32)
    for i in range(n):
        if jp.evidence_mask[i]:
            fixed[:, i] = 0.5
    j_out = jsweep.lg_sweep_fused(
        jax.random.PRNGKey(0), jnp.asarray(fixed),
        jsweep.lg_param_table(jc, jpar, dmax, ms), struct, dmax, S,
        interpret=True, u_ext=jnp.asarray(u), want=want,
    )
    t_out = tsweep.lg_sweep_fused(
        0, torch.as_tensor(fixed), tsweep.lg_param_table(tc, tpar, dmax, ms),
        struct, dmax, S, u_ext=torch.as_tensor(u), want=want,
    )
    _check_outputs(j_out, t_out, want, tgt_exact=False, tgt_atol=2e-4,
                   lp_atol=2e-3, k=3)


KAT = [  # Random123's known-answer vectors for Philox-4x32-10
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,expect", KAT)
def test_philox_known_answers(ctr, key, expect):
    words = [torch.tensor([c], dtype=torch.int64) for c in ctr]
    out = philox4x32_10(*words, key[0] | (key[1] << 32))
    assert tuple(int(o) for o in out) == expect


def test_philox_uniforms_layout_and_range():
    u = philox_uniforms(123, 3, 4, 2048, 2, "cpu")
    assert u.shape == (3, 8, 2048) and u.dtype == torch.float32
    assert float(u.min()) > 0.0 and float(u.max()) <= 1.0
    # row 2i + w is output word w of node i, at counter (s, b, i, 0)
    b, i, s = 2, 3, 77
    words = philox4x32_10(
        *(torch.tensor([v], dtype=torch.int64) for v in (s, b, i, 0)), 123
    )
    for w in range(2):
        expect = ((int(words[w]) >> 8) + 0.5) / (1 << 24)
        assert float(u[b, 2 * i + w, s]) == pytest.approx(expect, abs=0)
    # the statistic the samplers rely on: uniform on (0, 1]
    assert abs(float(u.mean()) - 0.5) < 0.01
    assert abs(float(u.var()) - 1.0 / 12.0) < 0.005
    # row0 rebuilds a slice of a larger batch's draws
    assert torch.equal(philox_uniforms(123, 2, 4, 2048, 2, "cpu", row0=1),
                       u[1:3])


def test_in_kernel_random_mode_is_philox(cat_sides):
    """Without u_ext the plain versions draw philox_uniforms(seed): the
    same stream the CUDA kernels generate in-kernel."""
    _, (tp, tc, tpar) = cat_sides
    plan_tuple = tsweep.plan_tuple_for(tp, tc)
    struct, rows, cmax = plan_tuple
    counts = tsweep._stacked_counts(tc, tpar, rows, cmax)
    fixed = torch.zeros((B, tp.n_nodes), dtype=torch.int32)
    a = tsweep.categorical_sweep_plain(9, fixed, counts, struct, S,
                                       want=("logw", "tgt"))
    u = philox_uniforms(9, B, tp.n_nodes, S, 1, "cpu")
    b = tsweep.categorical_sweep_plain(9, fixed, counts, struct, S, u_ext=u,
                                       want=("logw", "tgt"))
    assert torch.equal(a[1], b[1]) and torch.equal(a[0], b[0])


def test_gates_match_jax(cat_sides, lg_sides):
    for (jp, jc, _), (tp, tc, _) in (cat_sides, lg_sides):
        for s in (2048, 1000, 1 << 20):
            assert tsweep.categorical_sweep_reason(tp, tc, s) == \
                jsweep.categorical_sweep_reason(jp, jc, s)
            assert tsweep.lg_sweep_reason(tp, tc, s) == \
                jsweep.lg_sweep_reason(jp, jc, s)
    (jp, jc, _), (tp, tc, _) = lg_sides
    assert tsweep.make_fused_sweep_fn(tp, tc, 2048, ("pmf_lpt",)) is None
    assert tsweep.make_fused_sweep_fn(tp, tc, 2048, ("mom_lpt",)) is not None
    assert tsweep.make_fused_sweep_fn(tp, tc, 1000, ("mom_lpt",)) is None


def test_kernel_launch_rejects_cpu_inputs():
    """The launch path never runs the plain version: a CPU tensor is
    refused rather than quietly computed."""
    with pytest.raises(ValueError, match="CUDA"):
        tsweep._check(torch.zeros(2, 2), "x", torch.float32, (2, 2))

