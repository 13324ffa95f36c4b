"""The port's scan sweeps (ops/sweep_scan.py) against the JAX scan kernels.

Both sides get the same fitted model (the JAX fit, saved and loaded by the
port) and the same external uniforms, made with numpy from a seed; the JAX
kernels run in interpret mode, as ``tests/test_sweep_scan_pallas.py`` runs
them. Tolerances are the JAX tests' own: categorical target classes exact,
log-weights and target log-densities atol 1e-4, pmf reductions rtol 2e-4;
LG targets atol 2e-4, log-densities atol 2e-3, moments rtol 2e-3. The CUDA
kernels are held against these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import types

import networkx as nx
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from benchmarking.bif import DiscreteBN
from benchmarking.data_gen import generate_dataset
from benchmarking.gaussian_bn import random_gaussian
from benchmarking.networks import asia, random_bn
from vectorizedbayesiannetwork_torch import VBN as TVBN
from vectorizedbayesiannetwork_torch import defaults as tdefaults
from vectorizedbayesiannetwork_torch.core.base import Query as TQuery
from vectorizedbayesiannetwork_torch.core.plan import get_plan as t_get_plan
from vectorizedbayesiannetwork_torch.core.rng import philox_uniforms
from vectorizedbayesiannetwork_torch.ops import sweep as tsweep
from vectorizedbayesiannetwork_torch.ops import sweep_scan as tscan
from vectorizedbayesiannetwork_tpu import VBN as JVBN
from vectorizedbayesiannetwork_tpu import defaults as jdefaults
from vectorizedbayesiannetwork_tpu.core.base import Query as JQuery
from vectorizedbayesiannetwork_tpu.core.plan import get_plan as j_get_plan
from vectorizedbayesiannetwork_tpu.ops import sweep_scan_pallas as jscan

B, S = 4, 2048
# Each mode compiles its own interpret-mode kernel on the JAX side, so the
# CPU tests take the streams and one reduction of each kind and source;
# every mode runs against the CUDA kernels on the card (test_torch_cuda.py).
CAT_WANTS = [("logw", "tgt", "lpt"), ("pmf_logw",), ("mom_lpt",)]
LG_WANTS = [("logw", "tgt", "lpt"), ("mom_logw",)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread here: the suite runs several test processes at
    once, and the plain versions' small ops gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_discrete(bn, seed=0, rows=4096):
    data = generate_dataset(bn, rows, seed=seed)
    g = nx.DiGraph()
    g.add_nodes_from(bn.nodes)
    g.add_edges_from(bn.edges())
    jv = JVBN(g, seed=seed)
    conf = {}
    for node in bn.nodes:
        c = dict(jdefaults.cpd("categorical_table"), n_classes=bn.card(node))
        if bn.parents[node]:
            c["parent_n_classes"] = [bn.card(p) for p in bn.parents[node]]
        conf[node] = c
    jv.set_learning_method("node_wise", nodes_cpds=conf)
    jv.fit({k: np.asarray(v, np.float32).reshape(-1, 1) for k, v in data.items()})
    return jv


def _jax_gaussian(gbn):
    g = nx.DiGraph()
    g.add_nodes_from(gbn.nodes)
    g.add_edges_from(gbn.edges())
    jv = JVBN(g, seed=0)
    jv.set_learning_method(
        "node_wise",
        nodes_cpds={n: jdefaults.cpd("linear_gaussian") for n in gbn.nodes})
    jv.fit({k: v.reshape(-1, 1) for k, v in gbn.sample(4096, seed=0).items()})
    return jv


def _sides(jv, tmp_path, **query):
    """(jax plan, cpds, params), (port plan, cpds, params) of one query,
    by default the canonical (empty) one of the dynamic path."""
    jv.save(str(tmp_path))
    tv = TVBN.load(str(tmp_path), device="cpu")
    if not query:
        query = dict(target=tuple(jv.dag.topological_order())[0],
                     evidence={}, do={})
    jp = j_get_plan(jv, JQuery(**query))
    tp = t_get_plan(tv, TQuery(**query))
    return (
        (jp, tuple(jv.cpd_spec(n) for n in jp.topo_order),
         tuple(jv.params[n] for n in jp.topo_order)),
        (tp, tuple(tv.cpd_spec(n) for n in tp.topo_order),
         tuple(tv.params[n] for n in tp.topo_order)),
    )


@pytest.fixture(scope="module")
def random24(tmp_path_factory):
    jv = _jax_discrete(random_bn(n_nodes=24, max_card=4, seed=7), seed=1)
    return _sides(jv, tmp_path_factory.mktemp("r24"))


@pytest.fixture(scope="module")
def highcard(tmp_path_factory):
    """Up to 80 classes: past the unrolled kernel's 32 and the JAX scan
    kernel's static class unroll (cmax > 8 takes its fori walk)."""
    bn = random_bn(n_nodes=6, max_card=80, max_indegree=1, seed=0)
    return bn, _sides(_jax_discrete(bn, seed=3), tmp_path_factory.mktemp("hc"))


@pytest.fixture(scope="module")
def gauss9(tmp_path_factory):
    return _sides(_jax_gaussian(random_gaussian(9, seed=0)),
                  tmp_path_factory.mktemp("g9"))


def _hetero(n, cards, b, seed):
    """Per-row targets, two evidence nodes and one do node, packed."""
    rng = np.random.default_rng(seed)
    packed = np.zeros((b, n), np.int32)
    tgt = np.zeros((b,), np.int32)
    for r in range(b):
        picks = rng.choice(n, size=4, replace=False)
        tgt[r] = picks[0]
        for i, bit in ((picks[1], 1 << 16), (picks[2], 1 << 16),
                       (picks[3], 1 << 17)):
            packed[r, i] = int(rng.integers(0, cards[i])) | bit
    return packed, tgt


def _check(j_out, t_out, want, *, tgt_exact, tgt_atol, lp_atol):
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
    k = t_sums.shape[1]
    rtol = 2e-4 if want[0].startswith("pmf") else 2e-3
    np.testing.assert_allclose(t_sums, j_sums[:, :k], rtol=rtol, atol=1e-6)
    assert np.allclose(j_sums[:, k:], 0.0)  # JAX pads to 128 lanes


def _run_cat(sides, packed, tgt, want, seed):
    (jp, jc, jpar), (tp, tc, tpar) = sides
    struct = jscan.scan_struct_for(jp, jc)
    u = np.random.default_rng(seed).uniform(
        1e-6, 1 - 1e-6, size=(packed.shape[0], jp.n_nodes, S)
    ).astype(np.float32)
    j_out = jscan.categorical_sweep_scan(
        jax.random.PRNGKey(0), jnp.asarray(packed), jnp.asarray(tgt),
        jscan._flat_counts(jc, jpar), struct, S, interpret=True,
        u_ext=jnp.asarray(u), want=want,
    )
    t_out = tscan.categorical_sweep_scan(
        0, torch.as_tensor(packed), torch.as_tensor(tgt),
        tscan._flat_counts(tc, tpar), tscan.scan_struct_for(tp, tc), S,
        u_ext=torch.as_tensor(u), want=want,
    )
    return j_out, t_out


def test_structures_match_jax(random24, highcard, gauss9):
    for (jp, jc, jpar), (tp, tc, tpar) in (random24, highcard[1]):
        assert tscan.scan_struct_for(tp, tc) == jscan.scan_struct_for(jp, jc)
        np.testing.assert_array_equal(
            tscan._flat_counts(tc, tpar).numpy(),
            np.asarray(jscan._flat_counts(jc, jpar)))
    (jp, jc, jpar), (tp, tc, tpar) = gauss9
    struct = jscan.lg_scan_struct_for(jp, jc)
    assert tscan.lg_scan_struct_for(tp, tc) == struct
    np.testing.assert_allclose(
        tscan.lg_ptab_flat(tc, tpar, struct[2]).numpy(),
        np.asarray(jscan.lg_ptab_flat(jc, jpar, struct[2])), rtol=1e-7)


class _Captured(Exception):
    pass


def _pallas_operands(monkeypatch, call):
    """The operands the JAX scan wrapper hands to pl.pallas_call (captured
    before the kernel runs)."""
    seen = {}

    def spy(kernel, **kw):
        def launch(*operands):
            seen["ops"] = [np.asarray(o) for o in operands]
            raise _Captured

        return launch

    monkeypatch.setattr(jscan.pl, "pallas_call", spy)
    with pytest.raises(_Captured):
        call()
    return seen["ops"]


def test_compaction_slot_map_matches_jax(random24, gauss9, monkeypatch):
    """The value-scratch slot map and the parent ids as slots are the ones
    the JAX wrappers hand their kernels."""
    (jp, jc, jpar), (tp, tc, _tpar) = random24
    struct = jscan.scan_struct_for(jp, jc)
    packed, tgt = _hetero(jp.n_nodes, struct[2], B, seed=1)
    ops = _pallas_operands(monkeypatch, lambda: jscan.categorical_sweep_scan.__wrapped__(
        jax.random.PRNGKey(0), jnp.asarray(packed), jnp.asarray(tgt),
        jscan._flat_counts(jc, jpar), struct, S, interpret=True, want=("logw",)))
    smap, pid_slots, n_slots = tscan._compaction(struct[3])
    np.testing.assert_array_equal(smap, ops[10])
    np.testing.assert_array_equal(pid_slots.reshape(-1), ops[6])
    assert n_slots == int(ops[10].max()) + 1
    (jp, jc, jpar), (tp, tc, _tpar) = gauss9
    lstruct = jscan.lg_scan_struct_for(jp, jc)
    n = jp.n_nodes
    ops = _pallas_operands(monkeypatch, lambda: jscan.lg_sweep_scan.__wrapped__(
        jax.random.PRNGKey(0), jnp.zeros((B, n)), jnp.zeros((B, n), jnp.int32),
        jnp.zeros((B,), jnp.int32), jscan.lg_ptab_flat(jc, jpar, lstruct[2]),
        lstruct, S, interpret=True, want=("logw",)))
    smap, pid_slots, _n = tscan._compaction(lstruct[0])
    np.testing.assert_array_equal(pid_slots.reshape(-1), ops[4])
    np.testing.assert_array_equal(smap, ops[5])


@pytest.mark.parametrize("want", CAT_WANTS, ids="-".join)
def test_cat_scan_plain_matches_pallas_heterogeneous_rows(random24, want):
    """Rows with different targets, evidence and do nodes in one call."""
    (jp, jc, _), _t = random24
    packed, tgt = _hetero(jp.n_nodes, jscan.scan_struct_for(jp, jc)[2], B, 2)
    j_out, t_out = _run_cat(random24, packed, tgt, want, seed=9)
    _check(j_out, t_out, want, tgt_exact=True, tgt_atol=0, lp_atol=1e-4)


@pytest.mark.parametrize("want", [("logw", "tgt", "lpt"), ("pmf_logw",)],
                         ids="-".join)
def test_cat_scan_plain_matches_pallas_high_cardinality(highcard, want):
    """Classes up to 80: the JAX kernel's fori walk and its 128-lane
    histogram; the port's histogram has the network's cmax columns."""
    _bn, sides = highcard
    (jp, jc, _), _t = sides
    struct = jscan.scan_struct_for(jp, jc)
    assert struct[7] > 64
    packed, tgt = _hetero(jp.n_nodes, struct[2], 2, seed=3)
    j_out, t_out = _run_cat(sides, packed, tgt, want, seed=29)
    _check(j_out, t_out, want, tgt_exact=True, tgt_atol=0, lp_atol=1e-4)


@pytest.mark.parametrize("want", LG_WANTS, ids="-".join)
def test_lg_scan_plain_matches_pallas(gauss9, want):
    (jp, jc, jpar), (tp, tc, tpar) = gauss9
    n = jp.n_nodes
    struct = jscan.lg_scan_struct_for(jp, jc)
    rng = np.random.default_rng(5)
    u = rng.uniform(1e-6, 1 - 1e-6, size=(B, 2 * n, S)).astype(np.float32)
    fixed = rng.normal(size=(B, n)).astype(np.float32)
    flags = np.zeros((B, n), np.int32)
    for r in range(B):
        picks = rng.choice(n, size=3, replace=False)
        flags[r, picks[0]], flags[r, picks[1]], flags[r, picks[2]] = 1, 1, 2
    tgt = rng.integers(0, n, size=B).astype(np.int32)
    j_out = jscan.lg_sweep_scan(
        jax.random.PRNGKey(0), jnp.asarray(fixed), jnp.asarray(flags),
        jnp.asarray(tgt), jscan.lg_ptab_flat(jc, jpar, struct[2]), struct, S,
        interpret=True, u_ext=jnp.asarray(u), want=want,
    )
    t_out = tscan.lg_sweep_scan(
        0, torch.as_tensor(fixed), torch.as_tensor(flags),
        torch.as_tensor(tgt), tscan.lg_ptab_flat(tc, tpar, struct[2]),
        tscan.lg_scan_struct_for(tp, tc), S, u_ext=torch.as_tensor(u),
        want=want,
    )
    _check(j_out, t_out, want, tgt_exact=False, tgt_atol=2e-4, lp_atol=2e-3)


def test_scan_plain_matches_unrolled_plain_bitwise():
    """A static plan through the scan plain version draws the unrolled
    plain version's classes, under external uniforms and under Philox."""
    bn = asia()
    tv = TVBN({n: bn.parents[n] for n in bn.nodes}, seed=0, device="cpu")
    conf = {}
    for node in bn.nodes:
        c = dict(tdefaults.cpd("categorical_table"), n_classes=bn.card(node))
        if bn.parents[node]:
            c["parent_n_classes"] = [bn.card(p) for p in bn.parents[node]]
        conf[node] = c
    tv.set_learning_method("node_wise", nodes_cpds=conf)
    tv.fit(generate_dataset(bn, 4096, seed=0))
    tp = t_get_plan(tv, TQuery(
        target="dysp", do={"xray": np.ones((B, 1), np.float32)},
        evidence={"smoke": np.ones((B, 1), np.float32),
                  "asia": np.zeros((B, 1), np.float32)}))
    tc = tuple(tv.cpd_spec(n) for n in tp.topo_order)
    tpar = tuple(tv.params[n] for n in tp.topo_order)
    st, rows, cmax = tsweep.plan_tuple_for(tp, tc)
    fixed = torch.zeros((B, tp.n_nodes), dtype=torch.int32)
    for i, name in enumerate(tp.topo_order):
        fixed[:, i] = int(name in ("smoke", "xray"))
    bits = (torch.tensor(tp.evidence_mask).int() << 16) | (
        torch.tensor(tp.do_mask).int() << 17)
    tgt = torch.full((B,), tp.target_idx, dtype=torch.int32)
    u = torch.as_tensor(np.random.default_rng(4).uniform(
        1e-6, 1 - 1e-6, size=(B, tp.n_nodes, S)).astype(np.float32))
    want = ("logw", "tgt", "lpt")
    for u_ext in (u, None):
        a = tsweep.categorical_sweep_plain(
            7, fixed, tsweep._stacked_counts(tc, tpar, rows, cmax), st, S,
            u_ext=u_ext, want=want)
        b = tscan.categorical_sweep_scan_plain(
            7, fixed | bits, tgt, tscan._flat_counts(tc, tpar),
            tscan.scan_struct_for(tp, tc), S, u_ext=u_ext, want=want)
        for x, y in zip(a[:3], b[:3]):
            assert torch.equal(x, y)


def test_gate_reasons_match_jax(random24, gauss9, tmp_path):
    """The port's gates give the JAX reasons, except where the JAX one is
    its 1 MB SMEM budget: the card reads a large table from global memory."""
    for (jp, jc, _), (tp, tc, _) in (random24, gauss9):
        for s in (2048, 1000):
            assert tscan.scan_sweep_reason(tp, tc, s) == \
                jscan.scan_sweep_reason(jp, jc, s)
            assert tscan.lg_scan_reason(tp, tc, s) == \
                jscan.lg_scan_reason(jp, jc, s)
    big = types.SimpleNamespace(n_nodes=1501)
    assert tscan.scan_sweep_reason(big, (), 2048) == \
        jscan.scan_sweep_reason(big, (), 2048) == "n_nodes 1501 > 1500"
    # more than 128 classes: the same refusal
    bn = random_bn(n_nodes=4, max_card=160, max_indegree=1, seed=1)
    assert max(len(s) for s in bn.states.values()) > 128
    (jp, jc, _), (tp, tc, _) = _sides(_jax_discrete(bn, seed=4, rows=512),
                                      tmp_path / "c160")
    reason = jscan.scan_sweep_reason(jp, jc, 2048)
    assert "classes > 128" in reason
    assert tscan.scan_sweep_reason(tp, tc, 2048) == reason
    # a 360k-entry table: over the JAX SMEM budget, admitted here
    bn = DiscreteBN(name="bigtable")
    rng = np.random.default_rng(0)
    for v, c, ps in (("v0", 60, []), ("v1", 60, []), ("v2", 100, ["v0", "v1"])):
        bn.nodes.append(v)
        bn.states[v] = [f"s{k}" for k in range(c)]
        bn.parents[v] = ps
        bn.cpts[v] = rng.dirichlet([0.8] * c, size=(60,) * len(ps) or (1,))
        bn.cpts[v] = bn.cpts[v] if ps else bn.cpts[v][0]
    (jp, jc, _), (tp, tc, _) = _sides(_jax_discrete(bn, seed=5, rows=512),
                                      tmp_path / "big")
    assert "SMEM" in jscan.scan_sweep_reason(jp, jc, 2048)
    assert tscan.scan_sweep_reason(tp, tc, 2048) is None
    # the LG refusal of pmf reductions holds
    _j, (tp, tc, _) = gauss9
    assert tscan.make_scan_sweep_fn(tp, tc, 2048, ("pmf_logw",)) is None
    assert tscan.make_scan_sweep_fn(tp, tc, 2048, ("mom_logw",)) is not None


def test_shared_memory_sizing():
    """The block size falls back from 128 threads as the value scratch
    grows, the table moves to global memory past the per-block cap, and a
    plan that fits no block is refused."""
    assert tscan._cat_layout(724, 881, 309, 4, 13583) == (128, False)
    assert tscan._cat_layout(8, 8, 6, 2, 36) == (128, True)
    assert tscan._cat_layout(1500, 3000, 1501, 128, 0)[0] == 64
    assert tscan._lg_threads(107, 3, 64, True) == 128
    assert tscan._lg_threads(1500, 3, 900, True) == 32
    assert tscan._lg_threads(1500, 3, 1501, True) is None


def test_philox_node_offset():
    full = philox_uniforms(3, 2, 5, 1024, 2, "cpu")
    assert torch.equal(philox_uniforms(3, 2, 1, 1024, 2, "cpu", node0=3),
                       full[:, 6:8])
