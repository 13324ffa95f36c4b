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
from vectorizedbayesiannetwork_torch.core.rng import (
    philox4x32_10,
    philox_uniforms,
    uniform_from_bits,
)
from vectorizedbayesiannetwork_torch.ops import sweep as tsweep
from vectorizedbayesiannetwork_torch.ops import sweep_scan as tscan
from vectorizedbayesiannetwork_torch.ops.cat_tables import cum_tables
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
    plain version's classes, under external uniforms and under Philox with
    no external uniforms on either side: both draw the grouped stream."""
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


@pytest.mark.parametrize("query", ["mcm_x2_given_x0_x1", "lw_x0_given_x2"])
def test_lg_scan_plain_matches_unrolled_plain_bitwise(query):
    """The flagship (x0 -> x2 <- x1) on a static plan: the LG scan plain
    version draws the unrolled LG plain version's values bit for bit, under
    external uniforms and under Philox with no external uniforms on either
    side (both draw the grouped stream, two nodes a call), as vbn_lg_scan
    and vbn_lg_sweep share one walk."""
    rng = np.random.default_rng(0)
    x0, x1 = rng.normal(size=4096), rng.normal(size=4096)
    x2 = 0.5 * x0 - 0.2 * x1 + 0.1 * rng.normal(size=4096)
    tv = TVBN([("x0", "x2"), ("x1", "x2")], seed=0, device="cpu")
    tv.set_learning_method("node_wise", nodes_cpds={
        k: tdefaults.cpd("linear_gaussian") for k in ("x0", "x1", "x2")})
    tv.fit({"x0": x0, "x1": x1, "x2": x2})
    ev = np.linspace(-1, 1, B, dtype=np.float32).reshape(B, 1)
    q = (dict(target="x2", evidence={"x0": ev, "x1": -ev})
         if query.startswith("mcm") else dict(target="x0", evidence={"x2": ev}))
    tp = t_get_plan(tv, TQuery(do={}, **q))
    tc = tuple(tv.cpd_spec(n) for n in tp.topo_order)
    tpar = tuple(tv.params[n] for n in tp.topo_order)
    st, dmax = tsweep.lg_plan_tuple_for(tp, tc)
    ptab = tsweep.lg_param_table(tc, tpar, dmax, tuple(c.min_scale for c in tc))
    fixed = torch.zeros((B, tp.n_nodes))
    for i, name in enumerate(tp.topo_order):
        if name in q["evidence"]:
            fixed[:, i] = torch.as_tensor(q["evidence"][name][:, 0])
    flags = (torch.tensor(tp.evidence_mask).int()
             | (torch.tensor(tp.do_mask).int() << 1)).expand(B, -1).contiguous()
    tgt = torch.full((B,), tp.target_idx, dtype=torch.int32)
    struct = tscan.lg_scan_struct_for(tp, tc)
    u = torch.as_tensor(np.random.default_rng(4).uniform(
        1e-6, 1 - 1e-6, size=(B, 2 * tp.n_nodes, S)).astype(np.float32))
    for want in (("logw", "tgt", "lpt"), ("mom_logw",), ("mom_lpt",)):
        for u_ext in (u, None):
            a = tsweep.lg_sweep_plain(7, fixed, ptab, st, dmax, S,
                                      u_ext=u_ext, want=want)
            b = tscan.lg_sweep_scan_plain(
                7, fixed, flags, tgt, tscan.lg_ptab_flat(tc, tpar, struct[2]),
                struct, S, u_ext=u_ext, want=want)
            for x, y in zip(a[:3], b[:3]):
                assert (x is None) == (y is None)
                assert x is None or torch.equal(x, y)
            assert (a[3] is None) == (b[3] is None)
            if a[3] is not None:
                assert torch.equal(a[3][0], b[3][0])
                assert torch.equal(a[3][1], b[3][1])


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
    """The value scratch takes 2 bits a value up to 4 classes; the block
    size falls back from 128 threads as the scratch grows; the carveout
    keeps L1 room for the cumulative table while it holds the most blocks
    an SM; a plan that fits no block is refused."""
    assert tscan._scratch_bits(4) == 2 and tscan._scratch_bits(5) == 8
    # link724: 309 slots, K = 4, a 90 KB table and metadata
    assert tscan._cat_scan_smem(724, 309, 128, 4, 2) == 15632
    assert tscan._cat_scan_smem(724, 309, 128, 4, 8) == 45200
    assert tscan._cat_layout(724, 309, 4, 2, 90_000) == (128, 164, 10)
    assert tscan._cat_layout(724, 309, 4, 8, 90_000) == (128, 164, 3)
    # a tiny table: the same blocks at a smaller carveout
    assert tscan._cat_layout(8, 6, 2, 2, 200) == (128, 64, 16)
    # no carveout leaves L1 room for the table: the most blocks
    assert tscan._cat_layout(724, 309, 4, 2, 250_000)[1:] == (228, 14)
    assert tscan._cat_layout(1500, 1501, 128, 8, 0)[0] == 64
    assert tscan._cat_layout(1500, 1501, 128, 8, 0,
                             limit=100 * 1024)[0] == 32
    assert tscan._cat_layout(1500, 1501, 128, 8, 0, limit=50 * 1024) is None


def test_lg_shared_memory_sizing_and_layout():
    """vbn_lg_scan's shared memory holds the row's values and flags, a byte
    a pair, the float scratch and the moments; the layout takes the block
    size with the most resident threads an SM (ties to the larger block)
    at the smallest carveout that leaves L1 room for the records."""
    # gauss107: 40 liveness slots, 4.3 KB of records
    assert tscan._lg_scan_smem(107, 40, 128, True) == 23456
    assert tscan._lg_scan_smem(107, 40, 128, False) == 21408
    assert tscan.lg_resident_bytes((((0,) * 3,) * 107, 3, 3)) == 4296
    assert tscan._lg_layout(107, 40, True, 4296) == (128, 228, 9)
    # the first-reference compaction's 64 slots would hold 6 blocks
    assert tscan._lg_layout(107, 64, True, 4296) == (128, 228, 6)
    # under a 20 KB limit only 64 threads fit
    assert tscan._lg_layout(107, 40, True, 0, limit=20 * 1024) == (64, 228, 17)
    # records that need 100 KB of L1 cap the carveout at 132 KB
    assert tscan._lg_layout(107, 40, True, 100_000) == (128, 132, 5)
    # a small plan: threads, not shared memory, cap the blocks
    assert tscan._lg_layout(9, 6, True, 300) == (128, 100, 16)
    assert tscan._lg_layout(1500, 1501, True, 0) == (32, 228, 1)
    assert tscan._lg_layout(1500, 1800, True, 0) is None


def test_philox_node_offset():
    full = philox_uniforms(3, 2, 5, 1024, 2, "cpu")
    assert torch.equal(philox_uniforms(3, 2, 1, 1024, 2, "cpu", node0=3),
                       full[:, 6:8])
    grouped = philox_uniforms(3, 2, 9, 1024, 1, "cpu", grouped=True)
    assert torch.equal(philox_uniforms(3, 2, 3, 1024, 1, "cpu", node0=5,
                                       grouped=True), grouped[:, 5:8])


def test_lg_grouped_philox_uniforms_layout():
    """grouped=True with two words a node: node i reads words 2 (i & 1) and
    2 (i & 1) + 1 of the call with counter (particle, row, i >> 1, 3), as
    its Box-Muller pair; node0 and row0 take a slice of a larger draw."""
    seed, b, n, s = 91, 2, 5, 512
    got = philox_uniforms(seed, b, n, s, 2, "cpu", row0=3, grouped=True)
    assert got.shape == (b, 2 * n, s)
    part = torch.arange(s)
    for r in range(b):
        for i in range(n):
            words = philox4x32_10(part, torch.full((s,), 3 + r),
                                  torch.full((s,), i >> 1),
                                  torch.full((s,), 3, dtype=torch.int64), seed)
            for w in range(2):
                assert torch.equal(got[r, 2 * i + w],
                                   uniform_from_bits(words[2 * (i & 1) + w]))
    full = philox_uniforms(seed, 5, 9, s, 2, "cpu", grouped=True)
    assert torch.equal(full[3:5, : 2 * n], got)
    assert torch.equal(philox_uniforms(seed, 5, 3, s, 2, "cpu", node0=5,
                                       grouped=True), full[:, 10:16])
    assert not torch.equal(got, philox_uniforms(seed, b, n, s, 2, "cpu",
                                                row0=3))


def test_grouped_philox_uniforms_layout():
    """grouped=True: node i reads word i & 3 of the call with counter
    (particle, row, i >> 2, 1); the per-node stream is (particle, row,
    node, 0), word 0."""
    seed, b, n, s = 77, 2, 7, 512
    got = philox_uniforms(seed, b, n, s, 1, "cpu", row0=4, grouped=True)
    plain = philox_uniforms(seed, b, n, s, 1, "cpu", row0=4)
    part = torch.arange(s)
    for r in range(b):
        for i in range(n):
            words = philox4x32_10(part, torch.full((s,), 4 + r),
                                  torch.full((s,), i >> 2),
                                  torch.ones((s,), dtype=torch.int64), seed)
            assert torch.equal(got[r, i], uniform_from_bits(words[i & 3]))
            zero = torch.zeros((s,), dtype=torch.int64)
            words = philox4x32_10(part, torch.full((s,), 4 + r),
                                  torch.full((s,), i), zero, seed)
            assert torch.equal(plain[r, i], uniform_from_bits(words[0]))
    assert not torch.equal(got, plain)


def test_cat_scan_plain_draws_the_grouped_stream_across_clamped_nodes(random24):
    """Without u_ext the plain scan draws philox_uniforms(grouped=True), also
    where a group of four nodes is partly clamped (the kernel then draws
    the group's call and uses the latent nodes' words) or wholly clamped
    (the kernel skips the call)."""
    _j, (tp, tc, tpar) = random24
    struct = tscan.scan_struct_for(tp, tc)
    n = tp.n_nodes
    packed = np.zeros((B, n), np.int32)
    packed[0, 0:4] = 1 << 16  # a whole group of evidence
    packed[1, 5] = 1 << 17  # one do node in group 1
    packed[2, 8:12] = (1 << 17) | 1  # a whole group set by do
    packed[3, [1, 6, 13]] = 1 << 16
    tgt = np.asarray([4, 9, 2, 23], np.int32)
    want = ("logw", "tgt", "lpt")
    args = (torch.as_tensor(packed), torch.as_tensor(tgt),
            tscan._flat_counts(tc, tpar), struct, S)
    a = tscan.categorical_sweep_scan_plain(13, *args, want=want, row0=2)
    u = philox_uniforms(13, B, n, S, 1, "cpu", row0=2, grouped=True)
    b = tscan.categorical_sweep_scan_plain(13, *args, u_ext=u, want=want)
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x, y)


def test_lg_scan_plain_draws_the_grouped_stream_across_clamped_pairs(gauss9):
    """Without u_ext the plain LG scan draws philox_uniforms(words=2,
    grouped=True), also where a pair of nodes is partly clamped (the kernel
    then draws the pair's call and uses the latent node's words) or wholly
    clamped (the kernel skips the call)."""
    _j, (tp, tc, tpar) = gauss9
    struct = tscan.lg_scan_struct_for(tp, tc)
    n = tp.n_nodes
    rng = np.random.default_rng(6)
    fixed = rng.normal(size=(B, n)).astype(np.float32)
    flags = np.zeros((B, n), np.int32)
    flags[0, 0:2] = 1  # a whole pair of evidence
    flags[1, 3] = 2  # one do node in pair 1
    flags[2, 4:6] = 3  # a whole pair set by do
    flags[3, [1, 6, 8]] = 1
    tgt = np.asarray([4, 3, 2, 8], np.int32)
    want = ("logw", "tgt", "lpt")
    args = (torch.as_tensor(fixed), torch.as_tensor(flags),
            torch.as_tensor(tgt), tscan.lg_ptab_flat(tc, tpar, struct[2]),
            struct, S)
    a = tscan.lg_sweep_scan_plain(17, *args, want=want, row0=5)
    u = philox_uniforms(17, B, n, S, 2, "cpu", row0=5, grouped=True)
    b = tscan.lg_sweep_scan_plain(17, *args, u_ext=u, want=want)
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x, y)
    c = tscan.lg_sweep_scan_plain(17, *args, u_ext=philox_uniforms(
        17, B, n, S, 2, "cpu", row0=5), want=want)
    assert not torch.equal(a[1], c[1])


@pytest.mark.parametrize("n_nodes", [9, 40, 107])
def test_lg_slot_map_keeps_every_value_until_its_last_read(n_nodes):
    """The LG kernel's liveness slots: walking the nodes in order (each
    reads its parents' slots, then writes its own), every read finds its
    parent's value, and the slots number the most values live at once plus
    the trash slot; at 107 nodes (in the generator's node order) they are
    40, the first-reference compaction's 64 less the values already read
    for the last time."""
    gbn = random_gaussian(n_nodes, seed=0)
    order = list(gbn.nodes)
    at = {name: i for i, name in enumerate(order)}
    pmax = max(max(len(gbn.parents[v]) for v in order), 1)
    pids = tuple(tuple([at[p] for p in gbn.parents[v]]
                       + [0] * (pmax - len(gbn.parents[v]))) for v in order)
    smap, pid_slots, n_slots = tscan.lg_slot_map(pids)
    held = {}
    for i, row_p in enumerate(pids):
        for k, p in enumerate(row_p[: len(gbn.parents[order[i]])]):
            assert pid_slots[i, k] == smap[p] and held[smap[p]] == p
        held[int(smap[i])] = i
    last = {p: i for i, row_p in enumerate(pids) for p in row_p}
    live = max(sum(1 for p, end in last.items() if p < i <= end)
               for i in range(n_nodes))
    assert n_slots == live + 1 <= tscan._compaction(pids)[2]
    assert (smap == n_slots - 1).sum() == n_nodes - len(last)
    if n_nodes == 107:
        assert (n_slots, tscan._compaction(pids)[2]) == (40, 64)


def test_lg_records_walk_gives_the_plain_location(gauss9):
    """The LG kernel's records: one per node {out slot, parent start, bias,
    sigma} and one per parent of nonzero weight {slot, weight}, in row
    order; walking them (loc = bias, then loc + value * weight per record)
    gives the plain version's location bit for bit, a parent whose fitted
    weight is exactly 0 left out as the plain version skips it."""
    _j, (tp, tc, tpar) = gauss9
    struct = tscan.lg_scan_struct_for(tp, tc)
    pids, pmax, dmax = struct
    n = tp.n_nodes
    ptab = tscan.lg_ptab_flat(tc, tpar, dmax).clone()
    rows = ptab.view(n, dmax + 2)
    child = next(i for i in range(n) if len(tp.parent_idx[i]) >= 2)
    rows[child, 0] = 0.0  # a real parent of weight exactly 0
    rec, par = tscan.lg_records(ptab, struct)
    smap, pid_slots, n_slots = tscan.lg_slot_map(pids)
    keep = [(i, k) for i in range(n) for k in range(pmax)
            if float(rows[i, k]) != 0.0]
    assert int(rec[n, 1]) == len(keep) == sum(
        len(p) for p in tp.parent_idx) - 1
    assert rec[:n, 0].tolist() == smap.tolist()
    np.testing.assert_array_equal(rec[:n, 2:].view(torch.float32).numpy(),
                                  rows[:, dmax:].numpy())
    assert par[: len(keep), 0].tolist() == [int(pid_slots[i, k]) for i, k in keep]
    rng = np.random.default_rng(3)
    vals = torch.as_tensor(rng.normal(size=(n_slots, 64)).astype(np.float32))
    for i in range(n):
        v = vals.clone()
        if i == child:  # the left-out parent's value cannot reach loc
            v[pid_slots[child, 0]] = float("nan")
        loc = rows[i, dmax].expand(64)
        for k in range(pmax):
            if float(rows[i, k]) != 0.0:
                loc = loc + v[pid_slots[i, k]] * rows[i, k]
        walk = rec[i, 2:3].view(torch.float32).expand(64)
        for e in range(int(rec[i, 1]), int(rec[i + 1, 1])):
            walk = walk + v[int(par[e, 0])] * par[e, 1:2].view(torch.float32)
        assert torch.equal(walk, loc), i


def test_lg_densities_give_the_plain_log_density(gauss9):
    """The LG kernels' density pairs {1 / sigma, log(sigma) + log(2 pi) / 2}:
    -zz^2 / 2 - the second, zz = (v - loc) * the first, is the plain
    versions' -zz^2 / 2 - log(sigma) - log(2 pi) / 2 with zz = (v - loc) /
    sigma, within float32 rounding."""
    _j, (tp, tc, tpar) = gauss9
    struct = tscan.lg_scan_struct_for(tp, tc)
    dmax = struct[2]
    ptab = tscan.lg_ptab_flat(tc, tpar, dmax)
    dens = tscan.lg_densities(ptab, struct)
    sigma = ptab.view(tp.n_nodes, dmax + 2)[:, dmax + 1]
    assert dens.shape == (tp.n_nodes, 2) and dens.dtype == torch.float32
    diff = torch.as_tensor(np.random.default_rng(8).normal(
        size=(64, tp.n_nodes)).astype(np.float32)) * sigma
    zz = diff * dens[:, 0]
    got = -0.5 * zz * zz - dens[:, 1]
    zp = diff / sigma
    want = -0.5 * zp * zp - torch.log(sigma) - tscan._HALF_LOG_2PI
    torch.testing.assert_close(got, want, atol=2e-6, rtol=0)


def _seq_cum(row):
    """Running sums of a count row, one float32 add per class."""
    out, acc = [], np.float32(0.0)
    for j, v in enumerate(row):
        acc = np.float32(v) if j == 0 else np.float32(acc + np.float32(v))
        out.append(acc)
    return out


def _port_fit(bn, seed=0):
    tv = TVBN({n: bn.parents[n] for n in bn.nodes}, seed=seed, device="cpu")
    conf = {}
    for node in bn.nodes:
        c = dict(tdefaults.cpd("categorical_table"), n_classes=bn.card(node))
        if bn.parents[node]:
            c["parent_n_classes"] = [bn.card(p) for p in bn.parents[node]]
        conf[node] = c
    tv.set_learning_method("node_wise", nodes_cpds=conf)
    tv.fit(generate_dataset(bn, 4096, seed=seed))
    tp = t_get_plan(tv, TQuery(target=tuple(tv.dag.topological_order())[0],
                               evidence={}, do={}))
    return (tp, tuple(tv.cpd_spec(n) for n in tp.topo_order),
            tuple(tv.params[n] for n in tp.topo_order))


@pytest.fixture(scope="module")
def link724():
    from benchmarking.networks import random_bn_treewidth

    return _port_fit(random_bn_treewidth(724, seed=0))


@pytest.mark.parametrize("net", ["link724", "highcard"])
def test_cum_tables_are_the_sequential_sums(net, link724, highcard):
    """The kernels' padded tables: each row's running sums bitwise equal to
    a numpy float32 sequential sum, pads repeating the total, rows at
    multiples of four floats; beside them each class's log-probability,
    the plain version's log(max(count / max(total, 1e-12), 1e-12))."""
    tp, tc, tpar = link724 if net == "link724" else highcard[1][1]
    struct = tscan.scan_struct_for(tp, tc)
    flat = tscan._flat_counts(tc, tpar)
    cum, lpt = (t.numpy() for t in cum_tables(flat, tscan.table_layout(struct)))
    rec = tscan._cat_meta_host(struct)[0]
    eoff, rows, cards = struct[:3]
    fl = flat.numpy()
    for i in range(tp.n_nodes):
        c, cp = cards[i], (cards[i] + 3) & ~3
        assert rec[i, 0] % 4 == 0 and rec[i, 1] == c
        for r in range(rows[i]):
            row = fl[eoff[i] + r * c: eoff[i] + (r + 1) * c]
            at = rec[i, 0] + r * cp
            want = _seq_cum(row)
            assert cum[at: at + c].tolist() == want
            assert (cum[at + c: at + cp] == want[-1]).all()
            prob = row / np.float32(max(want[-1], 1e-12))
            np.testing.assert_allclose(
                lpt[at: at + c], np.log(np.maximum(prob, np.float32(1e-12))),
                rtol=1e-6, atol=1e-7)
    assert len(cum) == rec[-2, 0] + rows[-1] * ((cards[-1] + 3) & ~3)


@pytest.mark.parametrize("net", ["link724", "highcard"])
def test_cum_table_walk_gives_the_plain_classes(net, link724, highcard):
    """The kernel's walk on the padded running sums (thresh = u * total,
    v = sum_{j < c-1} [cum_j <= thresh]) gives the plain version's classes
    bit for bit on external uniforms, every row of every node."""
    tp, tc, tpar = link724 if net == "link724" else highcard[1][1]
    struct = tscan.scan_struct_for(tp, tc)
    flat = tscan._flat_counts(tc, tpar)
    cum = cum_tables(flat, tscan.table_layout(struct))[0]
    rec = tscan._cat_meta_host(struct)[0]
    eoff, rows, cards = struct[:3]
    u = torch.as_tensor(np.random.default_rng(8).uniform(
        1e-6, 1 - 1e-6, size=256).astype(np.float32))
    u[0] = 1.0 - 2.0**-24
    for i in range(tp.n_nodes):
        c, cp, nr = cards[i], (cards[i] + 3) & ~3, rows[i]
        tbl = flat[eoff[i]: eoff[i] + nr * c].view(nr, 1, c).expand(nr, 256, c)
        total = tbl[..., 0]
        for j in range(1, c):
            total = total + tbl[..., j]
        thresh = u * total
        acc, walk = tbl[..., 0], torch.zeros_like(total, dtype=torch.int64)
        for j in range(1, c):
            walk = walk + (acc <= thresh).long()
            acc = acc + tbl[..., j]
        cm = cum[rec[i, 0]: rec[i, 0] + nr * cp].view(nr, 1, cp)
        assert torch.equal(cm[..., c - 1], total[:, :1])
        k_thresh = u * cm[..., c - 1]
        got = (cm[..., : c - 1] <= k_thresh[..., None]).long().sum(-1)
        assert torch.equal(got, walk), i
