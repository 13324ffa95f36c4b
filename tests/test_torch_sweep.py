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
from vectorizedbayesiannetwork_torch.ops._launch import check
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
    """Without u_ext the plain categorical version draws
    philox_uniforms(seed, grouped=True): the grouped stream the CUDA kernel
    generates in-kernel (one call per four nodes), not the per-node one."""
    _, (tp, tc, tpar) = cat_sides
    plan_tuple = tsweep.plan_tuple_for(tp, tc)
    struct, rows, cmax = plan_tuple
    counts = tsweep._stacked_counts(tc, tpar, rows, cmax)
    fixed = torch.zeros((B, tp.n_nodes), dtype=torch.int32)
    a = tsweep.categorical_sweep_plain(9, fixed, counts, struct, S,
                                       want=("logw", "tgt"))
    u = philox_uniforms(9, B, tp.n_nodes, S, 1, "cpu", grouped=True)
    b = tsweep.categorical_sweep_plain(9, fixed, counts, struct, S, u_ext=u,
                                       want=("logw", "tgt"))
    assert torch.equal(a[1], b[1]) and torch.equal(a[0], b[0])
    c = tsweep.categorical_sweep_plain(
        9, fixed, counts, struct, S, want=("logw", "tgt"),
        u_ext=philox_uniforms(9, B, tp.n_nodes, S, 1, "cpu"))
    assert not torch.equal(a[1], c[1])


def _lg_inputs(lg_sides):
    _, (tp, tc, tpar) = lg_sides
    struct, dmax = tsweep.lg_plan_tuple_for(tp, tc)
    ptab = tsweep.lg_param_table(tc, tpar, dmax,
                                 tuple(c.min_scale for c in tc))
    fixed = torch.full((B, tp.n_nodes), 0.5)
    return tp, tc, tpar, struct, dmax, ptab, fixed


def test_lg_plain_draws_the_grouped_stream(lg_sides):
    """Without u_ext the plain LG version draws philox_uniforms(words=2,
    grouped=True): vbn_lg_scan's stream (two nodes a call, tag 3), which
    the CUDA kernel now draws in-kernel, not the per-node one."""
    tp, _tc, _tpar, struct, dmax, ptab, fixed = _lg_inputs(lg_sides)
    want = ("logw", "tgt", "lpt")
    a = tsweep.lg_sweep_plain(9, fixed, ptab, struct, dmax, S, want=want)
    u = philox_uniforms(9, B, tp.n_nodes, S, 2, "cpu", grouped=True)
    b = tsweep.lg_sweep_plain(9, fixed, ptab, struct, dmax, S, u_ext=u,
                              want=want)
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x, y)
    c = tsweep.lg_sweep_plain(
        9, fixed, ptab, struct, dmax, S, want=want,
        u_ext=philox_uniforms(9, B, tp.n_nodes, S, 2, "cpu"))
    assert not torch.equal(a[1], c[1])


def test_lg_plain_skips_a_zero_weight(lg_sides):
    """A parent of weight exactly 0 is left out of the location, as the
    kernel's records leave it out: an infinite clamped value there gives a
    finite location, where inf * 0 would give NaN."""
    tp, _tc, _tpar, struct, dmax, ptab, fixed = _lg_inputs(lg_sides)
    child = next(i for i in range(tp.n_nodes) if tp.parent_idx[i])
    parent = tp.parent_idx[child][0]
    ptab = ptab.clone()
    ptab[child, 0] = 0.0
    fixed = fixed.clone()
    fixed[:, parent] = float("inf")
    plan = (tp.n_nodes, tp.parent_idx,
            tuple(i == parent for i in range(tp.n_nodes)),
            (False,) * tp.n_nodes, child)
    _logw, tgt, _lpt, _red = tsweep.lg_sweep_plain(
        3, fixed, ptab, plan, dmax, S, want=("tgt",))
    assert bool(torch.isfinite(tgt).all())


def test_lg_sweep_walks_the_scan_records(lg_sides):
    """vbn_lg_sweep's records (structure, node and parent records, value
    slots) are the ones vbn_lg_scan builds for the same plan; its flags
    are the plan's, ev | do << 1, and a pair of nodes is live when it holds
    a node to draw."""
    from vectorizedbayesiannetwork_torch.ops import sweep_scan as tscan

    tp, tc, tpar, struct, dmax, ptab, _fixed = _lg_inputs(lg_sides)
    sstruct = tscan.lg_scan_struct_for(tp, tc)
    assert tsweep.lg_struct(struct, dmax) == sstruct
    got = tsweep.lg_records(ptab.view(-1), sstruct)
    want = tscan.lg_records(tscan.lg_ptab_flat(tc, tpar, sstruct[2]), sstruct)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    flags, plive = tsweep._lg_flags_host(struct)
    ev, do = np.asarray(tp.evidence_mask), np.asarray(tp.do_mask)
    np.testing.assert_array_equal(flags, ev | (do << 1))
    latent = ~(ev | do)
    assert plive == sum(1 << q for q in range((tp.n_nodes + 1) // 2)
                        if latent[2 * q: 2 * q + 2].any())


def test_load_parent_imports_a_second_copy_of_the_port(lg_sides, tmp_path):
    """chip_smoke.py --parent: load_parent imports another checkout's port
    package under its own name, with its own kernel build directory, and
    its plain versions compute what this checkout's do."""
    import shutil
    from pathlib import Path

    from chip_smoke import load_parent

    root = Path(__file__).resolve().parents[1]
    shutil.copytree(root / "vectorizedbayesiannetwork_torch",
                    tmp_path / "vectorizedbayesiannetwork_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    par = load_parent(tmp_path)
    assert par.__name__ == "vbn_parent"
    assert par.ops._build.BUILD_DIR == tmp_path / "build" / "kernels"
    _tp, _tc, _tpar, struct, dmax, ptab, fixed = _lg_inputs(lg_sides)
    want = ("logw", "tgt", "lpt")
    a = par.ops.sweep.lg_sweep_plain(4, fixed, ptab, struct, dmax, S, want=want)
    b = tsweep.lg_sweep_plain(4, fixed, ptab, struct, dmax, S, want=want)
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x, y)


def test_sweep_walks_the_scan_tables(cat_sides):
    """vbn_cat_sweep's padded running-sum and count tables, built from the
    stacked counts, are bit for bit the ones vbn_cat_scan builds from the
    flat counts of the same plan, and its node records point at the same
    rows with the same cards, parent lists and strides."""
    from vectorizedbayesiannetwork_torch.ops import sweep_scan as tscan
    from vectorizedbayesiannetwork_torch.ops.cat_tables import cum_tables

    _, (tp, tc, tpar) = cat_sides
    struct, rows, cmax = tsweep.plan_tuple_for(tp, tc)
    counts = tsweep._stacked_counts(tc, tpar, rows, cmax)
    got = cum_tables(counts.view(-1), tsweep.table_layout(struct, cmax))
    sstruct = tscan.scan_struct_for(tp, tc)
    want = cum_tables(tscan._flat_counts(tc, tpar), tscan.table_layout(sstruct))
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    rec, par, n_slots, flags, glive = tsweep._cat_meta_host(struct)
    srec, spar = tscan._cat_meta_host(sstruct)[:2]
    np.testing.assert_array_equal(rec[:, [0, 1, 3]], srec[:, [0, 1, 3]])
    np.testing.assert_array_equal(par[:, 1], spar[:, 1])
    # slots: one per parent, then the trash slot; parents read their slot
    parents = sorted({p for ps in tp.parent_idx for p in ps})
    assert n_slots == len(parents) + 1
    for i in range(tp.n_nodes):
        assert rec[i, 2] == (parents.index(i) if i in parents else len(parents))
        for q, p in zip(range(rec[i, 3], rec[i + 1, 3]), tp.parent_idx[i]):
            assert par[q, 0] == parents.index(p)
    # the plan's flags, packed as the scan packs a row's; a group of four
    # nodes is live when it holds a node to draw
    ev, do = np.asarray(tp.evidence_mask), np.asarray(tp.do_mask)
    np.testing.assert_array_equal(flags, (ev << 16) | (do << 17))
    latent = ~(ev | do)
    assert glive == sum(1 << g for g in range((tp.n_nodes + 3) // 4)
                        if latent[4 * g: 4 * g + 4].any())


def test_cat_sweep_shared_memory_sizing():
    """vbn_cat_sweep's block: the row's packed words, a byte a value of
    scratch for 128 threads, the histogram."""
    # asia: 8 nodes, 7 slots, a 2-class target
    assert tsweep._cat_sweep_smem(8, 7, 2) == 32 + 896 + 1536
    assert tsweep._cat_sweep_smem(8, 7, 0) == 928
    # 80 nodes of up to 32 classes, 81 slots
    assert tsweep._cat_sweep_smem(80, 81, 32) == 320 + 10368 + 16896


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


class _OnCard:
    """A CPU tensor as the launch check sees a tensor on the card."""

    is_cuda = True

    def __init__(self, t, device=torch.device("cuda", 0)):
        self._t, self.device = t, device
        self.dtype, self.shape = t.dtype, t.shape

    def is_contiguous(self):
        return self._t.is_contiguous()


CARD = torch.device("cuda", 0)


@pytest.mark.parametrize("case,t,match", [
    ("cpu", torch.zeros(2, 2), "CUDA"),
    ("dtype", _OnCard(torch.zeros(2, 2, dtype=torch.float64)), "float64"),
    ("shape", _OnCard(torch.zeros(2, 3)), r"shape \(2, 2\).*\(2, 3\)"),
    ("not_contiguous", _OnCard(torch.zeros(2, 2).t()), "not contiguous"),
    ("device", _OnCard(torch.zeros(2, 2), torch.device("cuda", 1)), "cuda:1"),
], ids=lambda v: v if isinstance(v, str) else "")
def test_kernel_launch_rejects_cpu_inputs(case, t, match):
    """The launch path never runs the plain version: a CPU tensor is
    refused rather than quietly computed, and so is a tensor on the card
    of another dtype, shape or device, or not contiguous (the one check
    every kernel wrapper runs, ``ops/_launch.py::check``)."""
    check(_OnCard(torch.zeros(2, 2)), "x", torch.float32, (2, 2), CARD)
    with pytest.raises(ValueError, match=match):
        check(t, "x", torch.float32, (2, 2), CARD)

