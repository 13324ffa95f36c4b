"""The port's CUDA kernels (the unrolled sweeps of ``ops/sweep.py``, the
scan sweeps of ``ops/sweep_scan.py``, the resampling kernels of
``ops/scan.py`` and ``ops/resample_merge.py``, the KDE kernels of
``ops/kde_fused.py`` and ``gaussian_nn``'s forward of ``ops/mlp_fused.py``)
against their plain PyTorch versions.

These tests need a CUDA card: each one skips here without one (decided in
a fixture, not at import). This file imports neither JAX nor pandas, so it
also runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -o addopts=

The inputs are the port's own fits on numpy data made from a seed; both
sides get the same external uniforms, or the in-kernel Philox stream that
the plain versions reproduce. Tolerances are the JAX kernel tests' own
(``tests/test_sweep_pallas.py``): categorical target classes exact,
log-weights atol 1e-4; LG targets atol 2e-4, log-densities atol 2e-3;
reductions rtol 2e-3. The resampling kernels are exact on the weight
profiles of ``tests/test_resample_pallas.py`` quantized to multiples of
2^-23 (``quantized_profile`` of ``chip_smoke.py``). The KDE log-densities
hold within 1e-4 (the JAX kernel tests' tolerance for the exact float32
forms) on supports with an unaligned, masked tail; the picks are exact on
an external Gumbel field, and on the served inverse-CDF route agree with
the plain version on at least 99.99 % of 2^20 rows (the two sum in other
orders), any other row a neighbour in the walk. The fused MLP forward
holds the plain route (``_denorm_params``) and its own plain version within
1e-5 (loc of ``std_y``, scale relative), the softplus inputs on both sides
of its threshold.
"""

import numpy as np
import pytest
import torch

from benchmarking.data_gen import generate_dataset
from benchmarking.networks import asia
from chip_smoke import (
    PROFILES,
    chi2_z_merged,
    far_queries,
    kde_cond_float64,
    pick_agreement,
    quantized_profile,
)
from vectorizedbayesiannetwork_torch import VBN, defaults
from vectorizedbayesiannetwork_torch.core.base import Query
from vectorizedbayesiannetwork_torch.core.plan import get_plan
from vectorizedbayesiannetwork_torch.ops import _build, _launch
from vectorizedbayesiannetwork_torch.ops import kde_fused as kf
from vectorizedbayesiannetwork_torch.ops import sweep

from test_torch_tf32 import mma_tf32, tf32

B, S = 4, 2048
CAT_WANTS = [("logw", "lpt"), ("logw", "tgt"), ("lpt",), ("pmf_logw",),
             ("pmf_lpt",), ("mom_logw",), ("mom_lpt",)]
LG_WANTS = [("logw", "lpt"), ("logw", "tgt"), ("lpt",), ("mom_logw",),
            ("mom_lpt",)]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m cuda)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def asia_vbn(card):
    bn = asia()
    data = generate_dataset(bn, 4096, seed=0)
    vbn = VBN({n: bn.parents[n] for n in bn.nodes}, seed=0, device=card)
    conf = {}
    for node in bn.nodes:
        c = dict(defaults.cpd("categorical_table"), n_classes=bn.card(node))
        if bn.parents[node]:
            c["parent_n_classes"] = [bn.card(p) for p in bn.parents[node]]
        conf[node] = c
    vbn.set_learning_method("node_wise", nodes_cpds=conf)
    vbn.fit(data)
    vbn.set_inference_method("likelihood_weighting", n_samples=S)
    return vbn


@pytest.fixture(scope="module")
def lg_vbn(card):
    rng = np.random.default_rng(0)
    x0, x1 = rng.normal(size=4096), rng.normal(size=4096)
    x2 = 0.5 * x0 - 0.2 * x1 + 0.1 * rng.normal(size=4096)
    vbn = VBN([("x0", "x2"), ("x1", "x2")], seed=0, device=card)
    vbn.set_learning_method(
        "node_wise",
        nodes_cpds={k: defaults.cpd("linear_gaussian") for k in ("x0", "x1", "x2")},
    )
    vbn.fit({"x0": x0, "x1": x1, "x2": x2})
    vbn.set_inference_method("monte_carlo_marginalization", n_samples=S)
    return vbn


def _plan(vbn, **query):
    plan = get_plan(vbn, Query(**query))
    return (plan, tuple(vbn.cpd_spec(n) for n in plan.topo_order),
            tuple(vbn.params[n] for n in plan.topo_order))


def _check(k_out, p_out, *, tgt_atol, lp_atol):
    for label, a, b in zip(("logw", "tgt", "lpt"), k_out[:3], p_out[:3]):
        assert (a is None) == (b is None), label
        if a is None:
            continue
        if label == "tgt" and tgt_atol == 0:
            assert torch.equal(a, b)
        else:
            atol = tgt_atol if label == "tgt" else lp_atol
            torch.testing.assert_close(a, b, atol=atol, rtol=0)
    assert (k_out[3] is None) == (p_out[3] is None)
    if k_out[3] is not None:
        torch.testing.assert_close(k_out[3][1], p_out[3][1], atol=lp_atol,
                                   rtol=0)
        torch.testing.assert_close(k_out[3][0], p_out[3][0], rtol=2e-3,
                                   atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("want", CAT_WANTS, ids="-".join)
def test_categorical_kernel_matches_plain(asia_vbn, want):
    plan, cpds, params = _plan(
        asia_vbn, target="dysp", do={"xray": np.ones((B, 1), np.float32)},
        evidence={"smoke": np.ones((B, 1), np.float32),
                  "asia": np.zeros((B, 1), np.float32)})
    struct, rows, cmax = sweep.plan_tuple_for(plan, cpds)
    counts = sweep._stacked_counts(cpds, params, rows, cmax)
    fixed = torch.zeros((B, plan.n_nodes), dtype=torch.int32, device="cuda")
    for i, name in enumerate(plan.topo_order):
        if name in ("smoke", "xray"):
            fixed[:, i] = 1
    before = _launch.LAUNCHES["categorical"]
    for u in (None, torch.rand((B, plan.n_nodes, S), device="cuda")):
        k_out = sweep.categorical_sweep_fused(
            3, fixed, counts, struct, S, u_ext=u, want=want)
        p_out = sweep.categorical_sweep_plain(
            3, fixed, counts, struct, S, u_ext=u, want=want)
        _check(k_out, p_out, tgt_atol=0, lp_atol=1e-4)
    assert _launch.LAUNCHES["categorical"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("want", LG_WANTS, ids="-".join)
def test_lg_kernel_matches_plain(lg_vbn, want):
    plan, cpds, params = _plan(
        lg_vbn, target="x2", do={},
        evidence={"x0": np.full((B, 1), 0.5, np.float32)})
    struct, dmax = sweep.lg_plan_tuple_for(plan, cpds)
    ptab = sweep.lg_param_table(cpds, params, dmax,
                                tuple(c.min_scale for c in cpds))
    fixed = torch.full((B, plan.n_nodes), 0.5, device="cuda")
    before = _launch.LAUNCHES["lg"]
    u_ext = torch.rand((B, 2 * plan.n_nodes, S), device="cuda")
    for u in (None, u_ext.clamp(1e-6, 1 - 1e-6)):  # log(u1) stays finite
        k_out = sweep.lg_sweep_fused(
            3, fixed, ptab, struct, dmax, S, u_ext=u, want=want)
        p_out = sweep.lg_sweep_plain(
            3, fixed, ptab, struct, dmax, S, u_ext=u, want=want)
        _check(k_out, p_out, tgt_atol=2e-4, lp_atol=2e-3)
    assert _launch.LAUNCHES["lg"] == before + 2


@pytest.mark.cuda
def test_served_rows_go_through_the_kernels(asia_vbn, lg_vbn):
    """The public entry points launch one kernel per query batch."""
    before = dict(_launch.LAUNCHES)
    q = {"target": "dysp", "evidence": {"smoke": np.ones((B, 1), np.float32)}}
    pmf, _ = asia_vbn.infer_posterior_pmf([q, q], n_classes=2)
    assert asia_vbn._last_summary_path == "fused"
    assert pmf.shape == (2 * B, 2) and np.isfinite(pmf).all()
    ev = {"x0": np.zeros((B, 1), np.float32), "x1": np.ones((B, 1), np.float32)}
    mom, _ = lg_vbn.infer_posterior_moments([{"target": "x2", "evidence": ev}])
    assert lg_vbn._last_summary_path == "fused"
    assert mom.shape == (B, 2) and np.isfinite(mom).all()
    assert _launch.LAUNCHES["categorical"] == before["categorical"] + 2
    assert _launch.LAUNCHES["lg"] == before["lg"] + 1


@pytest.mark.cuda
def test_served_calls_show_their_kernels_and_tables_as_spans(asia_vbn, lg_vbn):
    """Under the profiler each hand kernel's launch is one
    ``vbn.kernel.<name>`` span and each table build one ``vbn.tables``
    span, as ``LAUNCHES`` and ``BUILDS`` count them: the categorical sweep
    builds its counts and running-sum tables, the LG sweep its parameter
    rows, records and densities."""
    from torch.profiler import ProfilerActivity, profile

    from vectorizedbayesiannetwork_torch.utils import profiling

    q = {"target": "dysp", "evidence": {"smoke": np.ones((B, 1), np.float32)}}
    ev = {"x0": np.zeros((B, 1), np.float32), "x1": np.ones((B, 1), np.float32)}
    profiling.reset_spans()
    before, built = dict(_launch.LAUNCHES), dict(profiling.BUILDS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        asia_vbn.infer_posterior_pmf([q], n_classes=2)
        lg_vbn.infer_posterior_moments([{"target": "x2", "evidence": ev}])
        torch.cuda.synchronize()
    names = [r["name"] for r in profiling.spans()]
    profiling.reset_spans()
    assert names.count("vbn.call") == 2
    for name in ("categorical", "lg"):
        assert names.count(f"vbn.kernel.{name}") == 1
        assert _launch.LAUNCHES[name] == before[name] + 1
    assert names.count("vbn.tables") == 5
    assert profiling.BUILDS["tables"] == built["tables"] + 5
    assert profiling.BUILDS["fn"] == built["fn"] + 2


def _fit_discrete(bn, card, seed=0, rows=4096):
    vbn = VBN({n: bn.parents[n] for n in bn.nodes}, seed=seed, device=card)
    conf = {}
    for node in bn.nodes:
        c = dict(defaults.cpd("categorical_table"), n_classes=bn.card(node))
        if bn.parents[node]:
            c["parent_n_classes"] = [bn.card(p) for p in bn.parents[node]]
        conf[node] = c
    vbn.set_learning_method("node_wise", nodes_cpds=conf)
    vbn.fit(generate_dataset(bn, rows, seed=seed))
    return vbn


def _canonical(vbn):
    topo = tuple(vbn.dag.topological_order())
    return _plan(vbn, target=topo[0], evidence={}, do={})


def _hetero_rows(n, cards, b, seed):
    """Per-row targets, two evidence nodes and one do node, as int32
    packed words (value | ev << 16 | do << 17) and [B] targets."""
    rng = np.random.default_rng(seed)
    packed = np.zeros((b, n), np.int32)
    tgt = np.zeros((b,), np.int32)
    for r in range(b):
        picks = rng.choice(n, size=4, replace=False)
        tgt[r] = picks[0]
        for i, bit in ((picks[1], 1 << 16), (picks[2], 1 << 16),
                       (picks[3], 1 << 17)):
            packed[r, i] = int(rng.integers(0, cards[i])) | bit
    return (torch.as_tensor(packed, device="cuda"),
            torch.as_tensor(tgt, device="cuda"))


@pytest.fixture(scope="module")
def scan_nets(card):
    from benchmarking.networks import random_bn, random_bn_treewidth

    return {
        "random24": _fit_discrete(random_bn(n_nodes=24, max_card=4, seed=7),
                                  card, seed=1),
        "highcard": _fit_discrete(
            random_bn(n_nodes=6, max_card=80, max_indegree=1, seed=0), card,
            seed=3),
        "link724": _fit_discrete(random_bn_treewidth(724, seed=0), card),
    }


def _scan_case(scan_nets, asia_vbn, net):
    """(packed, tgt, flat counts, struct) of a network's canonical plan
    with heterogeneous rows, or of asia's static plan."""
    from vectorizedbayesiannetwork_torch.ops import sweep_scan

    if net == "asia":
        plan, cpds, params = _plan(
            asia_vbn, target="dysp", do={"xray": np.ones((B, 1), np.float32)},
            evidence={"smoke": np.ones((B, 1), np.float32),
                      "asia": np.zeros((B, 1), np.float32)})
        fixed = torch.tensor([[int(n in ("smoke", "xray")) for n in plan.topo_order]] * B,
                             dtype=torch.int32, device="cuda")
        packed = fixed | (torch.tensor(plan.evidence_mask, device="cuda").int() << 16) | (
            torch.tensor(plan.do_mask, device="cuda").int() << 17)
        tgt = torch.full((B,), plan.target_idx, dtype=torch.int32, device="cuda")
    else:
        plan, cpds, params = _canonical(scan_nets[net])
        packed, tgt = _hetero_rows(plan.n_nodes,
                                   sweep_scan.scan_struct_for(plan, cpds)[2],
                                   B, seed=9)
    return (packed.contiguous(), tgt, sweep_scan._flat_counts(cpds, params),
            sweep_scan.scan_struct_for(plan, cpds))


@pytest.mark.cuda
@pytest.mark.parametrize("net", ["random24", "highcard", "link724", "asia"])
@pytest.mark.parametrize("want", CAT_WANTS, ids="-".join)
def test_cat_scan_kernel_matches_plain(scan_nets, asia_vbn, net, want):
    """Bitwise equal to the plain version (classes, log-weights, target
    log-densities, reductions) on external uniforms and on the grouped
    Philox stream."""
    from vectorizedbayesiannetwork_torch.ops import sweep_scan

    packed, tgt, flat, struct = _scan_case(scan_nets, asia_vbn, net)
    before = _launch.LAUNCHES["categorical_scan"]
    n = packed.shape[1]
    u_ext = torch.rand((B, n, S), device="cuda")
    for u in (None, u_ext.clamp(1e-6, 1 - 1e-6)):
        k_out = sweep_scan.categorical_sweep_scan(
            5, packed, tgt, flat, struct, S, u_ext=u, want=want)
        p_out = sweep_scan.categorical_sweep_scan_plain(
            5, packed, tgt, flat, struct, S, u_ext=u, want=want)
        for a, b in zip(k_out[:3], p_out[:3]):
            assert (a is None) == (b is None)
            assert a is None or torch.equal(a, b)
        if k_out[3] is not None:
            torch.testing.assert_close(k_out[3][1], p_out[3][1], atol=1e-4,
                                       rtol=0)
            torch.testing.assert_close(k_out[3][0], p_out[3][0], rtol=2e-3,
                                       atol=1e-6)
    assert _launch.LAUNCHES["categorical_scan"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("net", ["random24", "highcard", "link724"])
def test_cat_scan_layout_and_occupancy(scan_nets, net):
    """The device's layout: 2-bit scratch up to 4 classes, at least one
    block an SM, the carveout one of the SM's configurations."""
    from vectorizedbayesiannetwork_torch.ops import sweep_scan

    plan, cpds, _params = _canonical(scan_nets[net])
    struct = sweep_scan.scan_struct_for(plan, cpds)
    rec, par, n_slots, tab_len = sweep_scan._cat_meta_host(struct)[:4]
    bits = sweep_scan._scratch_bits(struct[7])
    assert bits == (2 if struct[7] <= 4 else 8)
    for kind, k in ((0, 0), (1, struct[7]), (2, 3)):
        t, c_kb, blocks = sweep_scan.cat_scan_layout(
            plan.n_nodes, n_slots, k, bits,
            4 * (tab_len + rec.size + par.size), kind, 0)
        assert t in sweep_scan._THREADS and c_kb in sweep_scan._CARVEOUTS_KB
        assert blocks >= 1


@pytest.fixture(scope="module")
def gauss_vbn(card):
    from benchmarking.gaussian_bn import random_gaussian

    bn = random_gaussian(9, seed=0)
    vbn = VBN({n: bn.parents[n] for n in bn.nodes}, seed=0, device=card)
    vbn.set_learning_method(
        "node_wise",
        nodes_cpds={n: defaults.cpd("linear_gaussian") for n in bn.nodes})
    vbn.fit(bn.sample(4096, seed=0))
    return vbn


@pytest.mark.cuda
@pytest.mark.parametrize("want", LG_WANTS, ids="-".join)
def test_lg_scan_kernel_matches_plain(gauss_vbn, want):
    from vectorizedbayesiannetwork_torch.ops import sweep_scan

    plan, cpds, params = _canonical(gauss_vbn)
    n = plan.n_nodes
    struct = sweep_scan.lg_scan_struct_for(plan, cpds)
    ptab = sweep_scan.lg_ptab_flat(cpds, params, struct[2])
    rng = np.random.default_rng(4)
    flags = np.zeros((B, n), np.int32)
    for r in range(B):
        picks = rng.choice(n, size=3, replace=False)
        flags[r, picks[0]], flags[r, picks[1]], flags[r, picks[2]] = 1, 1, 2
    fixed = torch.as_tensor(rng.normal(size=(B, n)).astype(np.float32),
                            device="cuda")
    flags = torch.as_tensor(flags, device="cuda")
    tgt = torch.as_tensor(rng.integers(0, n, size=B).astype(np.int32),
                          device="cuda")
    before = _launch.LAUNCHES["lg_scan"]
    u_ext = torch.rand((B, 2 * n, S), device="cuda").clamp(1e-6, 1 - 1e-6)
    for u in (None, u_ext):
        k_out = sweep_scan.lg_sweep_scan(
            5, fixed, flags, tgt, ptab, struct, S, u_ext=u, want=want)
        p_out = sweep_scan.lg_sweep_scan_plain(
            5, fixed, flags, tgt, ptab, struct, S, u_ext=u, want=want)
        _check(k_out, p_out, tgt_atol=2e-4, lp_atol=2e-3)
    assert _launch.LAUNCHES["lg_scan"] == before + 2


@pytest.mark.cuda
def test_lg_scan_kernel_skips_zero_weights_and_clamped_pairs(gauss_vbn):
    """A parent of fitted weight exactly 0 (left out of the records) and
    rows whose pairs of nodes are wholly or partly clamped (a wholly
    clamped pair skips its Philox call): the kernel within its tolerances
    of the plain version in both uniform modes."""
    from vectorizedbayesiannetwork_torch.ops import sweep_scan

    plan, cpds, params = _canonical(gauss_vbn)
    n = plan.n_nodes
    struct = sweep_scan.lg_scan_struct_for(plan, cpds)
    ptab = sweep_scan.lg_ptab_flat(cpds, params, struct[2]).clone()
    child = next(i for i in range(n) if len(plan.parent_idx[i]) >= 2)
    ptab.view(n, struct[2] + 2)[child, 0] = 0.0
    flags = torch.zeros((B, n), dtype=torch.int32, device="cuda")
    flags[0, 0:2] = 1
    flags[1, 3] = 2
    flags[2, 4:6] = 3
    flags[3, [1, 6, 8]] = 1
    fixed = torch.randn((B, n), device="cuda")
    tgt = torch.tensor([4, 3, 2, 8], dtype=torch.int32, device="cuda")
    u_ext = torch.rand((B, 2 * n, S), device="cuda").clamp(1e-6, 1 - 1e-6)
    want = ("logw", "tgt", "lpt")
    for u in (None, u_ext):
        k_out = sweep_scan.lg_sweep_scan(
            7, fixed, flags, tgt, ptab, struct, S, u_ext=u, want=want)
        p_out = sweep_scan.lg_sweep_scan_plain(
            7, fixed, flags, tgt, ptab, struct, S, u_ext=u, want=want)
        _check(k_out, p_out, tgt_atol=2e-4, lp_atol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("n_nodes", [9, 107])
def test_lg_scan_layout_and_occupancy(card, n_nodes):
    """The device's LG layout: a block size of the list, a carveout of the
    SM's configurations that leaves L1 room for the records, at least one
    block an SM and no more than shared memory and threads allow."""
    from benchmarking.gaussian_bn import random_gaussian
    from vectorizedbayesiannetwork_torch.ops import sweep_scan

    bn = random_gaussian(n_nodes, seed=0)
    vbn = VBN({n: bn.parents[n] for n in bn.nodes}, seed=0, device=card)
    vbn.set_learning_method(
        "node_wise",
        nodes_cpds={n: defaults.cpd("linear_gaussian") for n in bn.nodes})
    vbn.fit(bn.sample(512, seed=0))
    plan, cpds, _params = _canonical(vbn)
    struct = sweep_scan.lg_scan_struct_for(plan, cpds)
    n_slots = sweep_scan.lg_slot_map(struct[0])[2]
    resident = sweep_scan.lg_resident_bytes(struct)
    for kind in (0, 2):
        t, c_kb, blocks = sweep_scan.lg_scan_layout(
            plan.n_nodes, n_slots, kind, resident, 0)
        assert t in sweep_scan._THREADS and c_kb in sweep_scan._CARVEOUTS_KB
        assert sweep_scan._SM_UNIFIED - c_kb * 1024 >= resident
        smem = sweep_scan._lg_scan_smem(plan.n_nodes, n_slots, t, kind != 0)
        assert 1 <= blocks <= sweep_scan._blocks_by_smem(t, smem, c_kb)


@pytest.mark.cuda
def test_scan_kernel_matches_unrolled_kernel_bitwise(asia_vbn):
    """Static plan: vbn_cat_scan draws vbn_cat_sweep's classes (one walk),
    on the same external uniforms (the grouped Philox stream) and on the
    two kernels' own in-kernel streams."""
    from vectorizedbayesiannetwork_torch.core.rng import philox_uniforms
    from vectorizedbayesiannetwork_torch.ops import sweep_scan

    plan, cpds, params = _plan(
        asia_vbn, target="dysp", do={"xray": np.ones((B, 1), np.float32)},
        evidence={"smoke": np.ones((B, 1), np.float32),
                  "asia": np.zeros((B, 1), np.float32)})
    st, rows, cmax = sweep.plan_tuple_for(plan, cpds)
    fixed = torch.zeros((B, plan.n_nodes), dtype=torch.int32, device="cuda")
    for i, name in enumerate(plan.topo_order):
        if name in ("smoke", "xray"):
            fixed[:, i] = 1
    bits = (torch.tensor(plan.evidence_mask, device="cuda").int() << 16) | (
        torch.tensor(plan.do_mask, device="cuda").int() << 17)
    tgt = torch.full((B,), plan.target_idx, dtype=torch.int32, device="cuda")
    want = ("logw", "tgt", "lpt")
    u = philox_uniforms(11, B, plan.n_nodes, S, 1, "cuda", grouped=True)
    a = sweep.categorical_sweep_fused(
        11, fixed, sweep._stacked_counts(cpds, params, rows, cmax), st, S,
        u_ext=u, want=want)
    b = sweep_scan.categorical_sweep_scan(
        11, fixed | bits, tgt, sweep_scan._flat_counts(cpds, params),
        sweep_scan.scan_struct_for(plan, cpds), S, u_ext=u, want=want)
    c = sweep_scan.categorical_sweep_scan(
        11, fixed | bits, tgt, sweep_scan._flat_counts(cpds, params),
        sweep_scan.scan_struct_for(plan, cpds), S, want=want)
    d = sweep.categorical_sweep_fused(
        11, fixed, sweep._stacked_counts(cpds, params, rows, cmax), st, S,
        want=want)
    for x, y, z, w in zip(a[:3], b[:3], c[:3], d[:3]):
        assert torch.equal(x, y) and torch.equal(y, z) and torch.equal(z, w)


@pytest.mark.cuda
@pytest.mark.parametrize("query", ["mcm_x2_given_x0_x1", "lw_x0_given_x2"])
def test_lg_scan_kernel_matches_unrolled_kernel_bitwise(lg_vbn, query):
    """The flagship's static plan: vbn_lg_scan draws vbn_lg_sweep's values
    (one walk, lg_walk.cuh) bit for bit, on the same external uniforms (the
    grouped Philox stream) and on the two kernels' own in-kernel streams."""
    from vectorizedbayesiannetwork_torch.core.rng import philox_uniforms
    from vectorizedbayesiannetwork_torch.ops import sweep_scan

    ev = torch.linspace(-1, 1, B).reshape(B, 1).numpy()
    q = (dict(target="x2", evidence={"x0": ev, "x1": -ev})
         if query.startswith("mcm") else dict(target="x0", evidence={"x2": ev}))
    plan, cpds, params = _plan(lg_vbn, do={}, **q)
    st, dmax = sweep.lg_plan_tuple_for(plan, cpds)
    ptab = sweep.lg_param_table(cpds, params, dmax,
                                tuple(c.min_scale for c in cpds))
    fixed = torch.zeros((B, plan.n_nodes), device="cuda")
    for i, name in enumerate(plan.topo_order):
        if name in q["evidence"]:
            fixed[:, i] = torch.as_tensor(q["evidence"][name][:, 0])
    flags = (torch.tensor(plan.evidence_mask, device="cuda").int()
             | (torch.tensor(plan.do_mask, device="cuda").int() << 1)
             ).expand(B, -1).contiguous()
    tgt = torch.full((B,), plan.target_idx, dtype=torch.int32, device="cuda")
    struct = sweep_scan.lg_scan_struct_for(plan, cpds)
    flat = sweep_scan.lg_ptab_flat(cpds, params, struct[2])
    want = ("logw", "tgt", "lpt")
    u = philox_uniforms(13, B, plan.n_nodes, S, 2, "cuda", grouped=True)
    a = sweep.lg_sweep_fused(13, fixed, ptab, st, dmax, S, u_ext=u, want=want)
    b = sweep_scan.lg_sweep_scan(13, fixed, flags, tgt, flat, struct, S,
                                 u_ext=u, want=want)
    c = sweep_scan.lg_sweep_scan(13, fixed, flags, tgt, flat, struct, S,
                                 want=want)
    d = sweep.lg_sweep_fused(13, fixed, ptab, st, dmax, S, want=want)
    for x, y, z, w in zip(a[:3], b[:3], c[:3], d[:3]):
        assert torch.equal(x, y) and torch.equal(y, z) and torch.equal(z, w)


@pytest.mark.cuda
def test_scan_smem_layout_matches_the_kernels(card):
    """The wrappers' shared-memory counts are the ones the kernels lay
    out."""
    from vectorizedbayesiannetwork_torch.ops import sweep_scan

    lib = _build.load("sweep_scan")
    for args in [(724, 309, 128, 4, 2), (724, 309, 128, 4, 8),
                 (24, 15, 64, 0, 2), (6, 7, 32, 80, 8), (1500, 1501, 32, 3, 8)]:
        assert lib.vbn_cat_scan_smem_bytes(*args) == \
            sweep_scan._cat_scan_smem(*args)
    for args in [(107, 64, 128, 1), (9, 6, 64, 0), (1500, 900, 32, 1),
                 (1, 2, 128, 1)]:
        assert lib.vbn_lg_scan_smem_bytes(*args) == \
            sweep_scan._lg_scan_smem(*args)
    assert sweep_scan._smem_limit(0) >= 48 * 1024
    for args in [(8, 7, 2), (8, 7, 0), (80, 81, 32), (5, 3, 3)]:
        assert _build.load("sweep").vbn_cat_sweep_smem_bytes(*args) == \
            sweep._cat_sweep_smem(*args)


@pytest.mark.cuda
def test_dynamic_serving_goes_through_the_scan_kernels(scan_nets, gauss_vbn):
    """dynamic_masks=True: one launch serves a mixed query list."""
    vbn = scan_nets["random24"]
    nodes = list(vbn.dag.topological_order())
    qs = [{"target": nodes[-1], "evidence": {nodes[0]: [[1.0]]}},
          {"target": nodes[2], "evidence": {nodes[-1]: [[0.0]]}}]
    vbn.set_inference_method("likelihood_weighting", n_samples=S,
                             dynamic_masks=True)
    before = dict(_launch.LAUNCHES)
    pmf, spans = vbn.infer_posterior_pmf(qs, n_classes=4, pad_bucket=4)
    assert vbn._last_summary_path == "fused" and pmf.shape == (2, 4)
    np.testing.assert_allclose(pmf.sum(axis=1), 1.0, atol=1e-5)
    gq = [{"target": "x8", "evidence": {"x0": [[0.3]]}}]
    gauss_vbn.set_inference_method("likelihood_weighting", n_samples=S,
                                   dynamic_masks=True)
    mom, _ = gauss_vbn.infer_posterior_moments(gq)
    assert np.isfinite(mom).all()
    after = dict(_launch.LAUNCHES)
    assert after["categorical_scan"] == before["categorical_scan"] + 1
    assert after["lg_scan"] == before["lg_scan"] + 1
    assert after["categorical"] == before["categorical"]
    assert after["lg"] == before["lg"]


@pytest.mark.cuda
def test_launch_refuses_what_the_kernel_does_not_take(asia_vbn):
    """On a CUDA tensor the wrapper launches or raises; it never falls
    back to the plain version."""
    plan, cpds, params = _plan(asia_vbn, target="dysp", evidence={}, do={})
    struct, rows, cmax = sweep.plan_tuple_for(plan, cpds)
    counts = sweep._stacked_counts(cpds, params, rows, cmax)
    fixed = torch.zeros((B, plan.n_nodes), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="multiple of 1024"):
        sweep.categorical_sweep_fused(0, fixed, counts, struct, 1000)
    with pytest.raises(ValueError, match="fixed_idx"):
        sweep.categorical_sweep_fused(0, fixed.float(), counts, struct, S)


# ---------------------------------------------------------------------------
# Resampling kernels: vbn_cumsum, vbn_cum_index (the merge's pointer
# routine on its own entry point), vbn_srg, vbn_spg
# ---------------------------------------------------------------------------


RB, RS = 3, 2048  # the JAX resample tests' sizes


def _weights(name, b=RB, s=RS):
    return torch.as_tensor(quantized_profile(name, b, s), device="cuda")


def _vals(d, b=RB, s=RS, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((b, s, d), generator=g, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("monotone", [False, True])
def test_cumsum_kernel_matches_plain(card, monotone):
    """Exact on quantized weights; within rtol 1e-5 on uniform rows of one
    tile and of many (RIS's B = 8, S = 2^20; S = 2^22 + 7, a ragged last
    tile), and within 1e-4 of the row total of float64 prefix sums at
    S = 2^22 + 7; the same launch repeated gives the same bits."""
    from vectorizedbayesiannetwork_torch.ops import scan

    before = _launch.LAUNCHES["cumsum"]
    w = torch.cat([_weights(p) for p in PROFILES])  # exact sums
    assert torch.equal(scan.cumsum_rows(w, monotone),
                       scan.cumsum_rows_plain(w, monotone))
    g = torch.Generator(device="cuda").manual_seed(1)
    shapes = [(3, 70000), (2, 2049), (1, 100), (8, 1 << 20), (2, (1 << 22) + 7)]
    for shape in shapes:
        x = torch.rand(shape, generator=g, device="cuda")
        got = scan.cumsum_rows(x, monotone)
        torch.testing.assert_close(got, scan.cumsum_rows_plain(x, monotone),
                                   rtol=1e-5, atol=0)
        if monotone:
            assert bool((got.diff(dim=1) >= 0).all())
    ref = torch.cumsum(x.double(), dim=1)
    assert float(((got.double() - ref).abs() / ref[:, -1:]).max()) <= 1e-4
    assert torch.equal(scan.cumsum_rows(x, monotone), got)  # deterministic
    assert _launch.LAUNCHES["cumsum"] == before + len(shapes) + 2


@pytest.mark.cuda
@pytest.mark.parametrize("name", PROFILES)
def test_cum_index_kernel_matches_plain(card, name):
    from vectorizedbayesiannetwork_torch.ops import resample_merge as rm

    cum = rm.norm_cum(_weights(name))
    g = torch.Generator(device="cuda").manual_seed(2)
    u0 = torch.rand((RB, 1), generator=g, device="cuda")
    pos = torch.sort(torch.rand((RB, RS), generator=g, device="cuda")).values
    before = _launch.LAUNCHES["cum_index"]
    ends = torch.tensor([0.0, rm.POS_MAX], device="cuda").expand(RB, 2)
    ties = torch.cat([cum[:, rm.W - 1 :: rm.W], ends], 1)  # window lasts
    heads = rm.systematic_positions(u0, RS, rm.T)
    for q in (heads, heads.flip(1), pos[:, :: rm.T], ties):
        got = rm.cum_index(cum, q)
        want = rm.cum_index_plain(cum, q)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert _launch.LAUNCHES["cum_index"] == before + 4


# merge_kernel's run ends: 2 and 3 tiles a row (S = 1536), and 129
MERGE_SIZES = [RS, 1024, 1536, (1 << 16) + 512]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 5, 512])
@pytest.mark.parametrize("s", MERGE_SIZES)
@pytest.mark.parametrize("name", PROFILES)
def test_srg_kernel_matches_plain(card, name, s, d):
    from vectorizedbayesiannetwork_torch.ops import resample_merge as rm

    w, vals = _weights(name, s=s), _vals(d, s=s)
    g = torch.Generator(device="cuda").manual_seed(3)
    u0 = torch.rand((RB, 1), generator=g, device="cuda")
    before = dict(_launch.LAUNCHES)
    got = rm.systematic_resample_gather(w, vals, u0=u0)
    assert _launch.LAUNCHES["srg"] == before["srg"] + 1
    assert _launch.LAUNCHES["cum_index"] == before["cum_index"]  # in the merge
    assert _launch.LAUNCHES["cumsum"] == before["cumsum"] + 1
    assert torch.equal(got, rm.srg_plain(u0, rm.norm_cum(w), vals))


@pytest.mark.cuda
def test_srg_kernel_high_u0_and_smallest_size(card):
    """(S-1+u0)/S rounds to 1.0 at S = 2^16: the last position still picks
    a real particle; and S = 1024, the smallest size the gate admits."""
    from vectorizedbayesiannetwork_torch.ops import resample_merge as rm

    s2 = 1 << 16
    w = torch.full((2, s2), 1.0 / s2, device="cuda")
    vals = torch.arange(1, s2 + 1, dtype=torch.float32,
                        device="cuda")[None, :, None].repeat(2, 1, 1)
    u0 = torch.tensor([[0.25], [1.0 - 2.0**-24]], device="cuda")
    got = rm.systematic_resample_gather(w, vals, u0=u0)
    assert torch.equal(got, rm.srg_plain(u0, rm.norm_cum(w), vals))
    assert float(got.min()) >= 1.0 and float(got[1, -1, 0]) == s2
    w, vals, u0 = _weights("dirichlet", s=1024), _vals(3, s=1024), u0[:1].repeat(RB, 1)
    got = rm.systematic_resample_gather(w, vals, u0=u0)
    assert torch.equal(got, rm.srg_plain(u0, rm.norm_cum(w), vals))


# (S_in, S_out): S_out = S/2 (rounded down to a tile), S and 2S
SPG_SIZES = [(RS, RS), (RS, 1024)] + [
    (s, so) for s in MERGE_SIZES[1:]
    for so in (max(512, s // 2 // 512 * 512), s, 2 * s)]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 5, 512])
@pytest.mark.parametrize("s, s_out", SPG_SIZES)
@pytest.mark.parametrize("name", PROFILES)
def test_spg_kernel_matches_plain(card, name, s, s_out, d):
    from vectorizedbayesiannetwork_torch.ops import resample_merge as rm

    cum = rm.norm_cum(_weights(name, s=s))
    g = torch.Generator(device="cuda").manual_seed(4)
    pos = torch.sort(torch.rand((RB, s_out), generator=g, device="cuda")).values
    pos[:, 0], pos[:, -1] = 0.0, 1.0
    vals = _vals(d, s=s)
    before = _launch.LAUNCHES["spg"]
    got = rm.sorted_gather(cum, pos, vals)
    assert _launch.LAUNCHES["spg"] == before + 1
    assert got.shape == (RB, s_out, d)
    assert torch.equal(got, rm.spg_plain(cum, pos, vals))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 5])
def test_merge_kernel_fallbacks_and_pointer_jumps(card, d):
    """Positions the staged pair does not hold: unsorted positions (before
    the pair; pointers that move back), crowded weights (past the pair),
    positions on the window lasts (ties past the pair) and a dead stretch
    that pointers leap over (the pair loaded after its tile), through the wrapper and on a misaligned view of the values
    (copied to 16 bytes): spg_plain's output bit for bit."""
    from vectorizedbayesiannetwork_torch.ops import resample_merge as rm

    s = (1 << 16) + 512
    w = _weights("dirichlet", s=s)
    w[:, 1000:40000] = 0.0
    w[:, 50000:50008] = 0.05
    cum = rm.norm_cum(w / w.sum(dim=1, keepdim=True))
    g = torch.Generator(device="cuda").manual_seed(6)
    pos = torch.sort(torch.rand((RB, s), generator=g, device="cuda")).values
    vals = torch.randn((RB * s * d + 1,), generator=g, device="cuda")
    vals = vals[1:].view(RB, s, d)  # 4 bytes past an allocation
    lasts = cum[:, rm.W - 1 :: rm.W]  # positions on them: ties past the pair
    ties = torch.sort(lasts[:, torch.randint(0, lasts.shape[1], (s,),
                                             generator=g, device="cuda")]).values
    for p in (pos, pos[:, torch.randperm(s, generator=g, device="cuda")],
              ties):
        got = rm.spg(cum, p.contiguous(), vals)
        assert torch.equal(got, rm.spg_plain(cum, p, vals))
    u0 = torch.rand((RB, 1), generator=g, device="cuda")
    assert torch.equal(rm.srg(u0, cum, vals), rm.srg_plain(u0, cum, vals))


@pytest.mark.cuda
def test_multinomial_gather_goes_through_the_kernels(card):
    """Exp(1) draws in multiples of 2^-6 below 8: their cumsum is exact too, so the
    kernel path equals the plain one bit for bit."""
    from vectorizedbayesiannetwork_torch.ops import resample_merge as rm
    from vectorizedbayesiannetwork_torch.ops import scan

    w, vals = _weights("dirichlet"), _vals(5)
    g = torch.Generator(device="cuda").manual_seed(5)
    e = torch.empty((RB, RS + 1), device="cuda").exponential_(generator=g)
    e = torch.round(torch.clamp(e, max=7.9) * 64.0) / 64.0
    before = dict(_launch.LAUNCHES)
    got = rm.multinomial_resample_gather(w, vals, e=e)
    after = dict(_launch.LAUNCHES)
    assert {k: after[k] - before[k] for k in ("cumsum", "cum_index", "spg")} \
        == {"cumsum": 2, "cum_index": 0, "spg": 1}
    c = scan.cumsum_rows_plain(e, monotone=True)
    pos = c[:, :RS] / c[:, -1:]
    assert torch.equal(got, rm.spg_plain(rm.norm_cum(w), pos, vals))


@pytest.mark.cuda
def test_merge_wrappers_refuse_what_the_kernels_do_not_take(card):
    from vectorizedbayesiannetwork_torch.ops import resample_merge as rm
    from vectorizedbayesiannetwork_torch.ops import scan

    w = torch.full((2, 512), 1.0 / 512, device="cuda")
    with pytest.raises(ValueError, match="S >= 1024"):
        rm.systematic_resample_gather(w, torch.zeros((2, 512, 1), device="cuda"))
    with pytest.raises(ValueError, match="float32"):
        scan.cumsum_rows(torch.zeros((2, 8), dtype=torch.float64, device="cuda"))
    cum = rm.norm_cum(_weights("uniform"))
    with pytest.raises(ValueError, match="S_out"):
        rm.sorted_gather(cum, torch.zeros((RB, 700), device="cuda"), _vals(1))


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["systematic", "multinomial"])
def test_ris_resampling_events_launch_the_kernels(lg_vbn, method):
    """Flagship diagnosis (x0 | x2): one resampling event per call, each
    one cumsum (two for multinomial) and one merge launch; no index launch:
    the merge derives its tile pointers. The loop's two latent nodes and
    the event's uniforms (systematic ``u0``, multinomial's Exp(1) draws)
    draw a ``vbn_uniforms`` launch each."""
    q = {"target": "x0", "evidence": {
        "x2": np.linspace(-1, 1, B).reshape(B, 1).astype(np.float32)}}
    lg_vbn.set_inference_method("resampled_importance_sampling", n_samples=S,
                                ess_threshold=0.5, resample_method=method)
    before = dict(_launch.LAUNCHES)
    w, s = lg_vbn.infer_posterior(q)
    after = dict(_launch.LAUNCHES)
    assert lg_vbn._inference._last_resampled
    merge = "srg" if method == "systematic" else "spg"
    got = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert got == {"cumsum": 1 if merge == "srg" else 2, merge: 1,
                   "uniforms": 3}
    mean = lg_vbn._posterior_stats(w, s)["mean"][:, 0].cpu().numpy()
    assert np.all(np.diff(mean) > 0)  # x0 | x2 rises with x2
    lg_vbn.set_inference_method("monte_carlo_marginalization", n_samples=S)


# ---------------------------------------------------------------------------
# KDE kernels: vbn_kde_root, vbn_kde_cond, vbn_kde_cond_wide, vbn_kde_pick
# ---------------------------------------------------------------------------


KM = 3000  # query rows of the KDE checks


def _kde_support(n, dx, dp, valid, seed=0):
    """(data_x, data_p, log_mask) on the card: N support points, the first
    ``valid`` live, the tail at the model's soft mask log(1e-20)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    data_x = torch.randn((n, dx), generator=g, device="cuda")
    data_p = torch.randn((n, dp), generator=g, device="cuda")
    lm = torch.zeros(n, device="cuda")
    lm[valid:] = float(np.log(np.float32(1e-20)))
    return data_x, data_p, lm


def _kde_queries(dx, dp, seed=1):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (1.5 * torch.randn((KM, dx), generator=g, device="cuda"),
            1.5 * torch.randn((KM, dp), generator=g, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("dx", [1, 2, 5])
@pytest.mark.parametrize("n,valid", [(2048, 2048), (2000, 1700)])
def test_kde_root_kernel_matches_plain(card, dx, n, valid):
    data_x, _, lm = _kde_support(n, dx, 1, valid)
    x, _ = _kde_queries(dx, 1)
    before = _launch.LAUNCHES["kde_root"]
    got = kf.kde_root(x, data_x, lm, 0.3)
    assert _launch.LAUNCHES["kde_root"] == before + 1
    torch.testing.assert_close(got, kf.kde_root_plain(x, data_x, lm, 0.3),
                               atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dx,dp", [(1, 1), (1, 2), (2, 3), (3, 17), (1, 4),
                                   (1, 8), (2, 16)])
@pytest.mark.parametrize("n,valid", [(2048, 2048), (2000, 1700)])
def test_kde_cond_kernel_matches_plain(card, dx, dp, n, valid):
    data_x, data_p, lm = _kde_support(n, dx, dp, valid)
    x, p = _kde_queries(dx, dp)
    before = _launch.LAUNCHES["kde_cond"]
    got = kf.kde_cond(x, p, data_x, data_p, lm, 0.3, 0.4)
    assert _launch.LAUNCHES["kde_cond"] == before + 1
    want = kf.kde_cond_plain(x, p, data_x, data_p, lm, 0.3, 0.4)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["far", "all_masked"])
@pytest.mark.parametrize("dx,dp", [(1, 0), (2, 0), (1, 2), (2, 8), (1, 16)])
def test_kde_direct_kernels_far_rows_and_masked_support(card, case, dx, dp):
    """vbn_kde_root (dp 0) and vbn_kde_cond within 1e-4 of their plain
    versions on query rows moved out of the support by 10 scale units over
    their features (every term far below 0: the lazily moved references
    rescale many times), and on a support masked everywhere (-inf: the root
    gives -inf, the conditional -inf - -inf = NaN, on both sides)."""
    data_x, data_p, lm = _kde_support(2000, dx, max(dp, 1), 1700)
    x, p = _kde_queries(dx, max(dp, 1))
    if case == "far":
        x = x + 0.3 * float(np.sqrt(100.0 / dx))
        p = p + 0.4 * float(np.sqrt(100.0 / max(dp, 1)))
    else:
        lm = torch.full_like(lm, float("-inf"))
    if dp == 0:
        got = kf.kde_root(x, data_x, lm, 0.3)
        want = kf.kde_root_plain(x, data_x, lm, 0.3)
    else:
        got = kf.kde_cond(x, p, data_x, data_p, lm, 0.3, 0.4)
        want = kf.kde_cond_plain(x, p, data_x, data_p, lm, 0.3, 0.4)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0,
                               equal_nan=case == "all_masked")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["near", "offset", "ragged", "all_masked",
                                  "off_support", "far_off_support"])
@pytest.mark.parametrize("dx,dp", [(1, 40), (2, 33), (35, 3), (1, 2), (40, 40)])
def test_kde_cond_wide_kernel_matches_plain(card, case, dx, dp):
    """vbn_kde_cond_wide (3xTF32 on centred data) within 1e-4 of the plain
    version: N = 2000 with 1700 live; support and queries offset by +20 in
    every feature; N = 2017 with 1900 live (not a whole number of the
    kernel's 32-point tiles); every point masked (-inf: NaN on both
    sides); at Scott bandwidths, queries one bandwidth off a support point
    in every feature (each term then far below 0, where the tensor core's
    truncation once cost more than 1e-4 with a wide target), and queries
    further off, whose log-densities pass 100 (``far_queries``)."""
    n, valid = (2017, 1900) if case == "ragged" else (2000, 1700)
    data_x, data_p, lm = _kde_support(n, dx, dp, valid)
    x, p = _kde_queries(dx, dp)
    # wide supports spread the squared distances: scales of their order
    ys, ps = 0.5 * np.sqrt(dx), 0.5 * np.sqrt(dp)
    if case == "offset":
        x, p, data_x, data_p = (a + 20.0 for a in (x, p, data_x, data_p))
    elif case == "all_masked":
        lm = torch.full_like(lm, float("-inf"))
    elif case in ("off_support", "far_off_support"):
        rate = float(valid) ** (-1.0 / (dx + dp + 4))
        ys = rate * float(data_x[:valid].std(0).mean())
        ps = rate * float(data_p[:valid].std(0).mean())
        g = torch.Generator(device="cuda").manual_seed(2)
        idx = torch.randint(0, valid, (KM,), generator=g, device="cuda")
        if case == "far_off_support":
            x, p, ref = far_queries(data_x, data_p, idx, ys, ps, g, (
                lambda x_, p_: kde_cond_float64(x_, p_, data_x, data_p, lm,
                                                ys, ps)))
            assert float(ref.abs().min()) > 100.0
        else:
            x = data_x[idx] + ys * torch.sign(torch.randn(
                (KM, dx), generator=g, device="cuda"))
            p = data_p[idx] + ps * torch.sign(torch.randn(
                (KM, dp), generator=g, device="cuda"))
    before = _launch.LAUNCHES["kde_cond_wide"]
    got = kf.kde_cond_wide(x, p, data_x, data_p, lm, ys, ps)
    assert _launch.LAUNCHES["kde_cond_wide"] == before + 1
    want = kf.kde_cond_plain(x, p, data_x, data_p, lm, ys, ps)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0,
                               equal_nan=case == "all_masked")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["normal", "wide_exponents", "cancelling"])
def test_tf32_mma_matches_the_tensor_core_model(card, kind):
    """The wide kernel's mma.sync (``vbn_kde_mma_probe``) bit for bit
    against ``test_torch_tf32.mma_tf32`` (truncation, not rounding to
    nearest) on 2048 random m16n8k8 tiles: normal operands; operands and
    accumulators spread over 2^-12 .. 2^12; accumulators that cancel the
    products to 1e-3."""
    g = np.random.default_rng(0)
    w = 2048
    a = tf32(g.normal(size=(w, 16, 8)).astype(np.float32))
    b = tf32(g.normal(size=(w, 8, 8)).astype(np.float32))
    c = (g.normal(size=(w, 16, 8)) * 8).astype(np.float32)
    if kind == "wide_exponents":
        a = tf32(a * np.exp2(g.integers(-12, 12, a.shape)).astype(np.float32))
        c = c * np.exp2(g.integers(-12, 12, c.shape)).astype(np.float32)
    elif kind == "cancelling":
        c = (-(a.astype(np.float64) @ b) * (1 + 1e-3)).astype(np.float32)
    t = [torch.from_numpy(v).to(card) for v in (a, b, c)]
    d = torch.empty_like(t[2])
    _launch.launch("kde", "vbn_kde_mma_probe", *(v.data_ptr() for v in t),
                   d.data_ptr(), w, device=card)
    want = np.stack([mma_tf32(c[i], a[i], b[i].T) for i in range(w)])
    np.testing.assert_array_equal(d.cpu().numpy().view(np.uint32),
                                  want.view(np.uint32))


KM_PICK = 1 << 20  # rows of the inverse-CDF pick's agreement check


@pytest.mark.cuda
@pytest.mark.parametrize("dp", [0, 1, 2, 3])
@pytest.mark.parametrize("gumbel", ["external", "philox"])
@pytest.mark.parametrize("n,valid", [(2048, 2048), (2000, 1700)])
def test_kde_pick_kernel_matches_plain(card, dp, gumbel, n, valid):
    """External Gumbel field: the plain version's picks exactly. Served
    route: the plain version's picks on >= 99.99 % of 2^20 rows from the
    same uniforms, any other a neighbour in the walk."""
    data_x, data_p, lm = _kde_support(n, 2, max(dp, 1), valid)
    m = KM if gumbel == "external" else KM_PICK
    g = torch.Generator(device="cuda").manual_seed(1)
    p = 1.5 * torch.randn((m, max(dp, 1)), generator=g, device="cuda")
    parents = p if dp else None
    key = torch.tensor([0x0BADF00D, 0x5EED1234], dtype=torch.int64,
                       device="cuda")
    gf = (-torch.log(torch.empty((m, n), device="cuda").exponential_())
          if gumbel == "external" else None)
    before = _launch.LAUNCHES["kde_pick"]
    got = kf.kde_pick(key, parents, data_p, data_x, lm, 0.4, m, gumbel=gf)
    assert _launch.LAUNCHES["kde_pick"] == before + 1
    want = kf.kde_pick_plain(key, parents, data_p, data_x, lm, 0.4, m, gumbel=gf)
    if gumbel == "external":
        assert torch.equal(got, want)
        return
    same, _n_diff, between = pick_agreement(got, want, data_x, data_p, lm, 0.4,
                                            parents)
    assert same >= 0.9999, same
    assert between <= 1e-5, between  # neighbours in the walk


@pytest.mark.cuda
@pytest.mark.parametrize("n,dp", [(5000, 2), (20000, 0)], ids=["parents", "root"])
def test_kde_pick_kernel_past_2048_points(card, n, dp):
    """Past 2048 points the conditional pick sums chunks longer than 64
    points, and a root past 16384 points takes the conditional form: the
    plain version's picks on >= 99.9 % of rows, any other a neighbour."""
    data_x, data_p, lm = _kde_support(n, 1, max(dp, 1), n - 300)
    m = 1 << 18
    g = torch.Generator(device="cuda").manual_seed(2)
    parents = (1.5 * torch.randn((m, dp), generator=g, device="cuda")
               if dp else None)
    key = torch.tensor([5, 6], dtype=torch.int64, device="cuda")
    got = kf.kde_pick(key, parents, data_p, data_x, lm, 0.4, m)
    want = kf.kde_pick_plain(key, parents, data_p, data_x, lm, 0.4, m)
    same, _n_diff, between = pick_agreement(got, want, data_x, data_p, lm, 0.4,
                                            parents)
    assert same >= 0.999, same
    assert between <= 1e-5, between


@pytest.mark.cuda
@pytest.mark.parametrize("root", [True, False], ids=["root", "parents"])
def test_kde_pick_kernel_draws_the_exact_categorical(card, root):
    """2^20 kernel draws for one parent row against the categorical
    mask_n exp(-|p - P_n|^2 / 2h^2) in float64: chi-square within 6 sd."""
    n, m, h = 2000, 1 << 20, 0.5
    data_x, data_p, lm = _kde_support(n, 1, 2, 1700)
    data_x = torch.arange(n, dtype=torch.float32, device="cuda")[:, None]
    p_row = torch.tensor([[0.3, -0.5]], device="cuda")
    logits = lm.double()
    if not root:
        logits = logits - ((p_row.double() - data_p.double()) ** 2).sum(1) / (2 * h * h)
    probs = torch.softmax(logits, 0).cpu().numpy()
    parents = None if root else p_row.expand(m, 2).contiguous()
    key = torch.tensor([41, 42], dtype=torch.int64, device="cuda")
    got = kf.kde_pick(key, parents, data_p, data_x, lm, h, m)[:, 0].long()
    counts = torch.bincount(got, minlength=n).double().cpu().numpy()
    z = chi2_z_merged(counts, probs)
    assert abs(z) < 6, z


@pytest.mark.cuda
def test_kde_wrappers_refuse_what_the_kernels_do_not_take(card):
    data_x, data_p, lm = _kde_support(256, 1, 2, 256)
    x, p = _kde_queries(1, 2)
    with pytest.raises(ValueError, match="float32"):
        kf.kde_root(x.double(), data_x, lm, 0.3)
    with pytest.raises(ValueError, match="contiguous"):
        kf.kde_cond(x, p.t().contiguous().t(), data_x, data_p, lm, 0.3, 0.3)
    with pytest.raises(ValueError, match="use kde_cond_wide"):
        kf.kde_cond(x, torch.zeros((KM, 33), device="cuda"), data_x,
                    torch.zeros((256, 33), device="cuda"), lm, 0.3, 0.3)
    with pytest.raises(ValueError, match="key"):
        kf.kde_pick(torch.tensor([1, 2], device="cuda", dtype=torch.int32),
                    None, data_p, data_x, lm, 0.3, KM)
    with pytest.raises(ValueError, match="Dp=40"):  # the chunked form's work
        kf.kde_pick(None, torch.zeros((KM, 40), device="cuda"),
                    torch.zeros((256, 40), device="cuda"), data_x, lm, 0.3, KM)


@pytest.mark.cuda
@pytest.mark.parametrize("flag", ["some_rows", "no_row"])
@pytest.mark.parametrize("s_loc", [1 << 16, 200], ids=["row_a_block",
                                                       "straddling"])
@pytest.mark.parametrize("kind", ["root", "cond", "pick"])
def test_kde_read_flag_retires_blocks_bit_for_bit(card, kind, s_loc, flag):
    """``vbn_kde_root``, ``vbn_kde_cond`` and the conditional
    ``vbn_kde_pick`` with a read flag (a strided column of a [B, 5] mask):
    the read rows bit for bit those of the launch without a flag, every
    other row 0, at 2^16 rows a query row (each 256-thread block inside one
    query row) and at 200 (blocks straddle query rows); the pick on a
    ``RowMap`` with a nonzero base. With no row read every block retires
    and the output is all 0. ``LAUNCHES`` counts both launches, and the
    flagged one under ``<kernel>.flagged``."""
    b = 6
    m = b * s_loc
    data_x, data_p, lm = _kde_support(2000, 2, 3, 1700)
    g = torch.Generator(device="cuda").manual_seed(3)
    x = 1.5 * torch.randn((m, 2), generator=g, device="cuda")
    p = 1.5 * torch.randn((m, 3), generator=g, device="cuda")
    masks = torch.zeros((b, 5), device="cuda")
    if flag == "some_rows":
        masks[[1, 4, 5], 3] = 1.0
    key = torch.tensor([0x0BADF00D, 0x5EED1234], dtype=torch.int64,
                       device="cuda")
    rows = kf.RowMap.of(5, 0, s_loc, s_loc)

    def run(read):
        if kind == "root":
            return kf.kde_root(x, data_x, lm, 0.3, read=read)
        if kind == "cond":
            return kf.kde_cond(x, p, data_x, data_p, lm, 0.3, 0.4, read=read)
        return kf.kde_pick(key, p, data_p, data_x, lm, 0.4, m, rows=rows,
                           read=read)

    name = f"kde_{kind}"
    before = (_launch.LAUNCHES[name], _launch.LAUNCHES[name + ".flagged"])
    full = run(None)
    got = run(kf.ReadFlag(masks[:, 3], s_loc))
    assert (_launch.LAUNCHES[name], _launch.LAUNCHES[name + ".flagged"]) == (
        before[0] + 2, before[1] + 1)
    keep = (masks[:, 3] != 0).repeat_interleave(s_loc)
    assert torch.equal(got[keep], full[keep])
    assert not bool(got[~keep].any()) and bool(full[~keep].any())
    assert torch.equal(run(kf.ReadFlag(torch.ones(b, device="cuda"), s_loc)),
                       full)


@pytest.fixture(scope="module")
def kde_vbn(card):
    rng = np.random.default_rng(0)
    x0, x1 = rng.normal(size=4096), rng.normal(size=4096)
    x2 = 0.5 * x0 - 0.2 * x1 + 0.1 * rng.normal(size=4096)
    vbn = VBN([("x0", "x2"), ("x1", "x2")], seed=0, device=card)
    vbn.set_learning_method("node_wise", nodes_cpds={
        k: dict(defaults.cpd("kde"), max_points=2048) for k in ("x0", "x1", "x2")})
    vbn.fit({"x0": x0, "x1": x1, "x2": x2})
    return vbn


@pytest.mark.cuda
@pytest.mark.parametrize("dynamic", [False, True])
def test_kde_serving_goes_through_the_kernels(kde_vbn, dynamic):
    """LW x2 | x0 on the card: the root's log-density and both picks
    (static), or every node's pick and log-density (dynamic), in the
    kernels, each drawn node's noise a ``vbn_uniforms`` launch; the served
    moments finite."""
    assert float(kde_vbn.params["x2"]["valid"].sum()) == 2048
    kde_vbn.set_inference_method("likelihood_weighting", n_samples=S,
                                 dynamic_masks=dynamic)
    q = {"target": "x2", "evidence": {
        "x0": np.linspace(-1, 1, B).reshape(B, 1).astype(np.float32)}}
    before = dict(_launch.LAUNCHES)
    mom, _ = kde_vbn.infer_posterior_moments([q])
    after = dict(_launch.LAUNCHES)
    got = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    # dynamic: the densities and x2's conditional pick carry read flags
    want = ({"kde_root": 2, "kde_cond": 1, "kde_pick": 3, "uniforms": 3,
             "kde_root.flagged": 2, "kde_cond.flagged": 1,
             "kde_pick.flagged": 1}
            if dynamic else {"kde_root": 1, "kde_pick": 2, "uniforms": 2})
    assert got == want
    assert kde_vbn._last_summary_path == ("fused" if dynamic else "stream")
    assert mom.shape == (B, 2) and np.isfinite(mom).all()
    assert np.all(np.diff(mom[:, 0]) > 0)  # x2 | x0 rises with x0


@pytest.mark.cuda
def test_kde_dynamic_sweep_read_flags_keep_the_rows(card, kde_vbn,
                                                   monkeypatch):
    """The per-node dynamic sweep on the card, with evidence, do and a
    target mask at 200 particles a row: weights, target log-densities and
    target values bit for bit those of the same sweep with the KDE CPDs'
    read flags off; flagged launches: each root's and the conditional's
    density, and the conditional's pick, a sweep."""
    from vectorizedbayesiannetwork_torch.core.rng import Draw
    from vectorizedbayesiannetwork_torch.inference._dynamic_sweep import (
        dynamic_sweep_trace,
    )
    from vectorizedbayesiannetwork_torch.models.kde import KDECPD

    vbn = kde_vbn
    plan = get_plan(vbn, Query(target="x2", evidence={}, do={}))
    cpds = tuple(vbn.cpd_spec(n) for n in plan.topo_order)
    params = tuple(vbn.params[n] for n in plan.topo_order)
    idx = {n: i for i, n in enumerate(plan.topo_order)}
    b, s = 6, 200
    g = torch.Generator(device="cuda").manual_seed(4)
    fixed = torch.randn((b, plan.total_dim), generator=g, device="cuda")
    ev = torch.zeros((b, 3), device="cuda")
    do = torch.zeros((b, 3), device="cuda")
    for row, nodes in enumerate([("x2",), ("x0",), (), ("x0", "x2"), (),
                                 ("x1",)]):
        for n in nodes:
            ev[row, idx[n]] = 1.0
    do[1, idx["x1"]] = do[4, idx["x0"]] = 1.0
    ti = torch.tensor([idx[n] for n in ("x0", "x2", "x2", "x1", "x2", "x0")],
                      dtype=torch.int32, device="cuda")
    tgt = torch.nn.functional.one_hot(ti.long(), 3).to(torch.float32)
    outs = {}
    for on in (True, False):
        monkeypatch.setattr(KDECPD, "takes_read_flag", on)
        before = dict(_launch.LAUNCHES)
        outs[on] = [dynamic_sweep_trace(
            plan, cpds, params, Draw(3, card), fixed, ev, do, s, tgt_mask=t,
            targets=ti) for t in (tgt, None)]
        flagged = {k: _launch.LAUNCHES[k] - before[k] for k in before
                   if k.endswith(".flagged")}
        assert flagged == ({"kde_root.flagged": 4, "kde_cond.flagged": 2,
                            "kde_pick.flagged": 2} if on else
                           dict.fromkeys(flagged, 0))
    for got, want in zip(outs[True], outs[False]):
        assert len(got) == len(want)
        for a, w in zip(got, want):
            assert torch.equal(a, w)


@pytest.mark.cuda
def test_gnn_cell_rows_on_the_node_planes_equal_the_packed_route(card,
                                                                 monkeypatch):
    """The gnn cell's served batch on the card (``gauss8-gnn-lw.mixed96``:
    its fit and the first 96-row call of its pool, at S = 2^14): the rows
    served from the per-node sweep's node-major store equal, bit for bit,
    those of the route before it (the nodes' values concatenated, then
    the per-row gather: ``test_torch_node_planes.parent_per_node_trace``)
    on the same key; each call counts one ``target_planes`` sweep and
    launches ``vbn_gauss_mlp`` twice a node with parents."""
    from test_torch_node_planes import parent_per_node_trace
    from vbnbench import registry, run
    from vectorizedbayesiannetwork_torch.inference import _dynamic_sweep as dsw

    cell = run.Cell(registry.load_benchmark(), "gauss8-gnn-lw.mixed96",
                    2**31 + 2026, "cuda", {"n_samples": 1 << 14})
    vbn = cell.fit()
    serve = cell.server(vbn)
    call = cell.calls[0]
    assert len(call.queries) == 96
    rows = []
    for patch in (False, True):
        if patch:
            monkeypatch.setattr(dsw, "_per_node_trace", parent_per_node_trace)
        vbn._keys.set_state(500)
        sweeps, mlp = dsw.SWEEPS["target_planes"], _launch.LAUNCHES["gauss_mlp"]
        rows.append(np.asarray(serve(call)))
        assert dsw.SWEEPS["target_planes"] - sweeps == (0 if patch else 1)
        assert _launch.LAUNCHES["gauss_mlp"] - mlp == 8
    assert rows[0].shape == (96, 2) and np.isfinite(rows[0]).all()
    assert torch.equal(torch.as_tensor(rows[0]), torch.as_tensor(rows[1]))


_LAUNCH = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
           "cuLaunchKernelEx"}
_SYNC = {"cudaStreamSynchronize", "cudaDeviceSynchronize"}


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["static_pmf", "dynamic_pmf",
                                   "kde_dynamic_moments"])
def test_the_host_waits_for_the_card_only_in_wait_spans(asia_vbn, kde_vbn,
                                                        route):
    """Under the profiler a served call waits for queued device work only
    inside ``vbn.sync`` (``profiling.wait``) or ``vbn.fetch``: every
    other host sync inside its ``vbn.call`` comes with no kernel launched
    since the last sync, so the spans the host-time readers take hold the
    host's work, not the card's."""
    from torch.profiler import ProfilerActivity, profile

    from vectorizedbayesiannetwork_torch.utils import profiling

    vbn = kde_vbn if route == "kde_dynamic_moments" else asia_vbn
    vbn.set_inference_method("likelihood_weighting", n_samples=S,
                             dynamic_masks=route != "static_pmf")
    if vbn is kde_vbn:
        x0 = np.linspace(-1, 1, B).reshape(B, 1).astype(np.float32)
        qs = [{"target": "x2", "evidence": {"x0": x0}},
              {"target": "x0", "evidence": {"x2": x0}}]

        def serve():
            return vbn.infer_posterior_moments(qs)
    else:
        qs = [{"target": "dysp", "evidence": {"smoke": np.ones((B, 1), np.float32)}},
              {"target": "lung", "evidence": {"xray": np.zeros((B, 1), np.float32)}}]

        def serve():
            return vbn.infer_posterior_pmf(qs, n_classes=2)

    serve()
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        serve()
        torch.cuda.synchronize()
    names = [r["name"] for r in profiling.spans()]
    profiling.reset_spans()
    vbn.set_inference_method("likelihood_weighting", n_samples=S)
    assert "vbn.sync" in names and "vbn.fetch" in names
    host = sorted((e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: e.time_range.start)

    def ranges(name):
        return [(e.time_range.start, e.time_range.end) for e in host
                if e.name == name]

    (c0, c1), = ranges("vbn.call")
    waits = ranges("vbn.sync") + ranges("vbn.fetch")
    launches = [e.time_range.start for e in host if e.name in _LAUNCH]
    syncs = [e for e in host if e.name in _SYNC and c0 <= e.time_range.start <= c1]
    assert launches and syncs
    last = c0
    for e in syncs:
        t = e.time_range.start
        if not any(a <= t <= b for a, b in waits):
            behind = [x for x in launches if last < x < t]
            up = e.cpu_parent.name if e.cpu_parent is not None else None
            assert not behind, (route, up, len(behind))
        last = max(last, e.time_range.end)


# ---------------------------------------------------------------------------
# Exact engines on the card (no hand kernel): the same rows as on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["categorical_exact", "gaussian_exact"])
def test_exact_engines_on_the_card_match_the_cpu(asia_vbn, lg_vbn, method,
                                                tmp_path):
    """asia pmf rows (enumeration) within 1e-5, flagship moments (closed
    form, float32 matmuls without TF32) within 1e-5 absolute; no launch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    vbn = asia_vbn if method == "categorical_exact" else lg_vbn
    vbn.set_inference_method(method)
    vbn.save(str(tmp_path / "m.npz"))
    cpu = VBN.load(str(tmp_path / "m.npz"), device="cpu")
    if method == "categorical_exact":
        q = {"target": "lung", "evidence": {
            "xray": (np.arange(B) % 2).reshape(B, 1).astype(np.float32),
            "dysp": np.ones((B, 1), np.float32)}}
        serve = lambda v: v.infer_posterior_pmf([q], n_classes=2)[0]
    else:
        q = {"target": "x0", "evidence": {
            "x2": np.linspace(-1, 1, B).reshape(B, 1).astype(np.float32)}}
        serve = lambda v: v.infer_posterior_moments([q])[0]
    before = dict(_launch.LAUNCHES)
    got = serve(vbn)
    assert dict(_launch.LAUNCHES) == before
    assert vbn._last_summary_path == "fused"
    np.testing.assert_allclose(got, serve(cpu), atol=1e-5)
    vbn.set_inference_method(
        "likelihood_weighting" if method == "categorical_exact"
        else "monte_carlo_marginalization", n_samples=S)


# ---------------------------------------------------------------------------
# Neural CPDs on the card (torch products; gaussian_nn's served forward on
# ops/mlp_fused.py's kernel)
# ---------------------------------------------------------------------------

NN_FIT = {"epochs": 5, "batch_size": 256, "lr": 1e-2}
NN_FAMILIES = {
    "gaussian_nn": {"hidden_dims": [32, 32]},
    "mdn": {"hidden_dims": [32, 32], "n_components": 3},
    "rff_gaussian": {"n_features": 256},
    "softmax_nn": {"hidden_dims": [32, 32], "n_classes": 8},
    "categorical_embedded_softmax": {"hidden_dims": [64, 64],
                                     "embedding_dim": 8},
}


def _nn_rows(family, n=2048, seed=0):
    g = np.random.default_rng(seed)
    x0, x1 = g.normal(size=n), g.normal(size=n)
    data = {"x0": x0, "x1": x1, "x2": 0.5 * x0 - 0.2 * x1 + 0.1 * g.normal(size=n)}
    if family in ("softmax_nn", "categorical_embedded_softmax"):
        data = {k: np.rint(np.clip(v * 2 + 4, 0, 7)) for k, v in data.items()}
    return {k: v.astype(np.float32) for k, v in data.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(NN_FAMILIES))
def test_neural_cpd_on_the_card_matches_the_cpu(card, family, tmp_path):
    """A port fit on the card, its params moved to the CPU: log-densities
    and the protocol methods within 1e-5 of their scale in float32 (no
    TF32), and bf16 products on both sides within the JAX package's bf16
    tolerance (rtol 0.05, atol 0.15). ``gaussian_nn``'s float32
    log-density launches ``vbn_gauss_mlp`` once and counts it in ``MLP``;
    no other family, and no bf16 product, launches it."""
    import copy

    from vectorizedbayesiannetwork_torch.utils.profiling import MLP

    torch.backends.cuda.matmul.allow_tf32 = False
    data = _nn_rows(family)
    vbn = VBN({"x0": [], "x1": [], "x2": ["x0", "x1"]}, seed=0, device=card)
    vbn.set_learning_method("node_wise", nodes_cpds={
        k: dict(defaults.cpd(family), **NN_FAMILIES[family], fit=NN_FIT)
        for k in data})
    vbn.fit(data)
    cpd, params = vbn.nodes["x2"], vbn.params["x2"]
    vbn.save(str(tmp_path / "m.npz"))
    cpu_params = VBN.load(str(tmp_path / "m.npz"), device="cpu").params["x2"]
    par = torch.as_tensor(np.stack([data["x0"], data["x1"]], 1))
    x = torch.as_tensor(data["x2"][:, None])

    def methods(c, p, pa, xx):
        out = {"log_prob": c._log_prob_flat(p, xx, pa)}
        for name in ("categorical_probs", "conditional_params",
                     "mixture_params"):
            if hasattr(c, name):
                res = getattr(c, name)(p, pa)
                res = res if isinstance(res, tuple) else (res,)
                out.update({f"{name}{i}": r for i, r in enumerate(res)})
        return out

    before = (_launch.LAUNCHES["gauss_mlp"], MLP["fused"], MLP["fused_rows"])
    got = methods(cpd, params, par.to(card), x.to(card))
    fused = family == "gaussian_nn"
    assert (_launch.LAUNCHES["gauss_mlp"], MLP["fused"], MLP["fused_rows"]) == (
        before[0] + fused, before[1] + fused, before[2] + fused * x.shape[0])
    want = methods(cpd, cpu_params, par, x)
    for k, w in want.items():
        scale = float(w.abs().max())
        assert float((got[k].cpu() - w).abs().max()) <= 1e-5 * scale, k
    if hasattr(cpd, "compute_dtype"):
        bf = copy.copy(cpd)
        bf.compute_dtype = "bfloat16"
        before = _launch.LAUNCHES["gauss_mlp"]
        torch.testing.assert_close(
            bf._log_prob_flat(params, x.to(card), par.to(card)).cpu(),
            bf._log_prob_flat(cpu_params, x, par), rtol=0.05, atol=0.15)
        assert _launch.LAUNCHES["gauss_mlp"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("side", ["below", "above"])
@pytest.mark.parametrize("dp", [1, 2, 3, 4])
def test_gauss_mlp_holds_the_plain_route(card, dp, side):
    """``vbn_gauss_mlp`` at 1-4 parents against ``_denorm_params`` (the
    plain route, float32 without TF32) and against ``gauss_mlp_plain``:
    loc within 1e-5 of ``std_y``, scale within 1e-5 relative, with the
    softplus inputs all below or all above its threshold of 20; one launch
    a call."""
    from vectorizedbayesiannetwork_torch.models._mlp import mlp_apply
    from vectorizedbayesiannetwork_torch.models.gaussian_nn import GaussianNNCPD
    from vectorizedbayesiannetwork_torch.ops import mlp_fused

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(90 + dp)
    cpd = GaussianNNCPD(dp, 1, hidden_dims=(32, 32), min_scale=1e-4)
    params = cpd.init("cpu", gen)
    params["stats"] = {"mean_x": torch.randn(dp, generator=gen),
                       "std_x": 0.5 + torch.rand(dp, generator=gen),
                       "mean_y": torch.randn(1, generator=gen),
                       "std_y": 0.5 + torch.rand(1, generator=gen)}
    params["net"]["layers"][-1]["b"][1] += 0.0 if side == "below" else 30.0
    params = {"net": {"layers": [{k: v.to(card) for k, v in layer.items()}
                                 for layer in params["net"]["layers"]]},
              "stats": {k: v.to(card) for k, v in params["stats"].items()}}
    net, stats = params["net"], params["stats"]
    m = (1 << 16) + 77  # a tail tile
    pa = 2.0 * torch.randn((m, dp), generator=gen).to(card)
    z = mlp_apply(net, (pa - stats["mean_x"]) / stats["std_x"], "relu")[:, 1]
    assert bool((z < 20).all() if side == "below" else (z > 20).all())
    assert mlp_fused.refusal(pa, net, stats, "relu", "float32") is None
    before = _launch.LAUNCHES["gauss_mlp"]
    got = mlp_fused.gauss_mlp(pa, net, stats, 1e-4)
    torch.cuda.synchronize()
    assert _launch.LAUNCHES["gauss_mlp"] == before + 1
    std_y = float(stats["std_y"])
    for want in (cpd._denorm_params(params, pa, m),
                 mlp_fused.gauss_mlp_plain(pa, net, stats, 1e-4)):
        assert float((got[0] - want[0]).abs().max()) <= 1e-5 * std_y
        assert float(((got[1] - want[1]).abs() / want[1]).max()) <= 1e-5


@pytest.mark.cuda
def test_bf16_product_takes_bf16_inputs_and_gives_float32(card):
    from vectorizedbayesiannetwork_torch.models import _mlp

    g = torch.Generator(device="cuda").manual_seed(5)
    h = torch.randn((4096, 64), generator=g, device="cuda")
    w = torch.randn((64, 32), generator=g, device="cuda")
    out = _mlp._bf16_product(h, w)
    assert out.dtype == torch.float32
    ref = h.bfloat16().double() @ w.bfloat16().double()
    scale = float(ref.abs().max())
    assert float((out.double() - ref).abs().max()) <= 1e-5 * scale
    rounded = (h.bfloat16() @ w.bfloat16()).double()
    assert float((rounded - ref).abs().max()) > 1e-5 * scale


@pytest.mark.cuda
def test_ris_over_neural_cpds_launches_the_resampling_kernels(card):
    """RIS on a gaussian_nn + mdn flagship resamples through vbn_cumsum
    and vbn_srg; IS and LW over it launch no hand kernel but the row
    stream's: in LW and IS one ``vbn_uniforms`` for the latent roots x0,
    x1 (one level group) a sweep (IS: two sweeps when it falls back); RIS
    walks node by node, one a latent node and one more for the resampling
    event's ``u0``."""
    data = _nn_rows("gaussian_nn")
    vbn = VBN({"x0": [], "x1": [], "x2": ["x0", "x1"]}, seed=0, device=card)
    conf = {k: dict(defaults.cpd("gaussian_nn"), fit=NN_FIT) for k in data}
    conf["x2"] = dict(defaults.cpd("mdn"), n_components=3, fit=NN_FIT)
    vbn.set_learning_method("node_wise", nodes_cpds=conf)
    vbn.fit(data)
    q = {"target": "x0", "evidence": {
        "x2": np.linspace(-1, 1, B).reshape(B, 1).astype(np.float32)}}
    for method, kw, launched in (
            ("resampled_importance_sampling", {"ess_threshold": 0.5},
             {"cumsum": 1, "srg": 1, "uniforms": 3}),
            ("importance_sampling", {}, None),
            ("likelihood_weighting", {}, {"uniforms": 1})):
        vbn.set_inference_method(method, n_samples=1 << 16, **kw)
        before = dict(_launch.LAUNCHES)
        w, samples = vbn.infer_posterior(q)
        torch.cuda.synchronize()
        diff = {k: v - before[k] for k, v in _launch.LAUNCHES.items()
                if v != before[k]}
        if launched is None:  # IS: the LW rerun sweeps again
            launched = {"uniforms": 2 if vbn._inference._last_fallback else 1}
        assert diff == launched, method
        assert torch.isfinite(samples).all() and not w.requires_grad


# ---------------------------------------------------------------------------
# Sampling on the card: the KDE log-density's gradient, Gibbs and HMC
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dx,dp,entry", [(2, 0, "kde_root"), (1, 2, "kde_cond"),
                                          (2, 40, "kde_cond_wide")])
def test_kde_gradient_on_the_card_matches_plain_autograd(card, dx, dp, entry):
    """With a gradient wanted, the forward still launches its kernel (one
    launch, within 1e-4 of the plain version); the closed-form backward
    holds ``torch.autograd`` of the plain version on the card within 1e-5
    relative to the gradient's scale."""
    from vectorizedbayesiannetwork_torch.ops import kde_kernel as kk

    data_x, data_p, lm = _kde_support(2000, dx, dp, 1700)
    x, p = _kde_queries(dx, max(dp, 1))
    x, p = x[:512].contiguous(), p[:512, :dp].contiguous() if dp else None
    w = torch.linspace(-1, 1, 512, device="cuda")
    tx = x.clone().requires_grad_(True)
    tp = p.clone().requires_grad_(True) if dp else None
    before = dict(_launch.LAUNCHES)
    out = kk.kde_log_prob(tx, tp, data_x, data_p, lm, 0.35, 0.6)
    got = torch.autograd.grad((out * w).sum(), [tx] + ([tp] if dp else []))
    torch.cuda.synchronize()
    diff = {k: v - before[k] for k, v in _launch.LAUNCHES.items()
            if v != before[k]}
    assert diff == {entry: 1}
    px = x.clone().requires_grad_(True)
    pp = p.clone().requires_grad_(True) if dp else None
    if dp:
        plain = kf.kde_cond_plain(px, pp, data_x, data_p, lm, 0.35, 0.6)
    else:
        plain = kf.kde_root_plain(px, data_x, lm, 0.35) - torch.log(
            torch.exp(lm).sum())
    torch.testing.assert_close(out.detach(), plain.detach(), atol=1e-4, rtol=0)
    ref = torch.autograd.grad((plain * w).sum(), [px] + ([pp] if dp else []))
    for a, b in zip(got, ref):
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gibbs", "hmc"])
def test_mcmc_over_kde_goes_through_the_kernels(kde_vbn, name):
    """Gibbs (candidates by ``vbn_kde_pick``, scores by ``vbn_kde_cond``)
    and HMC (the joint log-density by ``vbn_kde_root`` and ``vbn_kde_cond``
    and its closed-form backward) on the KDE flagship: the launches counted,
    the draws finite and rising with x2."""
    q = {"target": "x0", "evidence": {
        "x2": np.linspace(-1, 1, B).reshape(B, 1).astype(np.float32)}}
    kde_vbn.set_sampling_method(name)
    kw = ({"burn_in": 5, "n_chains": 16} if name == "gibbs" else
          {"burn_in": 5, "n_chains": 16, "step_size": 0.1, "n_leapfrog": 4})
    before = dict(_launch.LAUNCHES)
    s = kde_vbn.sample(q, n_samples=64, **kw)
    torch.cuda.synchronize()
    diff = {k: v - before[k] for k, v in _launch.LAUNCHES.items()
            if v != before[k]}
    steps = 5 + 4  # burn-in + draws a chain
    if name == "gibbs":
        # the init sweep picks 2 nodes (their noise: a vbn_uniforms launch
        # each); each step 2 latent nodes x (1 pick and its noise, 1 child's
        # conditional), and one vbn_uniforms launch for the step's Gumbels
        assert diff == {"kde_pick": 2 + 2 * steps, "kde_cond": 2 * steps,
                        "uniforms": 2 + 3 * steps}
    else:
        evals = 1 + 4  # a transition's gradient evaluations
        # a transition draws its momentum and its accept uniforms: one
        # vbn_uniforms launch each
        assert diff == {"kde_pick": 2, "kde_root": 2 * evals * steps,
                        "kde_cond": evals * steps, "uniforms": 2 + 2 * steps}
    assert tuple(s.shape) == (B, 64, 1) and torch.isfinite(s).all()
    means = s[..., 0].mean(dim=1).cpu().numpy()
    assert means[-1] > means[0]


# ---------------------------------------------------------------------------
# The grouped neural fit, LBP, RBM and the amortizer on the card (torch ops;
# no hand kernel of their own)
# ---------------------------------------------------------------------------


def _star(card, cpd_name, grouping, monkeypatch):
    """z -> y0..y3 (tests/test_fit_grouping.py), each y ``cpd_name``."""
    monkeypatch.setenv("VBN_FIT_GROUP", grouping)
    g = np.random.default_rng(0)
    z = g.normal(size=600)
    data = {"z": z, **{f"y{i}": (0.3 + 0.2 * i) * z + 0.1 * g.normal(size=600)
                       for i in range(4)}}
    cfg = dict(defaults.cpd(cpd_name), hidden_dims=[16])
    cfg["fit"] = {**cfg["fit"], "epochs": 4, "batch_size": 128,
                  "max_grad_norm": 0.5}
    vbn = VBN([("z", f"y{i}") for i in range(4)], seed=0, device=card)
    vbn.set_learning_method("node_wise", nodes_cpds={
        "z": defaults.cpd("linear_gaussian"),
        **{f"y{i}": cfg for i in range(4)}})
    vbn.fit(data)
    return vbn


@pytest.mark.cuda
@pytest.mark.parametrize("cpd_name", ["gaussian_nn", "mdn"])
def test_grouped_fit_on_the_card_matches_sequential(card, cpd_name,
                                                    monkeypatch):
    """The bmm group against the per-node loop on the card, clipped: every
    leaf within rtol 2e-3 / atol 2e-4 (the JAX grouping test's limits)."""
    from vectorizedbayesiannetwork_torch.models._optim import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    grouped = _star(card, cpd_name, "always", monkeypatch)
    seq = _star(card, cpd_name, "never", monkeypatch)
    for i in range(4):
        for a, b in zip(tree_leaves(grouped.params[f"y{i}"]),
                        tree_leaves(seq.params[f"y{i}"])):
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                       rtol=2e-3, atol=2e-4)


@pytest.mark.cuda
def test_amortized_heads_on_the_card_match_the_cpu(card):
    """An amortizer fitted on the card, its net moved to the CPU: the heads
    of 4096 masked rows within 1e-5 of their scale; serving launches one
    kernel, the target's noise (``vbn_uniforms``)."""
    from vectorizedbayesiannetwork_torch.learning.amortized import (
        amortized_forward,
    )
    from vectorizedbayesiannetwork_torch.models._optim import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    data = _nn_rows("gaussian_nn")
    vbn = VBN([("x0", "x2"), ("x1", "x2")], seed=0, device=card)
    vbn.set_learning_method("amortized", nodes_cpds={
        k: defaults.cpd("linear_gaussian") for k in data},
        epochs=3, batch_size=512, hidden_dims=[32, 32], n_do_sets=2)
    vbn.fit(data)
    spec, net = vbn.amortized["spec"], vbn.amortized["net"]
    g = torch.Generator(device=card).manual_seed(0)
    rows = torch.randn((4096, spec.total_dim), generator=g, device=card)
    mask = (torch.rand((4096, spec.n_nodes), generator=g, device=card)
            < 0.5).float()
    heads = amortized_forward(spec, net, rows, mask, mask * 0)
    cpu = amortized_forward(spec, tree_map(lambda t: t.cpu(), net),
                            rows.cpu(), mask.cpu(), mask.cpu() * 0)
    scale = float(cpu.abs().max())
    assert float((heads.cpu() - cpu).abs().max()) <= 1e-5 * scale
    vbn.set_inference_method("amortized", n_samples=256)
    before = dict(_launch.LAUNCHES)
    pdf, s = vbn.infer_posterior({"target": "x0", "evidence": {"x2": [[0.3]]}})
    diff = {k: v - before[k] for k, v in _launch.LAUNCHES.items()
            if v != before[k]}
    assert diff == {"uniforms": 1}
    assert not vbn._inference._last_fallback
    assert torch.isfinite(pdf).all() and tuple(s.shape) == (1, 256, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["lbp", "rbm_lg", "rbm_asia"])
def test_lbp_and_rbm_on_the_card_match_the_cpu(asia_vbn, lg_vbn, case,
                                               tmp_path):
    """The same call on the card and on the CPU (the model moved by a
    checkpoint): LBP's posterior means within 5 standard errors of each
    other (S = 2^16); RBM with every parent observed within 1e-5 (no draw
    reaches it); RBM on asia's pmf within 0.02 (2^14 particles). The
    torch-op sweeps launch no kernel but the row stream's (one
    ``vbn_uniforms`` a drawn node)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    if case == "rbm_asia":
        vbn = asia_vbn
        vbn.set_inference_method("rao_blackwellized_marginalization",
                                 n_samples=64, n_particles=1 << 14)
        q = {"target": "dysp", "evidence": {
            "smoke": (np.arange(B) % 2).reshape(B, 1).astype(np.float32),
            "asia": (np.arange(B) // 2).reshape(B, 1).astype(np.float32)}}
    elif case == "rbm_lg":
        vbn = lg_vbn
        vbn.set_inference_method("rao_blackwellized_marginalization",
                                 n_samples=64, n_particles=1024)
        x = np.linspace(-1, 1, B).reshape(B, 1).astype(np.float32)
        q = {"target": "x2", "evidence": {"x0": x, "x1": x[::-1].copy()}}
    else:
        vbn = lg_vbn
        vbn.set_inference_method("lbp", n_samples=1 << 16)
        q = {"target": "x0", "evidence": {
            "x2": np.linspace(-1, 1, B).reshape(B, 1).astype(np.float32)}}
    vbn.save(str(tmp_path / "m.npz"))
    cpu = VBN.load(str(tmp_path / "m.npz"), device="cpu")
    before = dict(_launch.LAUNCHES)
    got = vbn.infer_posterior(q)
    diff = {k: v - before[k] for k, v in _launch.LAUNCHES.items()
            if v != before[k]}
    if case == "rbm_lg":  # every parent observed: RBM draws nothing
        assert diff == {}
    else:
        assert set(diff) == {"uniforms"}
    want = cpu.infer_posterior(q)
    assert not vbn._inference._last_fallback
    if case == "rbm_asia":
        np.testing.assert_allclose(got[0].cpu().numpy(), want[0].numpy(),
                                   atol=0.02)
    elif case == "rbm_lg":
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-5 * float(b.abs().max()))
    else:
        st_g = vbn._posterior_stats(*got)
        st_c = cpu._posterior_stats(*want)
        se = (st_c["std"] / torch.sqrt(st_c["ess"][:, None])).numpy()
        diff = np.abs(st_g["mean"].cpu().numpy() - st_c["mean"].numpy())
        assert np.all(diff < 5 * np.sqrt(2) * se)
    vbn.set_inference_method(
        "likelihood_weighting" if case == "rbm_asia"
        else "monte_carlo_marginalization", n_samples=S)


def _asia_conf():
    bn = asia()
    conf = {}
    for node in bn.nodes:
        c = dict(defaults.cpd("categorical_table"), n_classes=bn.card(node))
        if bn.parents[node]:
            c["parent_n_classes"] = [bn.card(p) for p in bn.parents[node]]
        conf[node] = c
    return bn, conf


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["to_device", "load_map_location"])
def test_moved_model_serves_the_card_fitted_rows(asia_vbn, how, tmp_path):
    """asia fitted on the CPU, then moved to the card by ``to_device`` or
    by ``load(map_location="cuda")``: at the same key counter it serves the
    card-fitted model's pmf rows bit for bit, through the sweep kernel
    (integer counts: both fits are the same tables)."""
    bn, conf = _asia_conf()
    cpu = VBN({n: bn.parents[n] for n in bn.nodes}, seed=0, device="cpu")
    cpu.set_learning_method("node_wise", nodes_cpds=conf)
    cpu.fit(generate_dataset(bn, 4096, seed=0))
    if how == "to_device":
        moved = cpu
        moved.to_device("cuda")
    else:
        cpu.save(str(tmp_path / "asia.npz"))
        moved = VBN.load(str(tmp_path / "asia.npz"), map_location="cuda")
    assert all(t.is_cuda for p in moved.params.values() for t in p.values())
    moved.set_inference_method("likelihood_weighting", n_samples=S)
    q = {"target": "dysp", "evidence": {
        "smoke": (np.arange(B) % 2).reshape(B, 1).astype(np.float32)}}
    counter = asia_vbn._keys.state()
    moved._keys.set_state(counter)
    before = _launch.LAUNCHES["categorical"]
    got, _ = moved.infer_posterior_pmf([q], n_classes=2)
    asia_vbn._keys.set_state(counter)
    want, _ = asia_vbn.infer_posterior_pmf([q], n_classes=2)
    assert _launch.LAUNCHES["categorical"] == before + 2
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["gumbel", "class_loop", "gaussian"])
def test_stacked_forms_on_the_card_match_the_cpu(card, form, monkeypatch):
    """The stacked-table sweeps of a 70-node network on the card and on
    the CPU, fed the same external noise with per-row masks: categorical
    states equal, log-weights within 1e-5; Gaussian states and weights
    within 1e-5 + 1e-6 of their magnitude."""
    from benchmarking.gaussian_bn import random_gaussian
    from benchmarking.networks import random_bn_treewidth
    from vectorizedbayesiannetwork_torch.inference import _discrete_sweep
    from vectorizedbayesiannetwork_torch.inference import _gaussian_sweep

    monkeypatch.setenv("VBN_SCAN_CLASS_LOOP",
                       "always" if form == "class_loop" else "never")
    rng = np.random.default_rng(0)
    if form == "gaussian":
        gbn = random_gaussian(70, seed=0)
        vbn = VBN({n: gbn.parents[n] for n in gbn.nodes}, seed=0, device="cpu")
        vbn.set_learning_method("node_wise", nodes_cpds={
            n: defaults.cpd("linear_gaussian") for n in gbn.nodes})
        vbn.fit(gbn.sample(4096, seed=0))
        trace = _gaussian_sweep.gaussian_sweep_trace
    else:
        bn = random_bn_treewidth(70, seed=0)
        vbn = VBN({n: bn.parents[n] for n in bn.nodes}, seed=0, device="cpu")
        conf = {}
        for node in bn.nodes:
            c = dict(defaults.cpd("categorical_table"), n_classes=bn.card(node))
            if bn.parents[node]:
                c["parent_n_classes"] = [bn.card(p) for p in bn.parents[node]]
            conf[node] = c
        vbn.set_learning_method("node_wise", nodes_cpds=conf)
        vbn.fit(generate_dataset(bn, 4096, seed=0))
        trace = _discrete_sweep.discrete_sweep_trace
    plan, cpds, params = _plan(vbn, target=vbn.dag.topological_order()[0],
                               evidence={}, do={})
    n, b, s = plan.n_nodes, B, 256
    ev = np.zeros((b, n), np.float32)
    do = np.zeros((b, n), np.float32)
    tgt = np.zeros((b, n), np.float32)
    for r in range(b):
        t, e1, e2, d = rng.choice(n, 4, replace=False)
        ev[r, [e1, e2]], do[r, d], tgt[r, t] = 1.0, 1.0, 1.0
    if form == "gaussian":
        fixed = rng.normal(size=(b, n)).astype(np.float32)
        noise = rng.normal(size=(b, s, n)).astype(np.float32)
    else:
        fixed = np.zeros((b, n), np.float32)
        cmax = _discrete_sweep._static_tables(plan, cpds)["cmax"]
        u = rng.random(size=(n, b, s) if form == "class_loop"
                       else (n, b, s, cmax)).astype(np.float32)
        noise = (u if form == "class_loop"
                 else -np.log(-np.log(np.maximum(u, 1e-30))))
    inputs = [torch.from_numpy(a) for a in (fixed, ev, np.maximum(ev, do),
                                            tgt, noise)]
    outs = {}
    for dev in ("cpu", "cuda"):
        f, e, fx, tg, nz = (t.to(dev) for t in inputs)
        p = tuple({k: v.to(dev) for k, v in pp.items()} for pp in params)
        outs[dev] = [o.cpu() for o in trace(
            plan, cpds, p, None, f, s, weighted=True, ev_mask_arr=e,
            fx_mask_arr=fx, tgt_mask_arr=tg, noise=nz)]
    got, want = outs["cuda"], outs["cpu"]
    if form == "gaussian":
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, atol=1e-5, rtol=1e-6)
    else:
        assert torch.equal(got[0], want[0])
        for a, w in zip(got[1:], want[1:]):
            torch.testing.assert_close(a, w, atol=1e-5, rtol=1e-6)


@pytest.fixture(scope="module")
def nccl_mesh(card):
    """A one-rank NCCL group and its (1, 1) mesh in this process."""
    import torch.distributed as dist

    from vectorizedbayesiannetwork_torch.parallel import (
        initialize_distributed,
        make_mesh,
    )

    initialize_distributed()
    assert dist.get_backend() == "nccl"
    yield make_mesh()
    dist.destroy_process_group()


def _mesh_raws(vbn, want, mesh, scan):
    """(meshed raw, unmeshed raw, their arguments, uniform rows a particle)
    of the flagship's / asia's sweep kernel or scan kernel."""
    from vectorizedbayesiannetwork_torch.core.plan import pack_fixed_values
    from vectorizedbayesiannetwork_torch.ops.sweep_scan import (
        make_scan_sweep_fn,
    )

    lg = "x2" in vbn.nodes
    query = (Query("x2", {"x0": np.linspace(-1, 1, B).reshape(B, 1)
                          .astype(np.float32)}, {}) if lg else
             Query("dysp", {"smoke": (np.arange(B) % 2).reshape(B, 1)
                            .astype(np.float32)}, {}))
    if scan:
        plan, cpds, params = _canonical(vbn)
        fixed = torch.as_tensor(pack_fixed_values(query, plan, B), device="cuda")
        ev = torch.zeros((B, plan.n_nodes), device="cuda")
        ev[:, plan.topo_order.index(next(iter(query.evidence)))] = 1.0
        tgt = torch.full((B,), plan.topo_order.index(query.target),
                         dtype=torch.int32, device="cuda")
        args = (fixed, ev, torch.zeros_like(ev), tgt)
        make = make_scan_sweep_fn
    else:
        plan, cpds, params = _plan(vbn, target=query.target,
                                   evidence=query.evidence, do={})
        args = (torch.as_tensor(pack_fixed_values(query, plan, B),
                                device="cuda"),)
        make = sweep.make_fused_sweep_fn
    return (make(plan, cpds, S, want, mesh=mesh), make(plan, cpds, S, want),
            (params, 3) + args, plan.n_nodes * (2 if lg else 1))


@pytest.mark.cuda
@pytest.mark.parametrize("scan", [False, True], ids=["sweep", "scan"])
@pytest.mark.parametrize("model,want", [("asia", w) for w in CAT_WANTS]
                         + [("lg", w) for w in LG_WANTS],
                         ids=lambda v: v if isinstance(v, str) else "-".join(v))
def test_one_rank_mesh_equals_unmeshed_kernel(asia_vbn, lg_vbn, nccl_mesh,
                                              model, want, scan):
    """Under a one-rank NCCL mesh each kernel path launches its kernel once
    and, on the same external uniforms, gives the unmeshed launch's outputs
    bit for bit (one shard: the combine scales by exp(0) and sums one
    rank)."""
    vbn = asia_vbn if model == "asia" else lg_vbn
    meshed, whole, args, rows = _mesh_raws(vbn, want, nccl_mesh, scan)
    u = torch.rand((B, rows, S), device="cuda").clamp_(1e-6, 1 - 1e-6)
    key = {("asia", False): "categorical", ("lg", False): "lg",
           ("asia", True): "categorical_scan", ("lg", True): "lg_scan"}[
        (model, scan)]
    before = _launch.LAUNCHES[key]
    got = meshed(*args, u_ext=u)
    assert _launch.LAUNCHES[key] == before + 1
    ref = whole(*args, u_ext=u)
    for a, b in zip(got[:3], ref[:3]):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    assert (got[3] is None) == (ref[3] is None)
    if got[3] is not None:
        assert torch.equal(got[3][0], ref[3][0])
        assert torch.equal(got[3][1], ref[3][1])


@pytest.mark.cuda
def test_one_rank_mesh_serves_through_the_kernels(asia_vbn, lg_vbn, nccl_mesh):
    """``set_mesh`` on the card: the public entry points launch one kernel a
    batch and serve finite rows on the fused path."""
    q = {"target": "dysp", "evidence": {"smoke": np.ones((B, 1), np.float32)}}
    ev = {"x0": np.zeros((B, 1), np.float32), "x1": np.ones((B, 1), np.float32)}
    try:
        for v in (asia_vbn, lg_vbn):
            v.set_mesh(nccl_mesh)
        before = dict(_launch.LAUNCHES)
        pmf, _ = asia_vbn.infer_posterior_pmf([q], n_classes=2)
        mom, _ = lg_vbn.infer_posterior_moments([{"target": "x2", "evidence": ev}])
    finally:
        for v in (asia_vbn, lg_vbn):
            v.set_mesh(None)
    assert asia_vbn._last_summary_path == lg_vbn._last_summary_path == "fused"
    assert np.isfinite(pmf).all() and np.isfinite(mom).all()
    assert _launch.LAUNCHES["categorical"] == before["categorical"] + 1
    assert _launch.LAUNCHES["lg"] == before["lg"] + 1


# ---------------------------------------------------------------------------
# The row stream: vbn_uniforms against its plain version
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("k,at", [(1, 0), (4, 0), (3, 2), (5, 7), (130, 1)])
def test_uniforms_kernel_equals_its_plain_version(card, k, at):
    """``vbn_uniforms`` against ``core/rng.py::stream_values`` run in torch
    ops on the card: uniforms bit for bit, on a block off the origin."""
    from vectorizedbayesiannetwork_torch.core.rng import stream_values as plain
    from vectorizedbayesiannetwork_torch.ops import rng

    seed, b, s = 0x0123456789ABCDEF, 3, 5000
    before = _launch.LAUNCHES["uniforms"]
    got = rng.stream_values(seed, b, s, 17, k, at=at, row0=5, particle0=1000,
                            device=card)
    assert _launch.LAUNCHES["uniforms"] == before + 1
    want = plain(seed, b, s, 17, k, at=at, row0=5, particle0=1000, device=card)
    assert torch.equal(got, want)
    assert bool(((got > 0) & (got < 1)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("k,at", [(1, 0), (2, 4), (3, 2)])
def test_normals_kernel_within_rounding_of_its_plain_version(card, k, at):
    """Box-Muller normals: the kernel's logf, sqrtf and cosf against
    torch's within 2e-6 of |z| + 1."""
    from vectorizedbayesiannetwork_torch.core.rng import stream_values as plain
    from vectorizedbayesiannetwork_torch.ops import rng

    seed, b, s = 77, 4, 1 << 16
    got = rng.stream_values(seed, b, s, 3, k, at=at, normal=True, device=card)
    want = plain(seed, b, s, 3, k, at=at, normal=True, device=card)
    err = ((got - want).abs() / (want.abs() + 1.0)).max().item()
    assert err <= 2e-6, err
    assert abs(got.mean().item()) < 5 / np.sqrt(got.numel())


NODE_LISTS = {1: [17], 64: [(7 * i + 5) % 211 for i in range(64)]}


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 64])
@pytest.mark.parametrize("k,at,normal", [(1, 0, False), (4, 0, False),
                                         (1, 3, False), (4, 5, False),
                                         (1, 0, True), (4, 2, True)])
@pytest.mark.parametrize("row0,particle0", [(0, 0), (3, 1 << 12)])
def test_uniforms_kernel_draws_a_list_of_nodes(card, g, k, at, normal, row0,
                                               particle0):
    """One launch for G nodes against the plain ``stream_values_many`` on
    the card: uniforms bit for bit, normals within 2e-6 of |z| + 1; at
    G = 1 and 64, k = 1 and 4, odd ``at``, and a block off the origin
    (S = 1500: a partial last block of particles)."""
    from vectorizedbayesiannetwork_torch.core.rng import (
        stream_values_many as plain,
    )
    from vectorizedbayesiannetwork_torch.ops import rng

    seed, b, s = 0x0123456789ABCDEF, 3, 1500
    nodes = NODE_LISTS[g]
    before = _launch.LAUNCHES["uniforms"]
    got = rng.stream_values_many(seed, b, s, nodes, k, at=at, normal=normal,
                                 row0=row0, particle0=particle0, device=card)
    assert _launch.LAUNCHES["uniforms"] == before + 1
    want = plain(seed, b, s, nodes, k, at=at, normal=normal, row0=row0,
                 particle0=particle0, device=card)
    assert got.shape == (g, b * s, k)
    if normal:
        err = ((got - want).abs() / (want.abs() + 1.0)).max().item()
        assert err <= 2e-6, err
    else:
        assert torch.equal(got, want)
        assert bool(((got > 0) & (got < 1)).all())


@pytest.mark.cuda
def test_uniforms_launches_once_a_64_nodes(card):
    """64 nodes are one launch, 65 two; the 65th node's values are its own
    single-node launch's."""
    from vectorizedbayesiannetwork_torch.ops import rng

    nodes = list(range(100, 165))
    before = _launch.LAUNCHES["uniforms"]
    a = rng.stream_values_many(5, 2, 4096, nodes[:64], 1, device=card)
    assert _launch.LAUNCHES["uniforms"] == before + 1
    b = rng.stream_values_many(5, 2, 4096, nodes, 1, device=card)
    assert _launch.LAUNCHES["uniforms"] == before + 3
    assert torch.equal(b[:64], a)
    assert torch.equal(b[64], rng.stream_values(5, 2, 4096, 164, 1,
                                                device=card))


@pytest.mark.cuda
def test_uniforms_take_32_bit_node_words(card):
    """The chain samplers' counter words reach 2^32 - 1: the kernel takes
    them as unsigned words (bit for bit against the plain version), and a
    word of 2^32 raises."""
    from vectorizedbayesiannetwork_torch.core.rng import stream_values_many
    from vectorizedbayesiannetwork_torch.ops import rng

    nodes = [(1 << 31) - 1, 1 << 31, (1 << 32) - 1, 3]
    got = rng.stream_values_many(17, 2, 300, nodes, 3, device=card).cpu()
    assert torch.equal(got, stream_values_many(17, 2, 300, nodes, 3))
    with pytest.raises(ValueError, match="out of range"):
        rng.stream_values_many(17, 2, 300, [1 << 32], 1, device=card)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gibbs", "hmc", "nuts"])
def test_chain_samplers_row0_on_the_card(card, name):
    """Row 0 of B=2 equals B=1 bit for bit on the card (the LG flagship,
    x0 | x2, at a fixed step), and each call launches ``vbn_uniforms``."""
    from chip_smoke import fit_flagship

    vbn = fit_flagship(VBN, defaults)
    vbn.set_sampling_method(name)
    ev = np.array([[0.5], [-1.0]], np.float32)
    kw = dict(n_samples=32, burn_in=5, n_chains=4, step_size=0.2,
              max_tree_depth=4)
    outs = []
    for b in (2, 1):
        vbn._keys.set_state(500)
        before = _launch.LAUNCHES["uniforms"]
        outs.append(vbn.sample({"target": "x0", "evidence": {"x2": ev[:b]}},
                               **kw).cpu())
        assert _launch.LAUNCHES["uniforms"] > before
    assert torch.equal(outs[0][0], outs[1][0])
    assert not torch.equal(outs[0][0], outs[0][1])


def _star_vbn(card, family):
    g = np.random.default_rng(0)
    n = 2048
    z = g.normal(size=n)
    data = {"z": z}
    for i in range(4):
        data[f"y{i}"] = (0.4 + 0.2 * i) * z + 0.1 * g.normal(size=n)
    data["t"] = sum(data[f"y{i}"] for i in range(4)) + 0.1 * g.normal(size=n)
    vbn = VBN([("z", f"y{i}") for i in range(4)]
              + [(f"y{i}", "t") for i in range(4)], seed=0, device=card)
    sib = (dict(defaults.cpd("gaussian_nn"), hidden_dims=[16], fit=NN_FIT)
           if family == "gaussian_nn" else defaults.cpd("linear_gaussian"))
    vbn.set_learning_method("node_wise", nodes_cpds={
        "z": defaults.cpd("linear_gaussian"), "t": defaults.cpd(
            "linear_gaussian"), **{f"y{i}": sib for i in range(4)}})
    vbn.fit({k: v.astype(np.float32) for k, v in data.items()})
    return vbn


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["gaussian_nn", "linear_gaussian"])
@pytest.mark.parametrize("method,evidence", [
    ("monte_carlo_marginalization", "z"),
    ("likelihood_weighting", "z"), ("likelihood_weighting", "siblings")])
def test_grouped_sweep_on_the_card_equals_ungrouped(card, family, method,
                                                    evidence, monkeypatch):
    """The star's siblings y0..y3 as one level group on the card against
    ``VBN_LEVEL_GROUP=never`` at the JAX grouping test's tolerances
    (samples rtol 1e-4, atol 1e-4; pdf rtol 1e-4, atol 1e-5); grouped, the
    siblings' draws are one ``vbn_uniforms`` launch, ungrouped one a node.
    S = 4000, off the fused LG kernels' 1024 grid."""
    from vectorizedbayesiannetwork_torch.inference import _sweep

    torch.backends.cuda.matmul.allow_tf32 = False
    vbn = _star_vbn(card, family)
    b = 3
    q = ({"target": "t", "evidence": {"z": [[0.3]] * b}} if evidence == "z"
         else {"target": "t", "evidence": {f"y{i}": [[0.2 * i]] * b
                                           for i in range(4)}})
    out = {}
    for mode in ("auto", "never"):
        monkeypatch.setenv("VBN_LEVEL_GROUP", mode)
        vbn.set_inference_method(method, n_samples=4000)
        vbn._keys.set_state(9)
        _sweep.GROUPS.clear()
        before = _launch.LAUNCHES["uniforms"]
        w, s = vbn.infer_posterior(q)
        torch.cuda.synchronize()
        out[mode] = (w.cpu().numpy(), s.cpu().numpy(),
                     _launch.LAUNCHES["uniforms"] - before, dict(_sweep.GROUPS))
    (wg, sg, lg_, gg), (wn, sn, ln, gn) = out["auto"], out["never"]
    kind = "sample" if evidence == "z" else "log_prob"
    assert gg == {f"{kind}_calls": 1, f"{kind}_nodes": 4} and gn == {}
    # latent siblings: one launch for the four; observed: they draw nothing
    assert ln - lg_ == (3 if evidence == "z" else 0) and lg_ >= 1
    np.testing.assert_allclose(sg, sn, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(wg, wn, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["gumbel", "class_loop", "gaussian"])
def test_stacked_forms_chunked_draws_equal_per_node_draws(card, asia_vbn,
                                                          lg_vbn, form,
                                                          monkeypatch):
    """The stacked forms draw a chunk of nodes a ``vbn_uniforms`` launch:
    on the card the form equals the form fed each node's own single-node
    draws as ``noise``, bit for bit, and draws in one launch (asia's 8
    and the flagship's 3 nodes: one chunk)."""
    from vectorizedbayesiannetwork_torch.core.plan import pack_fixed_values
    from vectorizedbayesiannetwork_torch.core.rng import Draw, RowStream
    from vectorizedbayesiannetwork_torch.inference._discrete_sweep import (
        discrete_sweep_trace,
    )
    from vectorizedbayesiannetwork_torch.inference._gaussian_sweep import (
        gaussian_sweep_trace,
    )

    vbn = lg_vbn if form == "gaussian" else asia_vbn
    b = 2
    if form == "gaussian":
        q = Query(target="x0", evidence={"x2": np.array([[0.3], [-0.2]],
                                                        np.float32)})
    else:
        q = Query(target="dysp", evidence={
            "smoke": np.array([[1.0], [0.0]], np.float32)})
    plan = get_plan(vbn, q)
    cpds = [vbn.cpd_spec(n) for n in plan.topo_order]
    params = tuple(vbn.params[n] for n in plan.topo_order)
    fixed = torch.as_tensor(pack_fixed_values(q, plan, b), device=card)
    st = RowStream(Draw(21, card), b, S)
    n = plan.n_nodes
    before = _launch.LAUNCHES["uniforms"]
    if form == "gaussian":
        got = gaussian_sweep_trace(plan, cpds, params, st, fixed, S,
                                   weighted=True)
        launched = _launch.LAUNCHES["uniforms"] - before
        noise = torch.stack([st.normal(i).reshape(b, S) for i in range(n)], -1)
        want = gaussian_sweep_trace(plan, cpds, params, None, fixed, S,
                                    weighted=True, noise=noise)
    else:
        loop = form == "class_loop"
        monkeypatch.setenv("VBN_SCAN_CLASS_LOOP", "always" if loop else "never")
        cmax = max(c.resolved_classes for c in cpds)
        got = discrete_sweep_trace(plan, cpds, params, st, fixed, S,
                                   weighted=True)
        launched = _launch.LAUNCHES["uniforms"] - before
        noise = torch.stack([
            st.uniform(i).reshape(b, S) if loop else
            -torch.log(-torch.log(st.uniform(i, cmax).reshape(b, S, cmax)))
            for i in range(n)])
        want = discrete_sweep_trace(plan, cpds, params, st, fixed, S,
                                    weighted=True, noise=noise)
    assert launched == 1
    for a, c in zip(got, want):
        assert torch.equal(a, c)


@pytest.mark.cuda
def test_uniforms_blocks_join_into_the_whole_on_the_card(card):
    from vectorizedbayesiannetwork_torch.ops import rng

    whole = rng.stream_values(9, 4, 4096, 2, 2, device=card).reshape(4, 4096, 2)
    for r0 in (0, 2):
        for p0 in (0, 2048):
            part = rng.stream_values(9, 2, 2048, 2, 2, row0=r0, particle0=p0,
                                     device=card).reshape(2, 2048, 2)
            assert torch.equal(part, whole[r0:r0 + 2, p0:p0 + 2048])


@pytest.mark.cuda
@pytest.mark.parametrize("dp", [0, 2])
def test_kde_pick_row_map_reads_the_global_rows(card, dp):
    """A block of rows and particles picked with its ``RowMap`` draws the
    whole batch's uniforms: the kernel's picks equal the plain version's
    on those rows (here the plain version's own pick rule on the same
    uniforms), and a whole-batch launch's rows of the block."""
    data_x, data_p, lm = _kde_support(300, 1, max(dp, 1), 280)
    b, s, s_loc, r0, p0 = 4, 4096, 1024, 2, 2048
    g = torch.Generator(device="cuda").manual_seed(4)
    parents_all = (torch.randn((b, s, dp), generator=g, device="cuda")
                   if dp else None)
    key = torch.tensor([3, 9], dtype=torch.int64, device="cuda")
    whole = kf.kde_pick(key, None if not dp else
                        parents_all.reshape(b * s, dp).contiguous(),
                        data_p, data_x, lm, 0.4, b * s).reshape(b, s, -1)
    par = (None if not dp else
           parents_all[r0:r0 + 2, p0:p0 + s_loc].reshape(-1, dp).contiguous())
    rows = kf.RowMap.of(r0, p0, s_loc, s)
    got = kf.kde_pick(key, par, data_p, data_x, lm, 0.4, 2 * s_loc, rows=rows)
    want = kf.kde_pick_plain(key, par, data_p, data_x, lm, 0.4, 2 * s_loc,
                             rows=rows)
    assert torch.equal(got.reshape(2, s_loc, -1),
                       whole[r0:r0 + 2, p0:p0 + s_loc])
    same = float((got == want).all(dim=1).double().mean())
    assert same >= 0.999, same
