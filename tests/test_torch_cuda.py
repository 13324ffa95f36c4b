"""The port's CUDA kernels (the unrolled sweeps of ``ops/sweep.py`` and the
scan sweeps of ``ops/sweep_scan.py``) against their plain PyTorch versions.

These tests need a CUDA card: each one skips here without one (decided in
a fixture, not at import). This file imports neither JAX nor pandas, so it
also runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -o addopts=

The inputs are the port's own fits on numpy data made from a seed; both
sides get the same external uniforms, or the in-kernel Philox stream that
the plain versions reproduce. Tolerances are the JAX kernel tests' own
(``tests/test_sweep_pallas.py``): categorical target classes exact,
log-weights atol 1e-4; LG targets atol 2e-4, log-densities atol 2e-3;
reductions rtol 2e-3.
"""

import numpy as np
import pytest
import torch

from benchmarking.data_gen import generate_dataset
from benchmarking.networks import asia
from vectorizedbayesiannetwork_torch import VBN, defaults
from vectorizedbayesiannetwork_torch.core.base import Query
from vectorizedbayesiannetwork_torch.core.plan import get_plan
from vectorizedbayesiannetwork_torch.ops import sweep

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
    before = sweep.LAUNCHES["categorical"]
    for u in (None, torch.rand((B, plan.n_nodes, S), device="cuda")):
        k_out = sweep.categorical_sweep_fused(
            3, fixed, counts, struct, S, u_ext=u, want=want)
        p_out = sweep.categorical_sweep_plain(
            3, fixed, counts, struct, S, u_ext=u, want=want)
        _check(k_out, p_out, tgt_atol=0, lp_atol=1e-4)
    assert sweep.LAUNCHES["categorical"] == before + 2


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
    before = sweep.LAUNCHES["lg"]
    u_ext = torch.rand((B, 2 * plan.n_nodes, S), device="cuda")
    for u in (None, u_ext.clamp(1e-6, 1 - 1e-6)):  # log(u1) stays finite
        k_out = sweep.lg_sweep_fused(
            3, fixed, ptab, struct, dmax, S, u_ext=u, want=want)
        p_out = sweep.lg_sweep_plain(
            3, fixed, ptab, struct, dmax, S, u_ext=u, want=want)
        _check(k_out, p_out, tgt_atol=2e-4, lp_atol=2e-3)
    assert sweep.LAUNCHES["lg"] == before + 2


@pytest.mark.cuda
def test_served_rows_go_through_the_kernels(asia_vbn, lg_vbn):
    """The public entry points launch one kernel per query batch."""
    before = dict(sweep.LAUNCHES)
    q = {"target": "dysp", "evidence": {"smoke": np.ones((B, 1), np.float32)}}
    pmf, _ = asia_vbn.infer_posterior_pmf([q, q], n_classes=2)
    assert asia_vbn._last_summary_path == "fused"
    assert pmf.shape == (2 * B, 2) and np.isfinite(pmf).all()
    ev = {"x0": np.zeros((B, 1), np.float32), "x1": np.ones((B, 1), np.float32)}
    mom, _ = lg_vbn.infer_posterior_moments([{"target": "x2", "evidence": ev}])
    assert lg_vbn._last_summary_path == "fused"
    assert mom.shape == (B, 2) and np.isfinite(mom).all()
    assert sweep.LAUNCHES["categorical"] == before["categorical"] + 2
    assert sweep.LAUNCHES["lg"] == before["lg"] + 1


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
    from benchmarking.networks import random_bn

    return {
        "random24": _fit_discrete(random_bn(n_nodes=24, max_card=4, seed=7),
                                  card, seed=1),
        "highcard": _fit_discrete(
            random_bn(n_nodes=6, max_card=80, max_indegree=1, seed=0), card,
            seed=3),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("net", ["random24", "highcard"])
@pytest.mark.parametrize("want", CAT_WANTS, ids="-".join)
def test_cat_scan_kernel_matches_plain(scan_nets, net, want):
    from vectorizedbayesiannetwork_torch.ops import sweep_scan

    plan, cpds, params = _canonical(scan_nets[net])
    struct = sweep_scan.scan_struct_for(plan, cpds)
    flat = sweep_scan._flat_counts(cpds, params)
    packed, tgt = _hetero_rows(plan.n_nodes, struct[2], B, seed=9)
    before = sweep.LAUNCHES["categorical_scan"]
    u_ext = torch.rand((B, plan.n_nodes, S), device="cuda")
    for u in (None, u_ext.clamp(1e-6, 1 - 1e-6)):
        k_out = sweep_scan.categorical_sweep_scan(
            5, packed, tgt, flat, struct, S, u_ext=u, want=want)
        p_out = sweep_scan.categorical_sweep_scan_plain(
            5, packed, tgt, flat, struct, S, u_ext=u, want=want)
        _check(k_out, p_out, tgt_atol=0, lp_atol=1e-4)
    assert sweep.LAUNCHES["categorical_scan"] == before + 2


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
    before = sweep.LAUNCHES["lg_scan"]
    u_ext = torch.rand((B, 2 * n, S), device="cuda").clamp(1e-6, 1 - 1e-6)
    for u in (None, u_ext):
        k_out = sweep_scan.lg_sweep_scan(
            5, fixed, flags, tgt, ptab, struct, S, u_ext=u, want=want)
        p_out = sweep_scan.lg_sweep_scan_plain(
            5, fixed, flags, tgt, ptab, struct, S, u_ext=u, want=want)
        _check(k_out, p_out, tgt_atol=2e-4, lp_atol=2e-3)
    assert sweep.LAUNCHES["lg_scan"] == before + 2


@pytest.mark.cuda
def test_scan_kernel_matches_unrolled_kernel_bitwise(asia_vbn):
    """Same seed, static plan: vbn_cat_scan draws vbn_cat_sweep's classes
    (one Philox stream, one walk)."""
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
    a = sweep.categorical_sweep_fused(
        11, fixed, sweep._stacked_counts(cpds, params, rows, cmax), st, S,
        want=want)
    b = sweep_scan.categorical_sweep_scan(
        11, fixed | bits, tgt, sweep_scan._flat_counts(cpds, params),
        sweep_scan.scan_struct_for(plan, cpds), S, want=want)
    assert torch.equal(a[1], b[1])
    torch.testing.assert_close(a[0], b[0], atol=1e-6, rtol=0)
    torch.testing.assert_close(a[2], b[2], atol=1e-6, rtol=0)


@pytest.mark.cuda
def test_scan_smem_layout_matches_the_kernels(card):
    """The gates' shared-memory count is the one the kernels lay out."""
    from vectorizedbayesiannetwork_torch.ops import sweep_scan

    lib = sweep_scan._lib()
    for args in [(724, 1000, 309, 128, 4, 13583), (24, 30, 15, 64, 0, 0),
                 (6, 5, 7, 32, 80, 9000), (1500, 4000, 1501, 32, 3, 0)]:
        assert lib.vbn_cat_scan_smem_bytes(*args) == \
            sweep_scan._cat_scan_smem(*args)
    for args in [(107, 3, 64, 128, 1), (9, 3, 6, 64, 0), (1500, 3, 900, 32, 1)]:
        assert lib.vbn_lg_scan_smem_bytes(*args) == \
            sweep_scan._lg_scan_smem(*args)
    assert sweep_scan._smem_limit(0) >= 48 * 1024


@pytest.mark.cuda
def test_dynamic_serving_goes_through_the_scan_kernels(scan_nets, gauss_vbn):
    """dynamic_masks=True: one launch serves a mixed query list."""
    vbn = scan_nets["random24"]
    nodes = list(vbn.dag.topological_order())
    qs = [{"target": nodes[-1], "evidence": {nodes[0]: [[1.0]]}},
          {"target": nodes[2], "evidence": {nodes[-1]: [[0.0]]}}]
    vbn.set_inference_method("likelihood_weighting", n_samples=S,
                             dynamic_masks=True)
    before = dict(sweep.LAUNCHES)
    pmf, spans = vbn.infer_posterior_pmf(qs, n_classes=4, pad_bucket=4)
    assert vbn._last_summary_path == "fused" and pmf.shape == (2, 4)
    np.testing.assert_allclose(pmf.sum(axis=1), 1.0, atol=1e-5)
    gq = [{"target": "x8", "evidence": {"x0": [[0.3]]}}]
    gauss_vbn.set_inference_method("likelihood_weighting", n_samples=S,
                                   dynamic_masks=True)
    mom, _ = gauss_vbn.infer_posterior_moments(gq)
    assert np.isfinite(mom).all()
    after = dict(sweep.LAUNCHES)
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
