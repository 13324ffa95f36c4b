"""The port's CUDA sweep kernels against their plain PyTorch versions.

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
