"""The fused forward of ``gaussian_nn`` (``ops/mlp_fused.py``,
``csrc/mlp.cu`` ``vbn_gauss_mlp``) on the CPU, where no kernel runs:

- the plain version of the kernel's arithmetic (``gauss_mlp_plain``) meets
  the served forward's plain route (``GaussianNNCPD._denorm_params``)
  within 1e-6 of each output's scale, for 1, 2 and 3 parents, with the
  softplus inputs below and above its threshold of 20;
- the route (``refusal``) turns away the CPU, bf16 products, ``tanh``,
  widths no template covers, a weight or parents that require grad, and a
  ``torch.func.vmap``-batched forward, each for its own reason; a served
  call on the CPU counts MLP forwards and no fused ones;
- ``MLP["fused"]`` and ``MLP["fused_rows"]`` zero with the other counters,
  and a ``vbn.call`` root records ``mlp_fused_rows``;
- ``ops/_build.py`` builds ``csrc/mlp.cu`` with the other sources, and the
  module imports and serves the CPU without nvcc.
"""

import importlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vectorizedbayesiannetwork_torch import VBN, defaults
from vectorizedbayesiannetwork_torch.models.gaussian_nn import GaussianNNCPD
from vectorizedbayesiannetwork_torch.ops import _build, mlp_fused
from vectorizedbayesiannetwork_torch.utils import profiling

MIN_SCALE = 1e-3


def node(dp, gen, hidden=(32, 32), activation="relu", compute_dtype="float32",
         head_shift=0.0):
    """A ``gaussian_nn`` node with seeded random weights and statistics;
    ``head_shift`` moves the scale column's bias (the softplus input)."""
    cpd = GaussianNNCPD(dp, 1, hidden_dims=hidden, activation=activation,
                        min_scale=MIN_SCALE, compute_dtype=compute_dtype)
    params = cpd.init("cpu", gen)
    stats = params["stats"]
    stats["mean_x"] = torch.randn(dp, generator=gen)
    stats["std_x"] = 0.5 + torch.rand(dp, generator=gen)
    stats["mean_y"] = torch.randn(1, generator=gen)
    stats["std_y"] = 0.5 + torch.rand(1, generator=gen)
    params["net"]["layers"][-1]["b"][1] += head_shift
    return cpd, params


def head_inputs(params, pa):
    """The softplus inputs of the plain route's forward."""
    from vectorizedbayesiannetwork_torch.models._mlp import mlp_apply

    st = params["stats"]
    out = mlp_apply(params["net"], (pa - st["mean_x"]) / st["std_x"], "relu")
    return out[:, 1]


@pytest.mark.parametrize("side", ["below", "above"])
@pytest.mark.parametrize("dp", [1, 2, 3])
def test_the_plain_model_meets_the_served_forward(dp, side):
    gen = torch.Generator().manual_seed(40 + dp)
    cpd, params = node(dp, gen, head_shift=0.0 if side == "below" else 30.0)
    pa = 2.0 * torch.randn((8192, dp), generator=gen)
    z = head_inputs(params, pa)
    assert bool((z < 20).all() if side == "below" else (z > 20).all())
    want = cpd._denorm_params(params, pa, pa.shape[0])
    got = mlp_fused.gauss_mlp_plain(pa, params["net"], params["stats"],
                                    MIN_SCALE)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape == (8192, 1)
        gap = float((g - w).abs().max()) / float(w.abs().max())
        assert gap <= 1e-6, gap
    # the wrapper serves CPU tensors by the plain version
    loc, scale = mlp_fused.gauss_mlp(pa, params["net"], params["stats"],
                                     MIN_SCALE)
    assert torch.equal(loc, got[0]) and torch.equal(scale, got[1])


def _case(name):
    gen = torch.Generator().manual_seed(7)
    kw = {"tanh": {"activation": "tanh"}, "bf16": {"compute_dtype": "bfloat16"},
          "widths": {"hidden": (64, 64)}}.get(name, {})
    cpd, params = node(3, gen, **kw)
    pa = torch.randn((64, 3), generator=gen)
    if name == "weight_grad":
        params["net"]["layers"][1]["w"].requires_grad_(True)
    if name == "parents_grad":
        pa.requires_grad_(True)
    return cpd, params, pa


REFUSED = {"cpu": "device", "bf16": "dtype", "tanh": "activation",
           "widths": "shape", "weight_grad": "grad", "parents_grad": "grad",
           "vmap": "functorch"}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_the_route_refuses(name):
    cpd, params, pa = _case(name)
    net, stats = params["net"], params["stats"]
    if name == "vmap":
        seen = []

        def one(p):
            seen.append(mlp_fused.refusal(p, net, stats, cpd.activation,
                                          cpd.compute_dtype))
            return p.sum()

        torch.func.vmap(one)(pa.reshape(8, 8, 3))
        assert seen == [REFUSED[name]]
        return
    assert mlp_fused.refusal(pa, net, stats, cpd.activation,
                             cpd.compute_dtype) == REFUSED[name]


def test_a_cpu_call_runs_no_fused_forward():
    vbn = _gauss3()
    profiling.reset_counters()
    vbn.infer_posterior_moments([{"target": "x0", "evidence": {"x2": [[0.4]]}}],
                                dynamic_masks=True, pad_bucket=1)
    got = profiling.counters()["MLP"]
    assert got["forwards"] > 0 and got["rows"] > 0
    assert got["fused"] == 0 and got["fused_rows"] == 0


def _gauss3():
    gen = torch.Generator().manual_seed(0)
    x0 = torch.randn(512, generator=gen).numpy()
    x1 = torch.randn(512, generator=gen).numpy()
    x2 = 0.7 * x0 - 0.4 * x1 + 0.3 * torch.randn(512, generator=gen).numpy()
    vbn = VBN([("x0", "x2"), ("x1", "x2")], seed=0, device="cpu")
    conf = dict(defaults.cpd("gaussian_nn"),
                fit={"epochs": 2, "batch_size": 256, "lr": 1e-3})
    vbn.set_learning_method("node_wise", nodes_cpds={
        k: dict(conf) for k in ("x0", "x1", "x2")})
    vbn.fit({"x0": x0, "x1": x1, "x2": x2})
    vbn.set_inference_method("likelihood_weighting", n_samples=64,
                             dynamic_masks=True)
    return vbn


def test_the_fused_counters_zero_and_the_root_records_them():
    profiling.MLP["fused"] += 3
    profiling.MLP["fused_rows"] += 300
    assert profiling.counters()["MLP"]["fused_rows"] == 300
    profiling.reset_counters()
    assert profiling.counters()["MLP"] == {"forwards": 0, "rows": 0,
                                           "fused": 0, "fused_rows": 0}
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("vbn.call"):
            with profiling.annotate("vbn.mlp.sample"):
                profiling.MLP["rows"] += 10
                profiling.MLP["fused_rows"] += 10
            profiling.MLP["rows"] += 5
    root = profiling.spans()[0]
    assert root["attrs"]["mlp_rows"] == 15
    assert root["attrs"]["mlp_fused_rows"] == 10
    profiling.reset_spans()
    profiling.reset_counters()


def test_the_build_lists_mlp_and_the_module_needs_no_nvcc(monkeypatch):
    assert "mlp" in _build.SOURCES
    assert (_build.CSRC / "mlp.cu").exists()
    assert _build.library_path("mlp").name.startswith("libmlp-")

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "nvcc", no_nvcc)
    mod = importlib.reload(mlp_fused)
    gen = torch.Generator().manual_seed(1)
    _cpd, params = node(2, gen)
    loc, scale = mod.gauss_mlp(torch.randn((16, 2), generator=gen),
                               params["net"], params["stats"], MIN_SCALE)
    assert loc.shape == scale.shape == (16, 1) and bool((scale > 0).all())
