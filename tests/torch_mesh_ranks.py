"""Rank programs of the port's mesh tests: a gloo group of CPU processes.

The mesh tests (``tests/test_torch_mesh*.py``) start a group once a file:
``spawn_ranks`` runs ``main`` in ``world`` spawned processes, each of which
joins the group through a file under the test's ``tmp_path``, builds the
('data', 'particle') mesh, runs the jobs named, and writes each job's
arrays to ``<dir>/<job>_<rank>.npz``. The test process computes the JAX
package's side and reads these files.

This module imports torch, numpy and the port only: the spawned processes
import it, and they must not import JAX.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

WORLD = 4
N_DATA = 2


def spawn_ranks(out_dir, jobs, world=WORLD, n_data=N_DATA, timeout_s=300.0):
    """Run ``main`` for ``jobs`` on ``world`` ranks; fails on any rank's
    error and on the deadline (the processes are then killed)."""
    import torch.multiprocessing as mp

    out_dir = Path(out_dir)
    ctx = mp.start_processes(
        main, args=(world, n_data, str(out_dir), tuple(jobs)), nprocs=world,
        join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"mesh ranks did not finish in {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)


def load(out_dir, job, rank=0):
    with np.load(Path(out_dir) / f"{job}_{rank}.npz") as f:
        return {k: f[k] for k in f.files}


def main(rank, world, n_data, out_dir, jobs):
    import torch.distributed as dist

    from vectorizedbayesiannetwork_torch.parallel import (
        initialize_distributed,
        make_mesh,
    )

    torch.set_num_threads(1)
    initialize_distributed(init_method=f"file://{out_dir}/group",
                           world_size=world, rank=rank, backend="gloo",
                           timeout_s=120)
    try:
        mesh = make_mesh(n_data=n_data, device_type="cpu")
        for job in jobs:
            out = JOBS[job](Path(out_dir), mesh)
            np.savez(Path(out_dir) / f"{job}_{rank}.npz", **{
                k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v) for k, v in out.items()})
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Jobs: each returns {name: array}
# ---------------------------------------------------------------------------


def _inputs(out_dir):
    with np.load(out_dir / "inputs.npz") as f:
        return {k: f[k] for k in f.files}


_VBNS = {}


def _port_vbn(out_dir, tag):
    """The JAX model saved at ``out_dir/tag``, loaded by the port once."""
    from vectorizedbayesiannetwork_torch import VBN

    key = (str(out_dir), tag)
    if key not in _VBNS:
        _VBNS[key] = VBN.load(str(out_dir / tag), device="cpu")
    return _VBNS[key]


def _sweep_job(out_dir, mesh):
    """Every stored sweep case through the port's meshed raw function on
    this rank's uniform block."""
    from vectorizedbayesiannetwork_torch.core.base import Query
    from vectorizedbayesiannetwork_torch.core.plan import get_plan
    from vectorizedbayesiannetwork_torch.ops.sweep import make_fused_sweep_fn
    from vectorizedbayesiannetwork_torch.ops.sweep_scan import make_scan_sweep_fn
    from vectorizedbayesiannetwork_torch.parallel.mesh import mesh_coords

    inp = _inputs(out_dir)
    di, pi = mesh_coords(mesh)
    out = {}
    for case in [k[: -len(":fixed")] for k in inp if k.endswith(":fixed")]:
        tag, form, want = case.split("|")
        want = tuple(want.split(","))
        vbn = _port_vbn(out_dir, tag)
        fixed = torch.as_tensor(inp[f"{case}:fixed"])
        u = torch.as_tensor(inp[f"{case}:u{di}{pi}"])
        s = int(inp[f"{case}:s"])
        if form == "unrolled":
            q = Query(target=str(inp[f"{tag}:target"]),
                      evidence={str(n): np.zeros((1, 1), np.float32)
                                for n in inp[f"{tag}:evidence"]},
                      do={str(n): np.zeros((1, 1), np.float32)
                          for n in inp[f"{tag}:do"]})
            plan = get_plan(vbn, q)
            raw = make_fused_sweep_fn(plan, _cpds(vbn, plan), s, want=want,
                                      mesh=mesh)
            res = raw(_params(vbn, plan), 0, fixed, u_ext=u)
        else:
            plan = _canonical(vbn)
            raw = make_scan_sweep_fn(plan, _cpds(vbn, plan), s, want=want,
                                     mesh=mesh)
            res = raw(_params(vbn, plan), 0, fixed,
                      torch.as_tensor(inp[f"{case}:ev"]),
                      torch.as_tensor(inp[f"{case}:do"]),
                      torch.as_tensor(inp[f"{case}:tgt"]), u_ext=u)
        for name, t in zip(("logw", "tgt", "lpt"), res[:3]):
            if t is not None:
                out[f"{case}:{name}"] = t
        if res[3] is not None:
            out[f"{case}:sums"], out[f"{case}:m"] = res[3]
    return out


def _cpds(vbn, plan):
    return tuple(vbn.cpd_spec(n) for n in plan.topo_order)


def _params(vbn, plan):
    return tuple(vbn.params[n] for n in plan.topo_order)


def _canonical(vbn):
    from vectorizedbayesiannetwork_torch.core.base import Query
    from vectorizedbayesiannetwork_torch.core.plan import get_plan

    topo = tuple(vbn.dag.topological_order())
    return get_plan(vbn, Query(target=topo[0], evidence={}, do={}))


def _resample_job(out_dir, mesh):
    """Every stored resampling case: this rank's block of the weights and
    values (and, where stored, of JAX's draws) through
    ``distributed_resample_gather``; the result gathered to every rank."""
    from vectorizedbayesiannetwork_torch.core.rng import Draw
    from vectorizedbayesiannetwork_torch.ops.resample_distributed import (
        distributed_resample_gather,
        distributed_resample_supported,
    )
    from vectorizedbayesiannetwork_torch.parallel.mesh import (
        block,
        gather_blocks,
        mesh_coords,
        mesh_shape,
    )

    inp = _inputs(out_dir)
    (nd, npart), (di, pi) = mesh_shape(mesh), mesh_coords(mesh)
    out = {"supported": np.asarray([
        distributed_resample_supported(mesh, 4, 1024),
        distributed_resample_supported(None, 4, 1024),
        distributed_resample_supported(mesh, 3, 1024),
        distributed_resample_supported(mesh, 4, 1025)])}
    for case in [k[: -len(":w")] for k in inp if k.endswith(":w")]:
        method = case.split("|")[0]
        w = torch.as_tensor(inp[f"{case}:w"])
        vals = torch.as_tensor(inp[f"{case}:v"])
        kw = {}
        if f"{case}:u0_{di}" in inp:
            kw["u0"] = torch.as_tensor(inp[f"{case}:u0_{di}"])
        if f"{case}:e_{di}{pi}" in inp:
            kw["e"] = torch.as_tensor(inp[f"{case}:e_{di}{pi}"])
            kw["e_tail"] = torch.as_tensor(inp[f"{case}:tail_{di}"])
        w_l = block(block(w, nd, di, 0), npart, pi, 1)
        v_l = block(block(vals, nd, di, 0), npart, pi, 1)
        got = distributed_resample_gather(
            Draw(int(inp[f"{case}:seed"]), w.device), w_l, v_l, mesh,
            method=method, **kw)
        out[case] = gather_blocks(got, mesh)
    return out


def _fit_job(out_dir, mesh):
    """``linear_gaussian_fit_step`` and one ``gaussian_nn_dp_step`` on this
    rank's rows of the stored data, from the stored (JAX-made) net."""
    from vectorizedbayesiannetwork_torch import CPD_REGISTRY
    from vectorizedbayesiannetwork_torch.parallel.train import (
        gaussian_nn_dp_step,
        linear_gaussian_fit_step,
        shard_rows,
    )
    from vectorizedbayesiannetwork_torch.vbn import (
        _flatten_params,
        params_from_numpy,
    )

    inp = _inputs(out_dir)
    p_sh, x_sh = shard_rows(mesh, inp["lg:parents"], inp["lg:x"])
    fit = linear_gaussian_fit_step(mesh, p_sh, x_sh)
    out = {f"lg:{k}": v for k, v in fit.items()}
    out["rows"] = shard_rows(mesh, inp["rows"])
    cpd = CPD_REGISTRY["gaussian_nn"](2, 1, seed=0, hidden_dims=[8])
    net0 = params_from_numpy({k[len("net0/"):]: v for k, v in inp.items()
                              if k.startswith("net0/")}, torch.device("cpu"))
    p_sh, x_sh = shard_rows(mesh, inp["nn:parents"], inp["nn:x"])
    net1, opt = gaussian_nn_dp_step(mesh, cpd, net0, None, p_sh, x_sh)
    out.update({f"net1/{k}": v for k, v in _flatten_params(net1).items()})
    out["opt_step"] = opt["step"]
    return out


def _chain(seed=0):
    """The flagship x0 -> x2 <- x1, fitted by the port on the CPU."""
    from chip_smoke import flagship_data
    from vectorizedbayesiannetwork_torch import VBN, defaults

    vbn = VBN([("x0", "x2"), ("x1", "x2")], seed=seed, device="cpu")
    vbn.set_learning_method("node_wise", nodes_cpds={
        k: defaults.cpd("linear_gaussian") for k in ("x0", "x1", "x2")})
    vbn.fit(flagship_data(1500, seed))
    return vbn


def _both(vbn, mesh, call, counter=1000):
    """``call()`` unmeshed and under ``mesh``, each from key counter
    ``counter``."""
    outs = []
    for m in (None, mesh):
        vbn.set_mesh(m)
        vbn._keys.set_state(counter)
        outs.append(call())
    vbn.set_mesh(None)
    return outs


def _api_job(out_dir, mesh):
    """The public entry points under ``set_mesh``: the sharded LW / MCM /
    RIS paths, and the paths that run whole on every rank beside their
    unmeshed answers."""
    from benchmarking.networks import asia
    from chip_smoke import asia_query, fit_discrete, flagship_query
    from vectorizedbayesiannetwork_torch import VBN, defaults

    from vectorizedbayesiannetwork_torch.parallel import (
        active_mesh,
        constrain_bs,
        constrain_bsd,
    )

    out = {}
    grid = torch.arange(4 * 8, dtype=torch.float32).reshape(4, 8)
    with active_mesh(mesh):
        out["bs"] = constrain_bs(grid)
        out["bsd"] = constrain_bsd(grid[..., None].expand(4, 8, 3))
    av = fit_discrete(VBN, defaults, asia(), device="cpu")
    av.set_inference_method("likelihood_weighting", n_samples=1 << 14)
    av.set_mesh(mesh)
    pmf, _ = av.infer_posterior_pmf([asia_query(4)], n_classes=2)
    out["lw_pmf"] = pmf / pmf.sum(axis=1, keepdims=True)
    out["lw_pmf_path"] = av._last_summary_path == "fused"
    w, smp = av.infer_posterior(asia_query(4))
    out["lw_w"], out["lw_s"] = w, smp
    # B = 3 does not split over 'data': served whole, as with no mesh
    out["odd_whole"], out["odd_mesh"] = _both(
        av, mesh, lambda: av.infer_posterior_pmf([asia_query(3)],
                                                 n_classes=2)[0])
    av.set_mesh(mesh)
    av.set_inference_method("likelihood_weighting", n_samples=1 << 14,
                            dynamic_masks=True)
    qs = [{"target": "dysp", "evidence": {"smoke": [[1.0]]}},
          {"target": "lung", "evidence": {"dysp": [[1.0]], "xray": [[0.0]]}},
          {"target": "either", "evidence": {}, "do": {"smoke": [[0.0]]}},
          {"target": "bronc", "evidence": {"asia": [[1.0]]}}]
    out["dyn_pmf"] = av.infer_posterior_pmf(qs, n_classes=2)[0]
    av.set_mesh(None)
    av.set_inference_method("categorical_exact")
    out["dyn_exact"] = av.infer_posterior_pmf(qs, n_classes=2)[0]
    n_fns = len(av._inference._fn_cache)
    av.set_mesh(mesh)
    av.infer_posterior_pmf(qs, n_classes=2)
    out["cache_sizes"] = [n_fns, len(av._inference._fn_cache)]
    av.set_mesh(None)

    lg = _chain()
    lg.set_mesh(mesh)
    lg.set_inference_method("monte_carlo_marginalization", n_samples=1 << 14)
    out["mcm_mom"] = lg.infer_posterior_moments([flagship_query(4)])[0]
    lg.set_inference_method("likelihood_weighting", n_samples=1 << 14,
                            dynamic_masks=True)
    gq = [{"target": "x0", "evidence": {"x2": [[0.6]]}},
          {"target": "x2", "evidence": {"x0": [[0.3]], "x1": [[-0.2]]}},
          {"target": "x1", "evidence": {"x2": [[0.3]]}, "do": {"x0": [[0.5]]}}]
    out["dyn_mom"] = lg.infer_posterior_moments(gq)[0]
    lg.set_mesh(None)
    lg.set_inference_method("gaussian_exact")
    out["dyn_mom_exact"] = lg.infer_posterior_moments(gq)[0]

    q = {"target": "x0", "evidence": {"x2": [[0.3], [0.5]]}}
    lg.set_inference_method("importance_sampling", n_samples=128)
    out["is_whole"], out["is_mesh"] = (
        torch.stack([w, s[..., 0]]) for w, s in
        _both(lg, mesh, lambda: lg.infer_posterior(q)))
    qs2 = {"target": "x2", "evidence": {"x0": [[0.1], [-0.1]]}}
    for method, kw in (("ancestral", {}),
                       ("gibbs", {"burn_in": 2, "thinning": 1}),
                       ("hmc", {"burn_in": 2, "n_leapfrog": 3}),
                       ("nuts", {"burn_in": 2, "max_depth": 3})):
        lg.set_sampling_method(method, **kw)
        out[f"{method}_whole"], out[f"{method}_mesh"] = _both(
            lg, mesh, lambda: lg.sample(qs2, n_samples=16))
    g = np.random.default_rng(5)
    x0 = g.normal(size=64)
    x1 = 0.8 * x0 + 0.1 * g.normal(size=64)
    upd = {"x0": x0, "x1": x1, "x2": 0.5 * x1 + 0.1 * g.normal(size=64)}
    for tag, m in (("whole", None), ("mesh", mesh)):
        v = _chain()
        v.set_mesh(m)
        v.update({k: a.reshape(-1, 1).astype(np.float32)
                  for k, a in upd.items()}, update_method="streaming_stats")
        for node, params in v.params.items():
            for k, t in params.items():
                if isinstance(t, torch.Tensor):
                    out[f"update_{tag}/{node}/{k}"] = t

    lg.set_mesh(mesh)
    ev = {"x2": np.array([[0.6], [0.2]], np.float32)}
    for method in ("systematic", "multinomial"):
        lg.set_inference_method("resampled_importance_sampling",
                                n_samples=1 << 13, ess_threshold=0.9,
                                resample_method=method)
        w, smp = lg.infer_posterior({"target": "x0", "evidence": ev})
        out[f"ris_{method}_w"], out[f"ris_{method}_s"] = w, smp[..., 0]
        out[f"ris_{method}_ess"] = lg._inference._last_ess
        out[f"ris_{method}_resampled"] = lg._inference._last_resampled
    lg.set_mesh(None)
    p = lg.params
    out["chain"] = np.asarray([
        float(p["x0"]["bias"][0]), float(p["x0"]["var"][0]),
        float(p["x1"]["bias"][0]), float(p["x1"]["var"][0]),
        float(p["x2"]["weight"][0, 0]), float(p["x2"]["weight"][1, 0]),
        float(p["x2"]["bias"][0]), float(p["x2"]["var"][0])])
    return out


def trace_models(device="cpu"):
    """The models of the ``trace`` job, fitted by the port: asia's tables,
    and the chain with linear-Gaussian, ``gaussian_nn`` and KDE CPDs."""
    from benchmarking.networks import asia
    from chip_smoke import fit_discrete, flagship_data
    from vectorizedbayesiannetwork_torch import VBN, defaults

    chain = [("x0", "x2"), ("x1", "x2")]
    data = {k: v.astype(np.float32).reshape(-1, 1)
            for k, v in flagship_data(400, 0).items()}
    confs = {
        "lg": defaults.cpd("linear_gaussian"),
        "nn": dict(defaults.cpd("gaussian_nn"), hidden_dims=[8],
                   fit={"epochs": 2, "batch_size": 128, "lr": 1e-2}),
        "kde": dict(defaults.cpd("kde"), max_points=64),
    }
    models = {"asia": fit_discrete(VBN, defaults, asia(), device=device)}
    for tag, conf in confs.items():
        v = VBN(chain, seed=0, device=device)
        v.set_learning_method("node_wise", nodes_cpds={k: conf for k in data})
        v.fit(data)
        models[tag] = v
    return models


# (case, model, method, settings, query, stacked form or None): the
# torch-op paths the ``trace`` job serves meshed and unmeshed
TRACE_X2 = {"target": "x0", "evidence": {"x2": [[0.3], [0.1], [-0.2], [0.5]]}}
TRACE_X0 = {"target": "x2", "evidence": {"x0": [[0.3], [0.1], [-0.2], [0.5]]}}
TRACE_ASIA = {"target": "dysp", "evidence": {
    "smoke": [[1.0], [0.0], [1.0], [0.0]], "asia": [[0.0], [0.0], [1.0], [1.0]]}}
TRACE_CASES = [
    ("stacked_cat", "asia", "likelihood_weighting", {}, TRACE_ASIA, "always"),
    ("stacked_cat_dyn", "asia", "likelihood_weighting",
     {"dynamic_masks": True}, TRACE_ASIA, "always"),
    ("stacked_lg", "lg", "likelihood_weighting", {}, TRACE_X2, "always"),
    ("is", "lg", "importance_sampling", {}, TRACE_X2, None),
    ("is_dyn", "lg", "importance_sampling", {"dynamic_masks": True},
     TRACE_X2, None),
    ("kde_lw", "kde", "likelihood_weighting", {}, TRACE_X2, None),
    ("nn_lw", "nn", "likelihood_weighting", {}, TRACE_X2, None),
    ("lbp", "lg", "lbp", {}, TRACE_X2, None),
    ("rbm", "lg", "rao_blackwellized_marginalization",
     {"n_samples": 64, "n_particles": 256}, TRACE_X0, None),
]
TRACE_S = 256


def _trace_job(out_dir, mesh):
    """Each torch-op path of ``TRACE_CASES`` unmeshed and under ``mesh``
    from one key counter: (weights, target values) of both, and the
    level-grouped calls of each (the chain's roots x0, x1 form a group)."""
    import os

    from vectorizedbayesiannetwork_torch.inference import _sweep
    from vectorizedbayesiannetwork_torch.ops import sweep

    models = trace_models()
    out = {}
    for case, tag, method, kw, query, scan in TRACE_CASES:
        vbn = models[tag]
        vbn.set_inference_method(method, **dict({"n_samples": TRACE_S}, **kw))
        prev = os.environ.get("VBN_DISCRETE_SCAN")
        os.environ["VBN_DISCRETE_SCAN"] = scan or "never"
        groups = []  # the level-grouped calls of each run

        def call():
            _sweep.GROUPS.clear()
            got = vbn.infer_posterior(query)
            groups.append(_sweep.GROUPS["sample_calls"])
            return got

        try:
            _sweep.ROUTES.clear()
            sweep.TRACES.update(sharded=0, whole=0)
            whole, meshed = _both(vbn, mesh, call)
            out[f"{case}_routes"] = np.asarray(sorted(_sweep.ROUTES))
            out[f"{case}_groups"] = np.asarray(groups)
            out[f"{case}_sharded"] = np.asarray(
                [sweep.TRACES["sharded"], sweep.TRACES["whole"]])
        finally:
            if prev is None:
                os.environ.pop("VBN_DISCRETE_SCAN")
            else:
                os.environ["VBN_DISCRETE_SCAN"] = prev
        for name, (w, s) in (("whole", whole), ("mesh", meshed)):
            out[f"{case}_{name}_w"], out[f"{case}_{name}_s"] = w, s
    import torch.distributed as dist

    if dist.get_rank() == 0:  # for the JAX package's side
        for tag in ("asia", "lg", "nn", "kde"):
            models[tag].save(str(out_dir / f"trace_{tag}.npz"))
    return out


# (case, model, sampler, settings): the chains the ``chains`` job runs
# meshed and unmeshed; 4 rows of 8 chains split over either mesh, and
# "*_refused" takes 3 chains, which split over no particle axis of 2 or 4,
# so it runs whole on every rank
CHAIN_CASES = [
    ("gibbs_tables", "asia", "gibbs", {"burn_in": 3, "n_steps": 2}),
    ("gibbs_lg", "lg", "gibbs", {"burn_in": 3, "n_steps": 2}),
    ("gibbs_lg_keyed", "lg", "gibbs", {"burn_in": 3, "hoist": False}),
    ("hmc_fixed", "lg", "hmc", {"burn_in": 4, "step_size": 0.2,
                                "n_leapfrog": 4}),
    ("hmc_adapted", "lg", "hmc", {"burn_in": 4, "step_size": 0.2,
                                  "n_leapfrog": 4, "adapt_step_size": True}),
    ("nuts_fixed", "lg", "nuts", {"burn_in": 3, "step_size": 0.2,
                                  "max_tree_depth": 4}),
    ("nuts_adapted", "lg", "nuts", {"burn_in": 3, "step_size": 0.2,
                                    "max_tree_depth": 4,
                                    "adapt_step_size": True}),
    ("hmc_refused", "lg", "hmc", {"burn_in": 2, "n_leapfrog": 2,
                                  "adapt_step_size": True, "n_chains": 3}),
    ("gibbs_refused", "lg", "gibbs", {"burn_in": 2, "n_chains": 3}),
]
CHAIN_QUERY = {"lg": TRACE_X2, "asia": {"target": "lung", "evidence": {
    "xray": [[1.0], [0.0], [1.0], [0.0]], "dysp": [[1.0], [1.0], [0.0], [0.0]]}}}


def check_chains(ranks, case):
    """The ``chains`` job's case on every rank: meshed equals unmeshed and
    rank 0 bit for bit, sharded unless the case is one the gates refuse
    (then whole)."""
    refused = case.endswith("_refused")
    for got in ranks:
        whole, meshed = got[f"{case}_whole"], got[f"{case}_mesh"]
        assert whole.shape == (4, 16, 1) and np.isfinite(whole).all()
        np.testing.assert_array_equal(meshed, whole)
        np.testing.assert_array_equal(meshed, ranks[0][f"{case}_mesh"])
        assert list(got[f"{case}_counts"]) == ([0, 1] if refused else [1, 0])
        if f"{case}_hoisted" in got:
            assert bool(got[f"{case}_hoisted"]) is (case != "gibbs_lg_keyed")


def _chains_job(out_dir, mesh):
    """Each chain case of ``CHAIN_CASES`` unmeshed and under ``mesh`` from
    one key counter, with the samplers' ``CHAINS`` counts of the meshed
    call (sharded, whole)."""
    from vectorizedbayesiannetwork_torch.models.linear_gaussian import (
        LinearGaussianCPD,
    )
    from vectorizedbayesiannetwork_torch.sampling import chains

    models = trace_models()
    out = {}
    for case, tag, sampler, kw in CHAIN_CASES:
        vbn = models[tag]
        kw = dict({"n_chains": 8}, **kw)
        hoist = kw.pop("hoist", True)
        vbn.set_sampling_method(sampler)
        spec = LinearGaussianCPD.__dict__["_noise_spec"]
        if not hoist:  # Gibbs's in-loop route: no noise split
            del LinearGaussianCPD._noise_spec
        chains.CHAINS.update(sharded=0, whole=0)
        try:
            whole, meshed = _both(vbn, mesh, lambda: vbn.sample(
                CHAIN_QUERY[tag], n_samples=16, **kw))
        finally:
            LinearGaussianCPD._noise_spec = spec
        out[f"{case}_whole"], out[f"{case}_mesh"] = whole, meshed
        out[f"{case}_counts"] = np.asarray(
            [chains.CHAINS["sharded"], chains.CHAINS["whole"]])
        if sampler == "gibbs":
            out[f"{case}_hoisted"] = np.asarray(vbn._sampling._last_hoisted)
    return out


JOBS = {"sweep": _sweep_job, "resample": _resample_job, "fit": _fit_job,
        "api": _api_job, "trace": _trace_job, "chains": _chains_job}
