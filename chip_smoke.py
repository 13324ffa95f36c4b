#!/usr/bin/env python3
"""Drive the PyTorch port of the VBN serving path on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases:

1. build: compile ``vectorizedbayesiannetwork_torch/csrc/*.cu`` with nvcc
   (sm_90a) and print the build seconds and ptxas' register report;
2. fit: the asia network (8 categorical nodes) and the 3-node
   linear-Gaussian flagship, each on 4096 rows, on the card;
3. kernels: each sweep kernel against its plain PyTorch version at B=8,
   S=2^16 in every ``want`` mode, on the same external uniforms and on the
   in-kernel Philox stream;
4. main path: ``infer_posterior_pmf`` (asia, likelihood weighting) and
   ``infer_posterior_moments`` (flagship, Monte-Carlo marginalization) at
   B=1024 query rows and S=2^20 particles, with the launch counters reset
   just before and read just after; the asia pmf is held against the exact
   posterior of the fitted CPTs, the flagship moments against their closed
   form;
5. timing: each kernel's ms at the main-path shapes and ``want`` mode
   (CUDA events), held once more against its plain version over the same
   batch and in-kernel Philox draws (the plain version runs B_PLAIN rows
   at a time and is timed over the whole batch), the operation/byte bound,
   and the end-to-end queries/s of both workloads (12 batches per window,
   best of 5 windows).

Prints a JSON line of kernel results, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``. Any failure exits nonzero. The
script imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

B_MAIN = 1024
S_MAIN = 1 << 20
B_CHECK, S_CHECK = 8, 1 << 16
B_PLAIN = 8  # rows per plain-version call: it makes [B, S] tensors per node
REPS = 12
WINDOWS = 5
PEAK_OPS = 67e12  # H100 SXM float32 outside the tensor cores, op/s
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, byte/s


def log(tag: str, **kv) -> None:
    print(json.dumps({"phase": tag, **kv}), flush=True)


def fit_asia(vbn_cls, defaults):
    from benchmarking.data_gen import generate_dataset
    from benchmarking.networks import asia

    bn = asia()
    data = generate_dataset(bn, 4096, seed=0)
    vbn = vbn_cls({n: bn.parents[n] for n in bn.nodes}, seed=0)
    conf = {}
    for node in bn.nodes:
        c = dict(defaults.cpd("categorical_table"), n_classes=bn.card(node))
        if bn.parents[node]:
            c["parent_n_classes"] = [bn.card(p) for p in bn.parents[node]]
        conf[node] = c
    vbn.set_learning_method("node_wise", nodes_cpds=conf)
    vbn.fit({k: np.asarray(v, np.float32).reshape(-1, 1) for k, v in data.items()})
    return bn, vbn


def fit_flagship(vbn_cls, defaults, n=4096, seed=0):
    g = np.random.default_rng(seed)
    x0 = g.normal(size=n)
    x1 = g.normal(size=n)
    x2 = 0.5 * x0 - 0.2 * x1 + 0.1 * g.normal(size=n)
    vbn = vbn_cls([("x0", "x2"), ("x1", "x2")], seed=seed)
    vbn.set_learning_method(
        "node_wise",
        nodes_cpds={k: defaults.cpd("linear_gaussian") for k in ("x0", "x1", "x2")},
    )
    vbn.fit({"x0": x0, "x1": x1, "x2": x2})
    return vbn


def asia_query(b):
    return {
        "target": "dysp",
        "evidence": {
            "smoke": (np.arange(b) % 2).reshape(b, 1).astype(np.float32),
            "asia": ((np.arange(b) // 2) % 2).reshape(b, 1).astype(np.float32),
        },
    }


def flagship_query(b):
    return {
        "target": "x2",
        "evidence": {
            "x0": np.linspace(-1, 1, b).reshape(b, 1).astype(np.float32),
            "x1": np.linspace(1, -1, b).reshape(b, 1).astype(np.float32),
        },
    }


def kernel_inputs(vbn, query, lg: bool):
    """(fixed tensor, table, plan_tuple[, dmax]) for the query's plan, as
    ``make_fused_sweep_fn`` builds them on the main path."""
    import torch

    from vectorizedbayesiannetwork_torch.core.plan import get_plan, pack_fixed_values
    from vectorizedbayesiannetwork_torch.ops import sweep

    q = vbn._normalize_query(query)
    plan = get_plan(vbn, q)
    cpds = tuple(vbn.cpd_spec(n) for n in plan.topo_order)
    params = tuple(vbn.params[n] for n in plan.topo_order)
    b = next(iter(q.evidence.values())).shape[0]
    fixed = torch.as_tensor(pack_fixed_values(q, plan, b, clamp_obs=not lg),
                            device=vbn.device)
    if lg:
        plan_struct, dmax = sweep.lg_plan_tuple_for(plan, cpds)
        ptab = sweep.lg_param_table(
            cpds, params, dmax, tuple(c.min_scale for c in cpds)
        )
        return fixed.contiguous(), ptab, plan_struct, dmax
    plan_tuple = sweep.plan_tuple_for(plan, cpds)
    counts = sweep._stacked_counts(cpds, params, plan_tuple[1], plan_tuple[2])
    return fixed.round().to(torch.int32), counts, plan_tuple[0], None


def compare(name, got, want, *, atol=None, rtol=None, exact=False):
    import torch

    err = float((got.double() - want.double()).abs().max())
    if exact:
        ok = bool(torch.equal(got, want))
    else:
        ok = bool(torch.allclose(got.double(), want.double(),
                                 atol=atol or 0.0, rtol=rtol or 0.0))
    if not ok:
        raise AssertionError(f"{name}: max abs err {err} (atol {atol}, rtol {rtol})")
    return err


def served_rows(kind, sums):
    """What a user gets from reduction sums: normalized pmf rows, or
    (mean, std) rows from (sum w, sum w x, sum w x^2)."""
    import torch

    sums = sums.double()
    if kind == "pmf":
        return sums / sums.sum(1, keepdim=True)
    mean = sums[:, 1] / sums[:, 0]
    var = torch.clamp(sums[:, 2] / sums[:, 0] - mean * mean, min=0.0)
    return torch.stack([mean, var.sqrt()], 1)


def compare_red(name, got, want, kind, *, rtol, shift_atol):
    """Kernel vs plain reduction ``(sums, m)``: the shifts within
    ``shift_atol``, each sum within ``rtol`` of its row's largest sum (a
    moment sum may cancel to near 0, so the scale is the row's, not the
    entry's); returns the max abs error of the served rows."""
    compare(f"{name} shift", got[1], want[1], atol=shift_atol)
    scale = want[0].double().abs().max(1, keepdim=True).values
    err = (got[0].double() - want[0].double()).abs() / scale
    if not bool((err <= rtol).all()):
        raise AssertionError(f"{name} sums: max err {float(err.max())} of the "
                             f"row scale > rtol {rtol}")
    return float((served_rows(kind, got[0]) - served_rows(kind, want[0]))
                 .abs().max())


def check_kernels(asia_vbn, lg_vbn):
    """Kernel vs plain version at B_CHECK x S_CHECK; returns max abs err
    per kernel."""
    import torch

    from vectorizedbayesiannetwork_torch.ops import sweep

    errs = {"categorical": 0.0, "lg": 0.0}
    dev = asia_vbn.device
    gen = torch.Generator(device=dev).manual_seed(1234)
    fixed, counts, plan_struct, _ = kernel_inputs(asia_vbn, asia_query(B_CHECK), False)
    n = plan_struct[0]
    u = torch.rand((B_CHECK, n, S_CHECK), generator=gen, device=dev)
    u = u.clamp(1e-6, 1 - 1e-6)
    modes = [("logw", "lpt"), ("logw", "tgt"), ("lpt",), ("pmf_logw",),
             ("pmf_lpt",), ("mom_logw",), ("mom_lpt",)]
    for want in modes:
        for u_ext in (u, None):
            k_out = sweep.categorical_sweep_fused(
                77, fixed, counts, plan_struct, S_CHECK, u_ext=u_ext, want=want)
            p_out = sweep.categorical_sweep_plain(
                77, fixed, counts, plan_struct, S_CHECK, u_ext=u_ext, want=want)
            torch.cuda.synchronize()
            tag = f"categorical {want} {'u_ext' if u_ext is not None else 'philox'}"
            for label, kk, pp in zip(("logw", "tgt", "lpt"), k_out[:3], p_out[:3]):
                if (kk is None) != (pp is None):
                    raise AssertionError(f"{tag} {label}: outputs differ in presence")
                if kk is None:
                    continue
                e = compare(f"{tag} {label}", kk, pp, exact=label == "tgt",
                            atol=1e-4)
                errs["categorical"] = max(errs["categorical"], e)
            if k_out[3] is not None:
                kind = want[0].split("_")[0]
                e = compare_red(tag, k_out[3], p_out[3], kind,
                                rtol=2e-4 if kind == "pmf" else 2e-3,
                                shift_atol=1e-4)
                errs["categorical"] = max(errs["categorical"], e)
            log("kernel_check", kernel="vbn_cat_sweep", want=list(want),
                uniforms="u_ext" if u_ext is not None else "philox", ok=True)

    fixed, ptab, plan_struct, dmax = kernel_inputs(lg_vbn, flagship_query(B_CHECK), True)
    n = plan_struct[0]
    u = torch.rand((B_CHECK, 2 * n, S_CHECK), generator=gen, device=dev)
    u = u.clamp(1e-6, 1 - 1e-6)
    modes = [("logw", "lpt"), ("logw", "tgt"), ("lpt",), ("mom_logw",), ("mom_lpt",)]
    for want in modes:
        for u_ext in (u, None):
            k_out = sweep.lg_sweep_fused(
                78, fixed, ptab, plan_struct, dmax, S_CHECK, u_ext=u_ext, want=want)
            p_out = sweep.lg_sweep_plain(
                78, fixed, ptab, plan_struct, dmax, S_CHECK, u_ext=u_ext, want=want)
            torch.cuda.synchronize()
            tag = f"lg {want} {'u_ext' if u_ext is not None else 'philox'}"
            for label, kk, pp in zip(("logw", "tgt", "lpt"), k_out[:3], p_out[:3]):
                if (kk is None) != (pp is None):
                    raise AssertionError(f"{tag} {label}: outputs differ in presence")
                if kk is None:
                    continue
                e = compare(f"{tag} {label}", kk, pp,
                            atol=2e-4 if label == "tgt" else 2e-3)
                errs["lg"] = max(errs["lg"], e)
            if k_out[3] is not None:
                e = compare_red(tag, k_out[3], p_out[3], "mom", rtol=2e-3,
                                shift_atol=2e-3)
                errs["lg"] = max(errs["lg"], e)
            log("kernel_check", kernel="vbn_lg_sweep", want=list(want),
                uniforms="u_ext" if u_ext is not None else "philox", ok=True)
    return errs


def fitted_discrete_bn(bn, vbn):
    """DiscreteBN whose CPTs are the port's normalized counts."""
    from benchmarking.bif import DiscreteBN

    fit = DiscreteBN(name="asia_fitted")
    for node in vbn.dag.topological_order():
        cnt = vbn.params[node]["counts"][0].double().cpu().numpy()
        cpt = cnt / cnt.sum(axis=-1, keepdims=True)
        cards = tuple(bn.card(p) for p in vbn.dag.parents(node))
        fit.nodes.append(node)
        fit.states[node] = bn.states[node]
        fit.parents[node] = list(vbn.dag.parents(node))
        fit.cpts[node] = cpt.reshape(cards + (cpt.shape[-1],))
    fit.validate()
    return fit


def serve_main_path(bn, asia_vbn, lg_vbn):
    from benchmarking.exact import exact_posterior

    from vectorizedbayesiannetwork_torch.ops import sweep

    for k in sweep.LAUNCHES:
        sweep.LAUNCHES[k] = 0
    qa = asia_query(B_MAIN)
    pmf, spans = asia_vbn.infer_posterior_pmf([qa], n_classes=2)
    path_asia = asia_vbn._last_summary_path
    ql = flagship_query(B_MAIN)
    mom, _ = lg_vbn.infer_posterior_moments([ql])
    path_lg = lg_vbn._last_summary_path
    launches = dict(sweep.LAUNCHES)
    log("main_path", launches=launches, path_asia=path_asia, path_lg=path_lg)
    if launches["categorical"] < 1 or launches["lg"] < 1:
        raise AssertionError(f"main path skipped a kernel: {launches}")
    if path_asia != "fused" or path_lg != "fused":
        raise AssertionError(f"summary paths {path_asia}, {path_lg} != fused")

    if pmf.shape != (B_MAIN, 2) or not np.isfinite(pmf).all():
        raise AssertionError(f"asia pmf rows bad: {pmf.shape}")
    pmf = pmf / pmf.sum(axis=1, keepdims=True)
    fit_bn = fitted_discrete_bn(bn, asia_vbn)
    ev = qa["evidence"]
    err_asia = 0.0
    for r in range(4):  # the 4 evidence patterns repeat down the batch
        exact = exact_posterior(fit_bn, "dysp", {
            "smoke": int(ev["smoke"][r, 0]), "asia": int(ev["asia"][r, 0])})
        rows = pmf[r::4]
        err_asia = max(err_asia, float(np.abs(rows - exact[None]).max()))
    p = lg_vbn.params["x2"]
    w = p["weight"][:, 0].double().cpu().numpy()
    sigma = float(np.sqrt(max(float(p["var"][0]), lg_vbn.nodes["x2"].min_scale ** 2)))
    mean_cf = ql["evidence"]["x0"][:, 0] * w[0] + ql["evidence"]["x1"][:, 0] * w[1] \
        + float(p["bias"][0])
    if mom.shape != (B_MAIN, 2) or not np.isfinite(mom).all():
        raise AssertionError(f"flagship moments rows bad: {mom.shape}")
    err_mean = float(np.abs(mom[:, 0] - mean_cf).max())
    err_std = float(np.abs(mom[:, 1] - sigma / np.sqrt(2.0)).max())
    log("main_path_accuracy", asia_pmf_max_abs_err=err_asia,
        flagship_mean_max_abs_err=err_mean, flagship_std_max_abs_err=err_std)
    if err_asia > 5e-3:
        raise AssertionError(f"asia pmf off the exact posterior by {err_asia}")
    if err_mean > 1e-3 or err_std > 1e-3:
        raise AssertionError(f"flagship moments off closed form: {err_mean}, {err_std}")
    return launches


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def cat_cost(plan_struct, counts, b, s, want, k):
    """(operations, bytes) of one categorical sweep call, counting each
    integer, float and transcendental instruction of the algorithm as one
    operation: per latent node a Philox-4x32-10 call (10 rounds of 2 mul.lo,
    2 mul.hi, 4 xor, 2 key adds) and the uniform (3), the parent row (2 per
    parent), the class total (c-1), the threshold (1) and the walk (3(c-1));
    per fixed node the row and total; 5 per weighted node (div, 2 max, log,
    add); per particle the reduction (3 + 2K for a histogram, 3 + 5 for
    moments). Bytes: each input read once, each output written once."""
    from vectorizedbayesiannetwork_torch.ops import sweep

    n, parent_idx, ev, do, t, _offs, _ps, cards, _st = plan_struct
    rows, cmax = counts.shape
    red = next(w for w in want if "_" in w)
    per = 0
    for i in range(n):
        c, npar = cards[i], len(parent_idx[i])
        per += 2 * npar + (c - 1)
        if not (ev[i] or do[i]):
            per += 100 + 3 + 1 + 3 * (c - 1)
        if (ev[i] and red.endswith("logw")) or (i == t and red.endswith("lpt")):
            per += 5
    per += 3 + (2 * k if red.startswith("pmf") else 5)
    nblk = s // (sweep._THREADS * sweep._ppt(s))  # blocks per row
    meta = 4 * n + 1 + 2 * sum(len(p) for p in parent_idx)
    nbytes = 4 * (b * n + rows * cmax + meta + b * nblk * (k + 1))
    return per * b * s, nbytes


def lg_cost(plan_struct, dmax, b, s, want):
    """(operations, bytes) of one LG sweep call, counted as ``cat_cost``:
    per latent node Philox (100), two uniforms (6), Box-Muller (6: log, mul,
    sqrt, mul, cos, mul), the location (2 per parent, then 2); 8 per
    weighted node; 8 per particle for the moments."""
    from vectorizedbayesiannetwork_torch.ops import sweep

    n, parent_idx, ev, do, t = plan_struct
    red = next(w for w in want if "_" in w)
    per = 0
    for i in range(n):
        per += 2 * len(parent_idx[i])
        if not (ev[i] or do[i]):
            per += 100 + 6 + 6 + 2
        if (ev[i] and red.endswith("logw")) or (i == t and red.endswith("lpt")):
            per += 8
    per += 8
    nblk = s // (sweep._THREADS * sweep._ppt(s))  # blocks per row
    meta = 2 * n + 1 + sum(len(p) for p in parent_idx)
    nbytes = 4 * (b * n + n * (dmax + 2) + meta + b * nblk * 4)
    return per * b * s, nbytes


def at_main_shape(kernel, plain, kind, *, rtol, shift_atol):
    """Time ``kernel()`` (the wrapper at the main-path shapes, CUDA events),
    then the plain version over the same batch, B_PLAIN rows at a time
    (``plain(r0, r1)`` reproduces the kernel's Philox draws for rows
    r0..r1-1), timed once over the whole batch, and hold the two
    reductions against each other. Returns (ms, plain_ms, served-row max
    abs err)."""
    import torch

    ms = cuda_ms(kernel, 5)
    got = kernel()[3]
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    parts = [plain(r, min(r + B_PLAIN, B_MAIN))[3]
             for r in range(0, B_MAIN, B_PLAIN)]
    t1.record()
    torch.cuda.synchronize()
    want = (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]))
    err = compare_red(f"{kind} at B={B_MAIN} S={S_MAIN}", got, want, kind,
                      rtol=rtol, shift_atol=shift_atol)
    return ms, t0.elapsed_time(t1), err


def kernel_row(name, replaces, launches, err, ms, plain_ms, cost):
    ops, nbytes = cost
    t_ops, t_bytes = ops / PEAK_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return {
        "name": name, "route": "cuda",
        "source": "vectorizedbayesiannetwork_torch/csrc/sweep.cu",
        "replaces": replaces, "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None, "ops": ops, "bytes": nbytes,
    }


def time_kernels(asia_vbn, lg_vbn, launches, errs):
    """Each kernel at the main path's shapes, in its main-path ``want``
    mode and in-kernel Philox mode, against its plain version."""
    from vectorizedbayesiannetwork_torch.core.rng import philox_uniforms
    from vectorizedbayesiannetwork_torch.ops import sweep

    fixed, counts, st, _ = kernel_inputs(asia_vbn, asia_query(B_MAIN), False)
    want = ("pmf_logw",)
    ms, plain_ms, err = at_main_shape(
        lambda: sweep.categorical_sweep_fused(
            5, fixed, counts, st, S_MAIN, want=want),
        lambda r0, r1: sweep.categorical_sweep_plain(
            5, fixed[r0:r1], counts, st, S_MAIN, want=want,
            u_ext=philox_uniforms(5, r1 - r0, st[0], S_MAIN, 1, fixed.device, row0=r0)),
        "pmf", rtol=2e-4, shift_atol=1e-4)
    log("kernel_main_shape", kernel="vbn_cat_sweep", ms=ms, plain_ms=plain_ms,
        served_row_max_abs_err=err)
    k = st[7][st[4]]
    cat = kernel_row(
        "vbn_cat_sweep", "vectorizedbayesiannetwork_tpu/ops/sweep_pallas.py:207",
        launches["categorical"], max(errs["categorical"], err), ms, plain_ms,
        cat_cost(st, counts, B_MAIN, S_MAIN, want, k))

    fixed, ptab, st, dmax = kernel_inputs(lg_vbn, flagship_query(B_MAIN), True)
    want = ("mom_lpt",)
    ms, plain_ms, err = at_main_shape(
        lambda: sweep.lg_sweep_fused(
            6, fixed, ptab, st, dmax, S_MAIN, want=want),
        lambda r0, r1: sweep.lg_sweep_plain(
            6, fixed[r0:r1], ptab, st, dmax, S_MAIN, want=want,
            u_ext=philox_uniforms(6, r1 - r0, st[0], S_MAIN, 2, fixed.device, row0=r0)),
        "mom", rtol=2e-3, shift_atol=2e-3)
    log("kernel_main_shape", kernel="vbn_lg_sweep", ms=ms, plain_ms=plain_ms,
        served_row_max_abs_err=err)
    lg = kernel_row(
        "vbn_lg_sweep", "vectorizedbayesiannetwork_tpu/ops/sweep_pallas.py:514",
        launches["lg"], max(errs["lg"], err), ms, plain_ms,
        lg_cost(st, dmax, B_MAIN, S_MAIN, want))
    return [cat, lg]


def end_to_end_qps(serve, batch):
    """queries/s: REPS batches per window, best of WINDOWS windows."""
    serve()
    serve()
    qps = []
    for _ in range(WINDOWS):
        t0 = time.perf_counter()
        serve()  # fetches the rows to the host: synchronous
        qps.append(batch * REPS / (time.perf_counter() - t0))
    return max(qps), qps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from vectorizedbayesiannetwork_torch import VBN, defaults
    from vectorizedbayesiannetwork_torch.ops import _build

    secs = _build.build_all()
    log("build", seconds=secs)
    for name in _build.SOURCES:
        print(_build.build_log(name).strip(), flush=True)

    t0 = time.perf_counter()
    bn, asia_vbn = fit_asia(VBN, defaults)
    lg_vbn = fit_flagship(VBN, defaults)
    asia_vbn.set_inference_method("likelihood_weighting", n_samples=S_MAIN)
    lg_vbn.set_inference_method("monte_carlo_marginalization", n_samples=S_MAIN)
    torch.cuda.synchronize()
    log("fit", seconds=time.perf_counter() - t0)

    errs = check_kernels(asia_vbn, lg_vbn)
    log("kernel_check_done", max_abs_err=errs)

    torch.cuda.reset_peak_memory_stats()
    launches = serve_main_path(bn, asia_vbn, lg_vbn)
    log("main_path_memory",
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated())

    kernels = time_kernels(asia_vbn, lg_vbn, launches, errs)
    qa, ql = asia_query(B_MAIN), flagship_query(B_MAIN)
    torch.cuda.reset_peak_memory_stats()
    asia_qps, asia_w = end_to_end_qps(
        lambda: asia_vbn.infer_posterior_pmf([qa] * REPS, n_classes=2), B_MAIN)
    lg_qps, lg_w = end_to_end_qps(
        lambda: lg_vbn.infer_posterior_moments([ql] * REPS), B_MAIN)
    log("end_to_end", asia_lw_pmf_qps=asia_qps, asia_window_qps=asia_w,
        flagship_mcm_moments_qps=lg_qps, flagship_window_qps=lg_w,
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    # where a served batch's time goes: the kernel's share of it (the rest
    # is host work, the partials' combine and the fetch of the rows)
    for tag, qps, row in (("asia", asia_qps, kernels[0]),
                          ("flagship", lg_qps, kernels[1])):
        batch_ms = 1e3 * B_MAIN / qps
        log("serve_breakdown", workload=tag, batch_ms=batch_ms,
            kernel_ms=row["ms"], kernel_share=row["ms"] / batch_ms)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
