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

Then the mask-dynamic slice, on two large networks at full width: the
link-scale categorical network (``random_bn_treewidth(724)``, LW pmf) and
the arth150-scale linear-Gaussian one (``random_gaussian(107)``, LW
moments), each fitted on 4096 rows and served 96 heterogeneous single-row
queries at S=2^20 with ``dynamic_masks=True``:

6. scan_kernel_check: ``vbn_cat_scan`` and ``vbn_lg_scan`` against their
   plain versions at B=8, S=2^16 in every ``want`` mode, on external
   uniforms and in-kernel Philox, on the 724-node network, a network with
   up to 80 classes and the 107-node one; and ``vbn_cat_scan`` against
   ``vbn_cat_sweep`` bit for bit on asia's static plan;
7. dynamic_main_path: ``infer_posterior_pmf`` on the 96 link-scale queries
   and ``infer_posterior_moments`` on the 96 LG queries, each with the
   launch counters reset just before and read just after; pmf rows held
   against the exact posterior of the fitted CPTs (median KL), moments
   against the fitted network's closed form; peak device memory;
8. dynamic_streams (S=2^16): ``infer_posterior_many`` with LW and MCM on 8
   link-scale queries, one launch each, and one static 724-node LW query
   through the static plan's scan route;
9. scan timing: each scan kernel's ms at the main-path shape, the plain
   version over SCAN_PLAIN_ROWS rows of it (scaled to the batch), the
   bound, and the end-to-end queries/s of both workloads.

Prints a JSON line of kernel results (all four kernels), the card's name
and power limit, and last ``{"ok": true, "device": {...}}``. Any failure
exits nonzero. The script imports nothing of JAX or of the JAX package.
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
N_DYN = 96  # heterogeneous single-row queries per served batch
S_STREAMS = 1 << 16  # depth of the dynamic_streams phase
SCAN_PLAIN_ROWS = 2  # rows of the scan plain versions timed at full width
SCAN_REPS = 3  # kernel launches per CUDA-event window
SCAN_WINDOWS = 3  # served batches timed end to end, best of
CAT_WANTS = [("logw", "lpt"), ("logw", "tgt"), ("lpt",), ("pmf_logw",),
             ("pmf_lpt",), ("mom_logw",), ("mom_lpt",)]
LG_WANTS = [("logw", "lpt"), ("logw", "tgt"), ("lpt",), ("mom_logw",),
            ("mom_lpt",)]


def log(tag: str, **kv) -> None:
    print(json.dumps({"phase": tag, **kv}), flush=True)


def fit_discrete(vbn_cls, defaults, bn, seed=0):
    """The port's fit of a discrete network on 4096 rows of its data."""
    from benchmarking.data_gen import generate_dataset

    data = generate_dataset(bn, 4096, seed=seed)
    vbn = vbn_cls({n: bn.parents[n] for n in bn.nodes}, seed=seed)
    conf = {}
    for node in bn.nodes:
        c = dict(defaults.cpd("categorical_table"), n_classes=bn.card(node))
        if bn.parents[node]:
            c["parent_n_classes"] = [bn.card(p) for p in bn.parents[node]]
        conf[node] = c
    vbn.set_learning_method("node_wise", nodes_cpds=conf)
    vbn.fit({k: np.asarray(v, np.float32).reshape(-1, 1) for k, v in data.items()})
    return vbn


def fit_asia(vbn_cls, defaults):
    from benchmarking.networks import asia

    bn = asia()
    return bn, fit_discrete(vbn_cls, defaults, bn)


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


def check_outputs(tag, k_out, p_out, want, *, tgt_atol, lp_atol):
    """Streams within the tolerances (classes exact when tgt_atol is 0),
    reductions as ``compare_red``; returns the max abs error."""
    err = 0.0
    for label, kk, pp in zip(("logw", "tgt", "lpt"), k_out[:3], p_out[:3]):
        if (kk is None) != (pp is None):
            raise AssertionError(f"{tag} {label}: outputs differ in presence")
        if kk is not None:
            err = max(err, compare(
                f"{tag} {label}", kk, pp, exact=label == "tgt" and tgt_atol == 0,
                atol=tgt_atol if label == "tgt" else lp_atol))
    if k_out[3] is not None:
        kind = next(w for w in want if "_" in w).split("_")[0]
        err = max(err, compare_red(tag, k_out[3], p_out[3], kind,
                                   rtol=2e-4 if kind == "pmf" else 2e-3,
                                   shift_atol=lp_atol))
    return err


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
            errs["categorical"] = max(errs["categorical"], check_outputs(
                tag, k_out, p_out, want, tgt_atol=0, lp_atol=1e-4))
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
            errs["lg"] = max(errs["lg"], check_outputs(
                tag, k_out, p_out, want, tgt_atol=2e-4, lp_atol=2e-3))
            log("kernel_check", kernel="vbn_lg_sweep", want=list(want),
                uniforms="u_ext" if u_ext is not None else "philox", ok=True)
    return errs


def fitted_discrete_bn(bn, vbn, floor=0.0):
    """DiscreteBN whose CPTs are the port's normalized counts, each entry
    at least ``floor``."""
    from benchmarking.bif import DiscreteBN

    fit = DiscreteBN(name=f"{bn.name}_fitted")
    for node in vbn.dag.topological_order():
        cnt = vbn.params[node]["counts"][0].double().cpu().numpy()
        cpt = np.maximum(cnt / cnt.sum(axis=-1, keepdims=True), floor)
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


def kernel_row(name, replaces, launches, err, ms, plain_ms, cost,
               source="vectorizedbayesiannetwork_torch/csrc/sweep.cu"):
    ops, nbytes = cost
    t_ops, t_bytes = ops / PEAK_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return {
        "name": name, "route": "cuda", "source": source,
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


# ---------------------------------------------------------------------------
# The mask-dynamic slice: large networks on the scan kernels
# ---------------------------------------------------------------------------


def reset_launches():
    from vectorizedbayesiannetwork_torch.ops import sweep

    for k in sweep.LAUNCHES:
        sweep.LAUNCHES[k] = 0


def read_launches(expect):
    """The counters since the last reset; fails unless exactly the kernels
    in ``expect`` ran, as many times as it says."""
    from vectorizedbayesiannetwork_torch.ops import sweep

    got = dict(sweep.LAUNCHES)
    want = {k: expect.get(k, 0) for k in got}
    if got != want:
        raise AssertionError(f"launches {got} != {want}")
    return got


def as_query(target, evidence, do=None):
    def col(v):
        return np.full((1, 1), float(v), np.float32)

    return {"target": target,
            "evidence": {n: col(v) for n, v in evidence.items()},
            "do": {n: col(v) for n, v in (do or {}).items()}}


def link_queries(bn):
    """The 96 heterogeneous queries of benchmarking/linkscale_1m.py:55-78:
    a random target and 2 evidence nodes with random values each, seed 7
    (that script skips a query whose exact posterior fails; none does on
    this network)."""
    rng = np.random.default_rng(7)
    nodes = list(bn.nodes)
    out = []
    while len(out) < N_DYN:
        t = nodes[int(rng.integers(0, len(nodes)))]
        pool = [n for n in nodes if n != t]
        evn = [pool[int(i)] for i in rng.choice(len(pool), 2, replace=False)]
        out.append((t, {n: int(rng.integers(0, bn.card(n))) for n in evn}))
    return out


def gauss_queries(gbn):
    """96 single-row queries on the LG network: a random target and 1-2
    evidence nodes each, their values from one ancestral draw of the
    network (seed 7)."""
    rng = np.random.default_rng(7)
    draw = gbn.sample(1, seed=7)
    nodes = list(gbn.nodes)
    out = []
    for _ in range(N_DYN):
        t = nodes[int(rng.integers(0, len(nodes)))]
        pool = [n for n in nodes if n != t]
        evn = [pool[int(i)]
               for i in rng.choice(len(pool), int(rng.integers(1, 3)),
                                   replace=False)]
        out.append((t, {n: float(draw[n][0]) for n in evn}))
    return out


def hetero_queries(bn, b, seed):
    """b queries mixing a target, two evidence nodes and one do node each."""
    rng = np.random.default_rng(seed)
    nodes = list(bn.nodes)
    out = []
    for _ in range(b):
        t, e1, e2, d = (nodes[int(i)]
                        for i in rng.choice(len(nodes), 4, replace=False))
        out.append(as_query(
            t, {e: int(rng.integers(0, bn.card(e))) for e in (e1, e2)},
            {d: int(rng.integers(0, bn.card(d)))}))
    return out


def fit_gaussian(vbn_cls, defaults, gbn):
    vbn = vbn_cls({n: gbn.parents[n] for n in gbn.nodes}, seed=0)
    vbn.set_learning_method(
        "node_wise",
        nodes_cpds={n: defaults.cpd("linear_gaussian") for n in gbn.nodes})
    vbn.fit(gbn.sample(4096, seed=0))
    return vbn


def fitted_gaussian_bn(vbn):
    """GaussianBN with the port's fitted weights, biases and
    sigma = sqrt(max(var, min_scale^2))."""
    from benchmarking.gaussian_bn import GaussianBN

    fit = GaussianBN(name="fitted")
    for node in vbn.dag.topological_order():
        p = vbn.params[node]
        fit.nodes.append(node)
        fit.parents[node] = list(vbn.dag.parents(node))
        fit.weights[node] = p["weight"][:, 0].double().cpu().tolist()
        fit.bias[node] = float(p["bias"][0])
        fit.sigma[node] = float(np.sqrt(max(float(p["var"][0]),
                                            vbn.nodes[node].min_scale ** 2)))
    return fit


def link_accuracy(bn, vbn, queries, pmf, spans):
    """KL(exact || served) and max abs error of each served pmf row, the
    exact posterior taken on the fitted CPTs with every entry floored at
    1e-12, the samplers' own clamp (log max(p, 1e-12)): a class the 4096
    rows never show has probability 0 under the fitted CPTs (``prior:
    global``), and evidence on it would leave the exact posterior
    undefined. ``zero_evidence`` counts the queries with an evidence value
    that some row of its fitted CPT gives probability 0."""
    from benchmarking.exact import exact_posterior, min_fill_order

    raw = fitted_discrete_bn(bn, vbn)
    zero = sum(
        any(float(raw.cpts[n][..., v].min()) == 0.0 for n, v in ev.items())
        for _t, ev in queries)
    fit = fitted_discrete_bn(bn, vbn, floor=1e-12)
    order = min_fill_order(fit)
    kls, errs = [], []
    for (lo, _hi, _t), (t, ev) in zip(spans, queries):
        gt = np.asarray(exact_posterior(fit, t, ev, elim_order=order))
        r = pmf[lo][: len(gt)].astype(np.float64)
        r = r / max(r.sum(), 1e-30)
        kls.append(float(np.sum(gt * np.log(np.maximum(gt, 1e-12)
                                            / np.maximum(r, 1e-12)))))
        errs.append(float(np.abs(r - gt).max()))
    return {"kl_median": float(np.median(kls)), "kl_max": float(max(kls)),
            "max_abs_err": float(max(errs)), "zero_evidence": zero}


def gauss_accuracy(vbn, queries, mom, spans):
    """Worst |d mean| / std and |d std| / std of the served rows against
    the fitted network's closed-form posterior."""
    fit = fitted_gaussian_bn(vbn)
    worst = {"dmean_over_std": 0.0, "dstd_over_std": 0.0, "row": None}
    for (lo, _hi, _t), (t, ev) in zip(spans, queries):
        mean, std = fit.conditional(t, ev)
        dm = abs(float(mom[lo, 0]) - mean) / std
        ds = abs(float(mom[lo, 1]) - std) / std
        if max(dm, ds) > max(worst["dmean_over_std"], worst["dstd_over_std"]):
            worst["row"] = {"target": t, "evidence": ev, "mean": mean,
                            "std": std, "served": mom[lo].tolist()}
        worst["dmean_over_std"] = max(worst["dmean_over_std"], dm)
        worst["dstd_over_std"] = max(worst["dstd_over_std"], ds)
    return worst


def scan_inputs(vbn, queries):
    """(plan, cpds, params, fixed, ev, do, tgt) of the canonical plan, the
    rows packed as the main path packs them (pack_dynamic_inputs)."""
    import torch

    from vectorizedbayesiannetwork_torch.inference._dynamic_base import (
        pack_dynamic_inputs,
    )

    method = vbn._inference
    plan = method._canonical_plan(vbn)
    inputs, _spans, _b, _bp = pack_dynamic_inputs(
        plan, [vbn._normalize_query(q) for q in queries],
        clamp_obs=method.pack_clamp_obs, pad_to=len(queries))
    fixed, ev, do, tgt = (torch.as_tensor(a, device=vbn.device) for a in inputs)
    return (plan, tuple(vbn.cpd_spec(n) for n in plan.topo_order),
            tuple(vbn.params[n] for n in plan.topo_order), fixed, ev, do, tgt)


def plain_for(want, ref, k_pmf):
    """The plain version's outputs for ``want`` from its full streams
    ``ref`` (it computes the same streams whatever ``want`` asks, and
    reduces them with ``_reduce_plain``), so one plain run serves every
    ``want`` mode."""
    from vectorizedbayesiannetwork_torch.ops import sweep

    logw, tgt, lpt = ref[:3]
    want_logw, want_tgt, want_lpt, kind, src = sweep._parse_want(want)
    red = None
    if kind is not None:
        red = sweep._reduce_plain(kind, logw if src == "logw" else lpt,
                                  tgt.long() if kind == "pmf" else tgt,
                                  k_pmf if kind == "pmf" else 3)
    return (logw if want_logw else None, tgt if want_tgt else None,
            lpt if want_lpt else None, red)


def check_scan_kernels(asia_vbn, link_vbn, link_qs, high_bn, high_vbn,
                       gauss_vbn, gauss_qs):
    """Both scan kernels against their plain versions at B_CHECK x S_CHECK
    in every ``want`` mode, on external uniforms and in-kernel Philox; and
    vbn_cat_scan against vbn_cat_sweep bit for bit on asia's static plan."""
    import torch

    from vectorizedbayesiannetwork_torch.ops import sweep, sweep_scan

    errs = {"categorical_scan": 0.0, "lg_scan": 0.0}
    dev = link_vbn.device
    gen = torch.Generator(device=dev).manual_seed(4321)
    cases = [("link724", link_vbn,
              [as_query(t, ev) for t, ev in link_qs[:B_CHECK]]),
             ("highcard", high_vbn, hetero_queries(high_bn, B_CHECK, 5))]
    for tag, vbn, qs in cases:
        plan, cpds, params, fixed, ev, do, tgt = scan_inputs(vbn, qs)
        struct = sweep_scan.scan_struct_for(plan, cpds)
        packed = sweep_scan.pack_rows(fixed, ev, do, struct[2])
        flat = sweep_scan._flat_counts(cpds, params)
        u = torch.rand((B_CHECK, plan.n_nodes, S_CHECK), generator=gen,
                       device=dev).clamp(1e-6, 1 - 1e-6)
        for u_ext in (u, None):
            mode = "u_ext" if u_ext is not None else "philox"
            ref = sweep_scan.categorical_sweep_scan_plain(
                21, packed, tgt, flat, struct, S_CHECK, u_ext=u_ext,
                want=("logw", "tgt", "lpt"))
            for want in CAT_WANTS:
                k_out = sweep_scan.categorical_sweep_scan(
                    21, packed, tgt, flat, struct, S_CHECK, u_ext=u_ext,
                    want=want)
                torch.cuda.synchronize()
                errs["categorical_scan"] = max(errs["categorical_scan"], check_outputs(
                    f"vbn_cat_scan {tag} {want} {mode}", k_out,
                    plain_for(want, ref, struct[7]), want, tgt_atol=0,
                    lp_atol=1e-4))
            log("scan_kernel_check", kernel="vbn_cat_scan", network=tag,
                n_nodes=plan.n_nodes, cmax=struct[7], uniforms=mode,
                wants=[list(w) for w in CAT_WANTS], ok=True)
        del u

    plan, cpds, params, fixed, ev, do, tgt = scan_inputs(
        gauss_vbn, [as_query(t, e) for t, e in gauss_qs[:B_CHECK]])
    struct = sweep_scan.lg_scan_struct_for(plan, cpds)
    fixed, flags = sweep_scan.lg_rows(fixed, ev, do)
    ptab = sweep_scan.lg_ptab_flat(cpds, params, struct[2])
    u = torch.rand((B_CHECK, 2 * plan.n_nodes, S_CHECK), generator=gen,
                   device=dev).clamp(1e-6, 1 - 1e-6)
    for u_ext in (u, None):
        mode = "u_ext" if u_ext is not None else "philox"
        ref = sweep_scan.lg_sweep_scan_plain(
            22, fixed, flags, tgt, ptab, struct, S_CHECK, u_ext=u_ext,
            want=("logw", "tgt", "lpt"))
        for want in LG_WANTS:
            k_out = sweep_scan.lg_sweep_scan(
                22, fixed, flags, tgt, ptab, struct, S_CHECK, u_ext=u_ext,
                want=want)
            torch.cuda.synchronize()
            errs["lg_scan"] = max(errs["lg_scan"], check_outputs(
                f"vbn_lg_scan {want} {mode}", k_out, plain_for(want, ref, 3),
                want, tgt_atol=2e-4, lp_atol=2e-3))
        log("scan_kernel_check", kernel="vbn_lg_scan", network="gauss107",
            n_nodes=plan.n_nodes, uniforms=mode,
            wants=[list(w) for w in LG_WANTS], ok=True)

    # the scan kernel on a static plan draws the unrolled kernel's classes
    from vectorizedbayesiannetwork_torch.core.plan import get_plan

    q = asia_vbn._normalize_query(asia_query(B_CHECK))
    plan = get_plan(asia_vbn, q)
    cpds = tuple(asia_vbn.cpd_spec(n) for n in plan.topo_order)
    params = tuple(asia_vbn.params[n] for n in plan.topo_order)
    fixed_i, counts, st, _ = kernel_inputs(asia_vbn, asia_query(B_CHECK), False)
    bits = (torch.tensor(plan.evidence_mask, device=dev).int() << 16) | (
        torch.tensor(plan.do_mask, device=dev).int() << 17)
    tgt = torch.full((B_CHECK,), plan.target_idx, dtype=torch.int32,
                     device=dev)
    want = ("logw", "tgt", "lpt")
    a = sweep.categorical_sweep_fused(31, fixed_i, counts, st, S_CHECK, want=want)
    b = sweep_scan.categorical_sweep_scan(
        31, (fixed_i | bits).contiguous(), tgt,
        sweep_scan._flat_counts(cpds, params),
        sweep_scan.scan_struct_for(plan, cpds), S_CHECK, want=want)
    torch.cuda.synchronize()
    same = {k: bool(torch.equal(x, y)) for k, x, y in zip(want, a[:3], b[:3])}
    log("scan_matches_unrolled", network="asia", seed=31, equal=same)
    if not all(same.values()):
        raise AssertionError(f"vbn_cat_scan != vbn_cat_sweep bitwise: {same}")
    return errs


def serve_dynamic_main_path(link_bn, link_vbn, link_qs, gauss_vbn, gauss_qs):
    """Both workloads through the public entry points, each with the
    counters reset just before and read just after."""
    import torch

    qs = [as_query(t, ev) for t, ev in link_qs]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    pmf, spans = link_vbn.infer_posterior_pmf(qs, n_classes=4, pad_bucket=N_DYN)
    link_launches = read_launches({"categorical_scan": 1})
    link_mem = torch.cuda.max_memory_allocated()
    gq = [as_query(t, ev) for t, ev in gauss_qs]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    mom, gspans = gauss_vbn.infer_posterior_moments(gq, pad_bucket=N_DYN)
    lg_launches = read_launches({"lg_scan": 1})
    lg_mem = torch.cuda.max_memory_allocated()
    paths = (link_vbn._last_summary_path, gauss_vbn._last_summary_path)
    log("dynamic_main_path", launches_link=link_launches,
        launches_lg=lg_launches, path_link=paths[0], path_lg=paths[1],
        max_memory_allocated_bytes_link=link_mem,
        max_memory_allocated_bytes_lg=lg_mem)
    if paths != ("fused", "fused"):
        raise AssertionError(f"summary paths {paths} != fused")
    if pmf.shape != (N_DYN, 4) or not np.isfinite(pmf).all():
        raise AssertionError(f"link pmf rows bad: {pmf.shape}")
    if mom.shape != (N_DYN, 2) or not np.isfinite(mom).all():
        raise AssertionError(f"LG moments rows bad: {mom.shape}")
    link = link_accuracy(link_bn, link_vbn, link_qs, pmf, spans)
    lg = gauss_accuracy(gauss_vbn, gauss_qs, mom, gspans)
    log("dynamic_main_path_accuracy", link=link, lg=lg)
    if link["kl_median"] > 2e-3:
        raise AssertionError(f"link median KL {link['kl_median']} > 2e-3")
    if lg["dmean_over_std"] > 0.05 or lg["dstd_over_std"] > 0.05:
        raise AssertionError(f"LG moments off the closed form: {lg}")
    return {"categorical_scan": link_launches["categorical_scan"],
            "lg_scan": lg_launches["lg_scan"]}


def serve_dynamic_streams(link_bn, link_vbn, link_qs):
    """infer_posterior_many (LW, MCM) on 8 link-scale queries, one launch
    each, and one static 724-node LW query, at S_STREAMS."""
    from benchmarking.exact import exact_posterior

    fit = fitted_discrete_bn(link_bn, link_vbn, floor=1e-12)
    qs = [as_query(t, ev) for t, ev in link_qs[:B_CHECK]]
    report = {}
    for method in ("likelihood_weighting", "monte_carlo_marginalization"):
        link_vbn.set_inference_method(method, n_samples=S_STREAMS,
                                      dynamic_masks=True)
        reset_launches()
        res = link_vbn.infer_posterior_many(qs)
        read_launches({"categorical_scan": 1})
        for pdf, samples in res:
            if pdf.shape != (1, S_STREAMS) or samples.shape != (1, S_STREAMS, 1):
                raise AssertionError(f"{method} streams bad: {pdf.shape}")
            if not bool(pdf.isfinite().all()):
                raise AssertionError(f"{method} weights not finite")
        report[method] = len(res)
    link_vbn.set_inference_method("likelihood_weighting", n_samples=S_STREAMS)
    reset_launches()
    t, ev = link_qs[0]
    w, samples = link_vbn.infer_posterior(as_query(t, ev))
    read_launches({"categorical_scan": 1})
    gt = np.asarray(exact_posterior(fit, t, ev))
    x = samples[0, :, 0].long().cpu().numpy()
    p = np.bincount(x, weights=w[0].double().cpu().numpy(), minlength=len(gt))
    err = float(np.abs(p / p.sum() - gt).max())
    log("dynamic_streams", many_rows=report, static_query_max_abs_err=err,
        static_route="scan")
    if err > 0.05:
        raise AssertionError(f"static 724-node LW query off exact by {err}")
    link_vbn.set_inference_method("likelihood_weighting", n_samples=S_MAIN,
                                  dynamic_masks=True)


def cat_scan_cost(struct, packed, s, want, k, threads):
    """(operations, bytes) of one categorical scan call, counted as
    ``cat_cost`` counts them but per row from the row's own masks: per
    node the parent row (2 per parent) and the class total (c-1); per
    latent node Philox (100), the uniform (3), the threshold (1) and the
    walk (3(c-1)); 5 per weighted node; per particle the reduction (3 + 2
    for one histogram add, 3 + 5 for moments). Bytes: each input read
    once (packed rows, targets, table, meta), each partial written once."""
    from vectorizedbayesiannetwork_torch.ops import sweep_scan

    cards = np.asarray(struct[2])
    npar = np.asarray([sum(1 for st in row if st) for row in struct[4]])
    pk = packed.cpu().numpy()
    fx, ev = ((pk >> 16) & 3) > 0, ((pk >> 16) & 1) > 0
    per_row = (2 * npar + cards - 1).sum() + np.where(
        fx, 0, 104 + 3 * (cards - 1)).sum(axis=1)
    red = next(w for w in want if "_" in w)
    per_row = per_row + (5 * ev.sum(axis=1) if red.endswith("logw") else 5)
    per_row = per_row + 3 + (2 if red.startswith("pmf") else 5)
    nblk = s // (threads * sweep_scan._ppt(s, threads))
    b = pk.shape[0]
    meta = len(sweep_scan._cat_meta_host(struct)[0])
    nbytes = 4 * (pk.size + b + struct[5] + meta + b * nblk * (k + 1))
    return int(per_row.sum()) * s, nbytes


def lg_scan_cost(n_par, struct, flags, s, want, threads):
    """(operations, bytes) of one LG scan call, counted as ``lg_cost``
    per row: 2 per parent for the location; per latent node Philox (100),
    two uniforms (6), Box-Muller (6) and the draw (2); 8 per weighted
    node; 8 per particle for the moments."""
    from vectorizedbayesiannetwork_torch.ops import sweep_scan

    pids, pmax, dmax = struct
    n = len(pids)
    fl = flags.cpu().numpy()
    b = fl.shape[0]
    red = next(w for w in want if "_" in w)
    per_row = 2 * n_par + np.where(fl > 0, 0, 114).sum(axis=1)
    per_row = per_row + (8 * (fl & 1).sum(axis=1) if red.endswith("logw") else 8)
    per_row = per_row + 8
    nblk = s // (threads * sweep_scan._ppt(s, threads))
    nbytes = 4 * (2 * fl.size + b + n * (dmax + 2) + n * (1 + pmax)
                  + b * nblk * 4)
    return int(per_row.sum()) * s, nbytes


def time_plain_rows(plain):
    """ms of ``plain()`` (a run over SCAN_PLAIN_ROWS rows), CUDA events."""
    import torch

    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = plain()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1), out


def time_scan_kernels(link_vbn, link_qs, gauss_vbn, gauss_qs, launches, errs):
    """Each scan kernel at the main path's shape and ``want`` mode, in
    in-kernel Philox mode; its plain version over the first
    SCAN_PLAIN_ROWS rows of the same batch (same draws through ``row0``),
    scaled to the batch, and the two reductions held against each other."""
    from vectorizedbayesiannetwork_torch.ops import sweep_scan

    rows = SCAN_PLAIN_ROWS
    plan, cpds, params, fixed, ev, do, tgt = scan_inputs(
        link_vbn, [as_query(t, e) for t, e in link_qs])
    struct = sweep_scan.scan_struct_for(plan, cpds)
    packed = sweep_scan.pack_rows(fixed, ev, do, struct[2])
    flat = sweep_scan._flat_counts(cpds, params)
    want = ("pmf_logw",)
    kernel = lambda: sweep_scan.categorical_sweep_scan(  # noqa: E731
        5, packed, tgt, flat, struct, S_MAIN, want=want)
    ms = cuda_ms(kernel, SCAN_REPS)
    got = kernel()[3]
    plain_rows_ms, ref = time_plain_rows(
        lambda: sweep_scan.categorical_sweep_scan_plain(
            5, packed[:rows], tgt[:rows], flat, struct, S_MAIN, want=want))
    err = compare_red(f"vbn_cat_scan at S={S_MAIN}", (got[0][:rows], got[1][:rows]),
                      ref[3], "pmf", rtol=2e-4, shift_atol=1e-4)
    _m, n_par, n_slots = sweep_scan._cat_meta_host(struct)
    threads, tbl_smem = sweep_scan._cat_layout(
        plan.n_nodes, n_par, n_slots, struct[7], struct[5],
        limit=sweep_scan._smem_limit(0))
    log("kernel_main_shape", kernel="vbn_cat_scan", batch=N_DYN, ms=ms,
        plain_rows=rows, plain_rows_ms=plain_rows_ms,
        served_row_max_abs_err=err, threads=threads,
        table_in_shared_memory=tbl_smem)
    cat = kernel_row(
        "vbn_cat_scan", "vectorizedbayesiannetwork_tpu/ops/sweep_scan_pallas.py:210",
        launches["categorical_scan"], max(errs["categorical_scan"], err), ms,
        plain_rows_ms * N_DYN / rows,
        cat_scan_cost(struct, packed, S_MAIN, want, struct[7], threads),
        source="vectorizedbayesiannetwork_torch/csrc/sweep_scan.cu")
    cat["plain_ms_from_rows"] = rows

    plan, cpds, params, fixed, ev, do, tgt = scan_inputs(
        gauss_vbn, [as_query(t, e) for t, e in gauss_qs])
    struct = sweep_scan.lg_scan_struct_for(plan, cpds)
    fixed, flags = sweep_scan.lg_rows(fixed, ev, do)
    ptab = sweep_scan.lg_ptab_flat(cpds, params, struct[2])
    want = ("mom_logw",)
    kernel = lambda: sweep_scan.lg_sweep_scan(  # noqa: E731
        6, fixed, flags, tgt, ptab, struct, S_MAIN, want=want)
    ms = cuda_ms(kernel, SCAN_REPS)
    got = kernel()[3]
    plain_rows_ms, ref = time_plain_rows(
        lambda: sweep_scan.lg_sweep_scan_plain(
            6, fixed[:rows], flags[:rows], tgt[:rows], ptab, struct, S_MAIN,
            want=want))
    err = compare_red(f"vbn_lg_scan at S={S_MAIN}", (got[0][:rows], got[1][:rows]),
                      ref[3], "mom", rtol=2e-3, shift_atol=2e-3)
    threads = sweep_scan._lg_threads(
        plan.n_nodes, struct[1], sweep_scan._compaction(struct[0])[2], True,
        limit=sweep_scan._smem_limit(0))
    log("kernel_main_shape", kernel="vbn_lg_scan", batch=N_DYN, ms=ms,
        plain_rows=rows, plain_rows_ms=plain_rows_ms,
        served_row_max_abs_err=err, threads=threads)
    lg = kernel_row(
        "vbn_lg_scan", "vectorizedbayesiannetwork_tpu/ops/sweep_scan_pallas.py:978",
        launches["lg_scan"], max(errs["lg_scan"], err), ms,
        plain_rows_ms * N_DYN / rows,
        lg_scan_cost(sum(len(p) for p in plan.parent_idx), struct, flags,
                     S_MAIN, want, threads),
        source="vectorizedbayesiannetwork_torch/csrc/sweep_scan.cu")
    lg["plain_ms_from_rows"] = rows
    return [cat, lg]


def profile_batch(serve):
    """One served batch under torch.profiler: its wall ms (host clock, to
    the rows' fetch), the device's busy ms (kernels and copies), the
    scan kernel's ms, and the device's idle share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return {"wall_ms": wall, "device": "not measured (no CUDA events)"}
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    scan = sum(e.time_range.elapsed_us() for e in dev
               if "scan_kernel" in e.name) / 1e3
    return {"wall_ms": wall, "device_busy_ms": busy, "scan_kernel_ms": scan,
            "device_events": len(dev), "idle_share": 1.0 - busy / wall}


def dynamic_qps(serve):
    """queries/s of one served batch of N_DYN queries, best of
    SCAN_WINDOWS (each window one batch, ending in the rows' fetch)."""
    serve()
    qps = []
    for _ in range(SCAN_WINDOWS):
        t0 = time.perf_counter()
        serve()
        qps.append(N_DYN / (time.perf_counter() - t0))
    return max(qps), qps


def serve_large_networks(vbn_cls, defaults, asia_vbn):
    """Phases 6-9 (the mask-dynamic slice); returns the scan kernels'
    rows of the kernel line."""
    from benchmarking.gaussian_bn import random_gaussian
    from benchmarking.networks import random_bn, random_bn_treewidth

    t0 = time.perf_counter()
    link_bn = random_bn_treewidth(724, seed=0)
    link_vbn = fit_discrete(vbn_cls, defaults, link_bn)
    link_vbn.set_inference_method("likelihood_weighting", n_samples=S_MAIN,
                                  dynamic_masks=True)
    high_bn = random_bn(n_nodes=6, max_card=80, max_indegree=1, seed=0)
    high_vbn = fit_discrete(vbn_cls, defaults, high_bn, seed=3)
    high_vbn.set_inference_method("likelihood_weighting", n_samples=S_CHECK,
                                  dynamic_masks=True)
    gbn = random_gaussian(107, seed=0)
    gauss_vbn = fit_gaussian(vbn_cls, defaults, gbn)
    gauss_vbn.set_inference_method("likelihood_weighting", n_samples=S_MAIN,
                                   dynamic_masks=True)
    link_qs, gauss_qs = link_queries(link_bn), gauss_queries(gbn)
    log("fit_large", seconds=time.perf_counter() - t0,
        link_nodes=len(link_bn.nodes), gauss_nodes=len(gbn.nodes))

    t0 = time.perf_counter()
    errs = check_scan_kernels(asia_vbn, link_vbn, link_qs, high_bn, high_vbn,
                              gauss_vbn, gauss_qs)
    log("scan_kernel_check_done", max_abs_err=errs,
        seconds=time.perf_counter() - t0)
    launches = serve_dynamic_main_path(link_bn, link_vbn, link_qs, gauss_vbn,
                                       gauss_qs)
    serve_dynamic_streams(link_bn, link_vbn, link_qs)
    kernels = time_scan_kernels(link_vbn, link_qs, gauss_vbn, gauss_qs,
                                launches, errs)
    lq = [as_query(t, ev) for t, ev in link_qs]
    gq = [as_query(t, ev) for t, ev in gauss_qs]
    link_qps, link_w = dynamic_qps(lambda: link_vbn.infer_posterior_pmf(
        lq, n_classes=4, pad_bucket=N_DYN))
    lg_qps, lg_w = dynamic_qps(lambda: gauss_vbn.infer_posterior_moments(
        gq, pad_bucket=N_DYN))
    log("end_to_end_dynamic", link724_lw_pmf_qps=link_qps,
        link724_window_qps=link_w, gauss107_lw_moments_qps=lg_qps,
        gauss107_window_qps=lg_w)
    for tag, qps, row in (("link724", link_qps, kernels[0]),
                          ("gauss107", lg_qps, kernels[1])):
        batch_ms = 1e3 * N_DYN / qps
        log("serve_breakdown", workload=tag, batch_ms=batch_ms,
            kernel_ms=row["ms"], kernel_share=row["ms"] / batch_ms)
    log("serve_profile", workload="link724", **profile_batch(
        lambda: link_vbn.infer_posterior_pmf(lq, n_classes=4, pad_bucket=N_DYN)))
    log("serve_profile", workload="gauss107", **profile_batch(
        lambda: gauss_vbn.infer_posterior_moments(gq, pad_bucket=N_DYN)))
    return kernels


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

    kernels += serve_large_networks(VBN, defaults, asia_vbn)

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
