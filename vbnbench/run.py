"""One run of one benchmark cell of the PyTorch and CUDA port.

    python3 -m vbnbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the port
(``vectorizedbayesiannetwork_torch``). A run builds or loads the port's
kernels (``ops/_build.py``, cached in ``build/kernels/`` inside the
checkout), makes the cell's network data and query pool from the seed,
fits the network with ``VBN.fit``, warms up every call of the pool, and
then serves from one client in a closed loop for ``--seconds``: the next
call is issued when the previous call's rows are on the host. After the
window it judges a sample of the served rows against the plain reference
(``check.py``) and prints one JSON line, last on standard output.

``--trace 0`` reports the cell's end-to-end metrics: ``queries_per_s``
(rows answered in the window over its seconds), ``batch_ms_p95`` (the
95th percentile of every call's time from issue to rows on the host) and
``setup_s`` (process start to the first timed call). ``--trace 1``
profiles the first calls of the window and reports the per-layer
metrics, read by ``metrics/<name>.py``, with the device's busy and window
seconds and a breakdown.

Exit codes: 0 with a result; 2 without a CUDA device (or fewer than the
cell asks for); 5 when JAX or the JAX package is loaded after the window.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import zlib  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

import numpy as np  # noqa: E402

from . import check, networks, registry, traffic  # noqa: E402
from .peaks import least_ms  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "vectorizedbayesiannetwork_tpu")
N_TRACED = 12  # calls profiled in a --trace 1 run


def sub_seed(seed: int, name: str) -> int:
    """A 32-bit seed for one use of the run's seed."""
    ss = np.random.SeedSequence([int(seed) % 2**64, zlib.crc32(name.encode())])
    return int(ss.generate_state(1)[0])


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def power_limit() -> str:
    """The card's power limit, printed beside every run's numbers."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=False).stdout
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.strip().splitlines()[0] if out.strip() else "not read"


class Cell:
    """A cell's network, data, fitted VBN and call pool, each piece found
    by its name under ``root`` (``registry``)."""

    def __init__(self, bench, name, seed, device, overrides, root=registry.HERE):
        self.entry = registry.cell(bench, name)
        self.name = name
        self.root = root
        self.config = registry.config(bench, self.entry["config"],
                                      checkout=root.parent)
        self.mix = registry.mix(self.entry["traffic"], root)
        self.limits = registry.limits(name, root)
        self.seed = seed
        self.device = device
        ov = dict(overrides or {})
        self.s = int(ov.get("n_samples",
                            self.config["method"]["params"]["n_samples"]))
        self.s_control = self.s // int(self.config["control"]["n_samples_divisor"])
        if "rows_per_call" in ov:
            self.mix["rows_per_call"] = int(ov["rows_per_call"])
            self.mix.setdefault("call_kwargs", {})
            if "pad_bucket" in self.mix["call_kwargs"]:
                self.mix["call_kwargs"]["pad_bucket"] = int(ov["rows_per_call"])
        self.sample_rows = int(ov.get("sample_rows", self.limits["sample_rows"]))
        self.net = networks.build(self.config["network"], root)
        self.family = self.config["cpd"]["family"]
        self.reference = registry.reference(self.family, root)
        self.work = registry.work_counter(self.family, root)
        self.data = self.net.sample(int(self.config["fit_rows"]),
                                    sub_seed(seed, "data"))
        self.calls = traffic.make_calls(self.net, self.mix,
                                        sub_seed(seed, "traffic"))

    def generator(self, name: str):
        """A torch generator on the cell's device, seeded for one use."""
        import torch

        gen = torch.Generator(device=self.device)
        gen.manual_seed(sub_seed(self.seed, name))
        return gen

    def fit(self):
        from vectorizedbayesiannetwork_torch import VBN, defaults

        net = self.net
        vbn = VBN({n: list(net.parents[n]) for n in net.nodes},
                  seed=self.seed, device=self.device)
        params = self.config["cpd"]["params"]
        conf = {}
        for n in net.nodes:
            c = dict(defaults.cpd(self.family), **params)
            if self.config["cpd"].get("cards_from_network"):
                c.update(net.cpd_params(n))
            conf[n] = c
        vbn.set_learning_method("node_wise", nodes_cpds=conf)
        vbn.fit({k: np.asarray(v, np.float32).reshape(-1, 1)
                 for k, v in self.data.items()})
        method = self.config["method"]
        vbn.set_inference_method(method["name"],
                                 **dict(method["params"], n_samples=self.s))
        return vbn

    def server(self, vbn) -> Callable:
        entry = getattr(vbn, self.config["entry"])

        def serve(call):
            rows, _spans = entry(call.queries, **call.kwargs)
            return rows

        return serve

    def work_net(self):
        """What ``work/<family>.py`` counts from."""
        if hasattr(self.work, "network"):
            return self.work.network(self)
        return self.net

    def observe(self, vbn):
        """What of the program's fitted state the family's check judges."""
        if hasattr(self.reference, "observe"):
            return self.reference.observe(self, vbn)
        return None


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", overrides: Optional[Dict] = None,
             control: bool = False, bench: Optional[Dict] = None,
             wrap_serve: Optional[Callable] = None,
             root: Path = registry.HERE) -> Dict:
    """One run; returns the result record (``line`` is the JSON object
    printed last). ``overrides`` (tests and calibration) may set
    ``n_samples``, ``rows_per_call`` and ``sample_rows``; ``wrap_serve``
    wraps the timed call (the fault tests break the served rows there);
    ``root`` is the benchmark's folder, where its pieces are found."""
    import torch

    stages = {"imports": time.perf_counter() - T0}
    bench = bench or registry.load_benchmark()
    cuda = device == "cuda"
    if cuda:
        torch.set_num_threads(min(4, os.cpu_count() or 1))
        # the port's kernel cache, at a fixed path inside the checkout
        os.environ["VBN_COMPILATION_CACHE"] = str(
            registry.CHECKOUT / "build" / "kernels")
        from vectorizedbayesiannetwork_torch.ops import _build

        _build.build_all()
        torch.empty(1, device=device)  # the CUDA context
    stages["kernels"] = time.perf_counter() - T0
    cell = Cell(bench, workload, seed, device, overrides, root)
    stages["data_and_pool"] = time.perf_counter() - T0
    vbn = cell.fit()
    stages["fit"] = time.perf_counter() - T0
    serve = cell.server(vbn)
    if wrap_serve is not None:
        serve = wrap_serve(serve)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    for call in cell.calls:  # warm-up: every call of the pool, once
        serve(call)
    sync()
    peak_setup = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T0
    stages["warm_up"] = setup_s
    served: List = []
    lat: List[float] = []
    ctx: Dict = {}
    start = time.perf_counter()
    last = [start]
    if trace:
        from torch.profiler import record_function

        from .trace import VBN, reduce_trace, traced_calls

        def one(i):
            call = cell.calls[i % len(cell.calls)]
            t0 = time.perf_counter()
            with record_function(VBN):
                rows = serve(call)
            last[0] = time.perf_counter()
            lat.append(last[0] - t0)
            served.append((i % len(cell.calls), rows))

        prof = traced_calls(N_TRACED, one)
        ctx = reduce_trace(prof)
        wnet = cell.work_net()
        ctx["least_ms"] = [
            least_ms(cell.work.count(wnet, cell.calls[i % len(cell.calls)],
                                     cell.s))
            for i in range(len(ctx["calls"]))]
    i = len(served)
    while True:
        t0 = time.perf_counter()
        if t0 - start >= seconds:
            break
        call = cell.calls[i % len(cell.calls)]
        rows = serve(call)
        last[0] = time.perf_counter()
        lat.append(last[0] - t0)
        served.append((i % len(cell.calls), rows))
        i += 1
    window_s = last[0] - start
    peak_window = torch.cuda.max_memory_allocated() if cuda else 0
    ctx["peak_bytes"] = peak_window
    observed = cell.observe(vbn)
    # rows answered in the window, and the sample the check judges
    flat = []
    failed = 0
    attempted = 0
    for c, rows in served:
        want = len(cell.calls[c].rows)
        attempted += want
        got = 0 if rows is None else min(len(rows), want)
        ok = np.isfinite(rows[:got]).all(axis=1) if got else np.zeros(0, bool)
        failed += want - int(ok.sum())
        for r in range(want):
            flat.append((c, r, rows[r] if r < got else None))
    idx = check.sample_rows(len(flat), cell.sample_rows, sub_seed(seed, "sample"))
    sampled = []
    for j in idx:
        c, r, got = flat[j]
        t, ev = cell.calls[c].rows[r]
        sampled.append((None if got is None else np.asarray(got, np.float64), t, ev))
    del vbn, serve, served, flat
    if cuda:
        torch.cuda.empty_cache()
    found = forbidden_modules()
    t_check = time.perf_counter()
    judged = cell.reference.judge(cell, sampled, observed, device,
                                  control=control)
    judged["check_s"] = time.perf_counter() - t_check
    numbers = judged["numbers"]
    limits = {k: v for k, v in cell.limits.items() if k in numbers}
    correct = check.verdict(numbers, limits)
    device_rec = {"platform": "gpu" if cuda else "cpu",
                  "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                  "count": 1,
                  "memory_peak_bytes": int(max(peak_setup, peak_window))}
    answered = attempted - failed
    if trace:
        metrics = {}
        for m in bench["per_layer"]:
            v = registry.metric_reader(m["name"], root).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        device_rec["busy_s"] = ctx["busy_us"] / 1e6
        device_rec["window_s"] = ctx["window_us"] / 1e6
    else:
        e2e = {"queries_per_s": answered / window_s,
               "batch_ms_p95": 1e3 * float(np.percentile(lat, 95)),
               "setup_s": setup_s}
        metrics = {m["name"]: {"value": float(e2e[m["name"]]), "unit": m["unit"]}
                   for m in bench["end_to_end"]}
    line = {"correct": bool(correct), "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device_rec}
    if trace:
        line["breakdown"] = {"device_ops": [[k[:120], v] for k, v in ctx["device_ops"]],
                             "idle_gaps": [[k, v] for k, v in ctx["idle_gaps"]]}
    line["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return {"line": line, "forbidden": found, "judged": judged,
            "calls": len(lat), "window_s": window_s, "setup_s": setup_s,
            "setup_stages": stages, "trace": ctx if trace else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    bench = registry.load_benchmark()
    chips = int(registry.cell(bench, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"vbnbench: needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    res = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   bench=bench)
    line = res["line"]
    if res["forbidden"]:
        print(f"vbnbench: loaded after the window: {', '.join(res['forbidden'])}",
              file=sys.stderr)
        return 5
    print(json.dumps({"calls": res["calls"], "window_s": res["window_s"],
                      "setup_stages": res["setup_stages"],
                      "power_limit": power_limit(),
                      "judged": res["judged"]}), file=sys.stderr)
    for k, v in line["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
