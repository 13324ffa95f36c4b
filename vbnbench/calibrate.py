"""The readings the check's limits are set from, for one cell.

    python3 -m vbnbench.calibrate --workload <cell> --seeds 11,12,... \\
        --control-seeds 11,12,13 --seconds 5 [--out vbnbench/out/x.jsonl]

In one process, for each seed: a run of the cell at its own sizes and
load with a short window, judged as a run judges it (the program's
readings); for each control seed also the control, plain likelihood
weighting at ``n_samples / n_samples_divisor`` particles put in the
program's place on the same sampled rows. Prints a JSON line a seed and
then the summary: each number's lower reading (the largest over the
program's seeds) and upper reading (the smallest over the control's).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("vbnbench.calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    lower, upper = {}, {}
    lines = []
    for seed in seeds:
        t0 = time.perf_counter()
        res = run.run_cell(args.workload, seed, args.seconds, False,
                           control=seed in ctl)
        j = res["judged"]
        rec = {"seed": seed, "program": j["numbers"], "control": j.get("control"),
               "reference_min_ess": j.get("reference_min_ess"),
               "calls": res["calls"],
               "queries_per_s": res["line"]["metrics"]["queries_per_s"]["value"],
               "seconds": time.perf_counter() - t0}
        for k, v in j["numbers"].items():
            lower[k] = max(lower.get(k, v), v)
        for k, v in (j.get("control") or {}).items():
            upper[k] = min(upper.get(k, v), v)
        lines.append(rec)
        print(json.dumps(rec), flush=True)
    summary = {"workload": args.workload, "lower": lower, "upper": upper,
               "seeds": seeds, "control_seeds": sorted(ctl)}
    lines.append(summary)
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(json.dumps(x) for x in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
