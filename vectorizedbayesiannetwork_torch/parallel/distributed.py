"""Process-group start-up and scaling-efficiency measurement.

Port of ``vectorizedbayesiannetwork_tpu/parallel/distributed.py``:

- ``initialize_distributed()`` wraps ``torch.distributed.init_process_group``:
  call it once in every process before ``make_mesh``. Under ``torchrun``
  it reads ``RANK`` / ``WORLD_SIZE`` from the environment; a process that
  spawns its own ranks passes ``init_method``, ``world_size`` and ``rank``;
  a plain script with neither gets a one-rank group.
- ``scaling_efficiency()`` measures throughput on two meshes for one
  closure, the harness of the ">90% 2-host scaling efficiency" target.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist


def initialize_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: float = 300.0,
) -> None:
    """Start the default process group (a no-op when one is up).

    ``backend`` is "nccl" when a CUDA device is present, else "gloo". With
    no arguments and no ``RANK`` / ``WORLD_SIZE`` in the environment, a
    one-rank group on an in-process store starts, so ``make_mesh()`` works
    in a plain script. A collective that waits past ``timeout_s`` fails."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    env = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"]) if env else 1
    if rank is None:
        rank = int(os.environ["RANK"]) if env else 0
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    kw = dict(backend=backend, world_size=world_size, rank=rank,
              timeout=datetime.timedelta(seconds=timeout_s))
    if init_method is None and not env:
        if world_size != 1:
            raise ValueError("a group of more than one rank needs "
                             "init_method, or RANK and WORLD_SIZE set")
        kw["store"] = dist.HashStore()
    else:
        kw["init_method"] = init_method or "env://"
    dist.init_process_group(**kw)


def scaling_efficiency(
    run_fn: Callable[[object], float], mesh_small, mesh_large,
) -> Dict[str, float]:
    """Throughput of ``run_fn`` on two meshes -> an efficiency report.

    ``run_fn(mesh) -> items_per_second`` builds and runs the workload on
    the mesh, its warm-up included."""
    small = run_fn(mesh_small)
    large = run_fn(mesh_large)
    n_small = mesh_small.size()
    n_large = mesh_large.size()
    ideal = small * (n_large / n_small)
    return {
        "throughput_small": small,
        "throughput_large": large,
        "devices_small": n_small,
        "devices_large": n_large,
        "speedup": large / small,
        "efficiency": large / ideal,
    }


def measure_queries_per_s(vbn, query, n_samples: int, reps: int = 5) -> float:
    """Warm up, then posterior queries/s over ``reps`` calls."""
    from ..core.utils import infer_batch_size

    def sync():
        if vbn.device.type == "cuda":
            torch.cuda.synchronize(vbn.device)

    b = infer_batch_size(query.get("evidence", {}), query.get("do", {}))
    vbn.infer_posterior(query, n_samples=n_samples)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        vbn.infer_posterior(query, n_samples=n_samples)
    sync()
    return b * reps / (time.perf_counter() - t0)
