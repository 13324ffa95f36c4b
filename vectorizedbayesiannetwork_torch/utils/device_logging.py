"""Device banner logging.

Counterpart of ``vectorizedbayesiannetwork_tpu/utils/device_logging.py``:
a once-per-process device banner, guarded by ``VBN_LOGGED_DEVICE`` so
repeated constructions stay quiet.
"""

from __future__ import annotations

import os

import torch


def get_device_string() -> str:
    """``cuda [Nx <name>, ...]`` from ``torch.cuda.get_device_name``, or
    ``cpu`` without a card."""
    if not torch.cuda.is_available():
        return "cpu"
    kinds = {}
    for i in range(torch.cuda.device_count()):
        name = torch.cuda.get_device_name(i)
        kinds[name] = kinds.get(name, 0) + 1
    desc = ", ".join(f"{n}x {k}" for k, n in kinds.items())
    return f"cuda [{desc}]"


def log_device(force: bool = False) -> None:
    guard = "VBN_LOGGED_DEVICE"
    if not force and os.environ.get(guard):
        return
    os.environ[guard] = "1"
    print(f"[vbn-torch] devices: {get_device_string()}")
