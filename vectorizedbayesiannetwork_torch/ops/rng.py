"""The row stream's values on a hand-written CUDA kernel.

``vbn_uniforms`` (``csrc/rng.cu``) writes the [G, B*S, k] float32 uniforms
or normals of the row stream (``core/rng.py::RowStream``) for a list of
G <= 64 nodes in one launch: Philox-4x32-10 keyed by the call's seed,
counter (particle0 + p, row0 + r, node, 4 | (j << 3)), the same Philox as
every in-kernel stream (``csrc/vbn_common.cuh``). No TPU kernel stands
behind it (the JAX package draws in XLA by threefry); it replaces the
torch-op draws of the port's sweeps, so a row's draws do not depend on its
batch or its mesh block.

``stream_values_many`` launches the kernel when asked for a CUDA device,
once for each 64 nodes of the list, and raises when a launch fails (a card
never falls back to ``torch.rand`` or to the int64 torch-op Philox); for
the CPU it runs the plain version, ``core/rng.py::stream_values_many``.
Uniforms agree with the plain version bit for bit; normals within an ulp
or two of the logarithm and cosine. ``stream_values`` is the one-node
case. ``LAUNCHES["uniforms"]`` (``ops/_launch.py``) counts the launches.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..core.rng import NODES_PER_LAUNCH as MAX_NODES
from ..core.rng import WORD_LIMIT
from ..core.rng import stream_values_many as stream_values_many_plain
from ..utils.profiling import annotate
from ._launch import launch


def stream_values_many(seed: int, b: int, s: int, nodes: Sequence[int],
                       k: int, *, at: int = 0, normal: bool = False,
                       row0: int = 0, particle0: int = 0,
                       device="cpu") -> torch.Tensor:
    """The row-stream values [G, B*S, k] float32 of the G ``nodes``, node
    after node (see ``core/rng.py::stream_values_many``):
    ``vbn_uniforms`` on a CUDA device, the plain version on the CPU."""
    device = torch.device(device)
    nodes = [int(n) for n in nodes]
    if device.type != "cuda":
        return stream_values_many_plain(seed, b, s, nodes, k, at=at,
                                        normal=normal, row0=row0,
                                        particle0=particle0, device=device)
    if normal and at % 2:
        raise ValueError(f"normal draws start at an even slot, not {at}")
    if not nodes:
        raise ValueError("vbn_uniforms: no nodes")
    for name, v, top in (("row0", row0, 1 << 31),
                         ("particle0", particle0, 1 << 31),
                         *(("node", n, WORD_LIMIT) for n in nodes)):
        if not 0 <= int(v) < top:
            raise ValueError(f"vbn_uniforms: {name}={v} out of range")
    out = torch.empty((len(nodes), b * s, k), dtype=torch.float32,
                      device=device)
    with annotate("vbn.kernel.uniforms"):
        for i in range(0, len(nodes), MAX_NODES):
            part = nodes[i : i + MAX_NODES]
            ids = (ctypes.c_uint * len(part))(*part)  # the kernel's uint32 words
            launch("rng", "vbn_uniforms", int(seed) & ((1 << 64) - 1), int(b),
                   int(s), ids, len(part), int(k), int(at), int(bool(normal)),
                   int(row0), int(particle0), out[i].data_ptr(),
                   device=device, key="uniforms")
    return out


def stream_values(seed: int, b: int, s: int, node: int, k: int, *,
                  at: int = 0, normal: bool = False, row0: int = 0,
                  particle0: int = 0, device="cpu") -> torch.Tensor:
    """One node's row-stream values [B*S, k] float32: the one-node case of
    ``stream_values_many``."""
    return stream_values_many(seed, b, s, [node], k, at=at, normal=normal,
                              row0=row0, particle0=particle0,
                              device=device)[0]
