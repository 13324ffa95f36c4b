"""Deterministic random streams: a seed/counter stream and Philox-4x32-10.

Counterpart of ``vectorizedbayesiannetwork_tpu/core/rng.py``. ``KeyStream``
turns one seed into a stream whose n-th draw depends only on (seed, n).
Each draw carries a ``torch.Generator`` for plain tensor ops and a 64-bit
seed for the sweep kernels, which generate their own uniforms with
Philox-4x32-10 (``philox_uniforms`` is the same generator in int64 torch
ops, so a plain version can reproduce a kernel's draws bit for bit).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

_MASK64 = (1 << 64) - 1
_MASK32 = 0xFFFFFFFF
_PHILOX_M0 = 0xD2511F53
_PHILOX_M1 = 0xCD9E8D57
_PHILOX_W0 = 0x9E3779B9
_PHILOX_W1 = 0xBB67AE85


def mix64(*words: int) -> int:
    """splitmix64 chained over ``words``: a 64-bit seed from integers."""
    z = 0x9E3779B97F4A7C15
    for w in words:
        z = (z ^ (int(w) & _MASK64)) & _MASK64
        z = (z + 0x9E3779B97F4A7C15) & _MASK64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        z = z ^ (z >> 31)
    return z


@dataclass
class Draw:
    """One draw of the stream: a 64-bit kernel seed and, made on first use,
    a ``torch.Generator`` seeded with it for plain tensor ops."""

    seed: int  # 64-bit, unsigned
    device: torch.device
    _gen: Optional[torch.Generator] = None

    @property
    def generator(self) -> torch.Generator:
        if self._gen is None:
            self._gen = torch.Generator(device=self.device)
            self._gen.manual_seed(self.seed)
        return self._gen


class KeyStream:
    """Host-side counter turning one seed into a deterministic stream."""

    def __init__(self, seed: int, device: torch.device) -> None:
        self.seed = int(seed)
        self.device = device
        self._counter = 0

    def next(self) -> Draw:
        s = mix64(self.seed, self._counter)
        self._counter += 1
        return Draw(s, self.device)

    def state(self) -> int:
        return self._counter

    def set_state(self, counter: int) -> None:
        self._counter = int(counter)


def _mulhilo(a: int, x: torch.Tensor):
    """(hi, lo) 32-bit halves of a*x for a constant a < 2^32, x in int64
    holding values < 2^32, without overflowing int64."""
    p0 = x * (a & 0xFFFF)
    p1 = x * (a >> 16)
    t = p0 + ((p1 & 0xFFFF) << 16)
    return (p1 >> 16) + (t >> 32), t & _MASK32


def philox4x32_10(c0, c1, c2, c3, seed: int):
    """Philox-4x32-10 (Salmon et al., SC'11) on int64 tensors of 32-bit
    words; key = the 64-bit ``seed``. Returns the four output words."""
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    for r in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        if r < 9:
            k0 = (k0 + _PHILOX_W0) & _MASK32
            k1 = (k1 + _PHILOX_W1) & _MASK32
    return c0, c1, c2, c3


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """24 high bits -> float32 in (0, 1]: ((bits >> 8) + 0.5) * 2^-24."""
    return ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def philox_uniforms(
    seed: int, b: int, n_nodes: int, s: int, words: int, device,
    row0: int = 0, node0: int = 0,
) -> torch.Tensor:
    """The sweep kernels' in-kernel uniforms as a [B, words*N, S] tensor.

    Counter = (particle, row, node, 0), key = ``seed``, for query rows
    ``row0 .. row0 + B - 1`` and nodes ``node0 .. node0 + N - 1``. Row
    ``words*i + w`` holds output word ``w`` of node ``node0 + i``: one word
    per node for the categorical sweeps, the Box-Muller pair (words 0 and
    1) for the LG ones. This is the external-uniform layout the kernels
    take, so feeding the result back reproduces the in-kernel random mode
    (``row0`` and ``node0`` let a caller rebuild a large batch's draws a
    slice of rows or nodes at a time).
    """
    i64 = dict(dtype=torch.int64, device=device)
    c0 = torch.arange(s, **i64).view(1, 1, s)
    c1 = torch.arange(row0, row0 + b, **i64).view(b, 1, 1)
    c2 = torch.arange(node0, node0 + n_nodes, **i64).view(1, n_nodes, 1)
    c0, c1, c2 = torch.broadcast_tensors(c0, c1, c2)
    out = philox4x32_10(c0, c1, c2, torch.zeros_like(c0), int(seed))
    u = torch.stack([uniform_from_bits(w) for w in out[:words]], dim=2)
    return u.reshape(b, n_nodes * words, s)
