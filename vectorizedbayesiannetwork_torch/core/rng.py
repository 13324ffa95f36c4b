"""Deterministic random streams: a seed/counter stream and Philox-4x32-10.

Counterpart of ``vectorizedbayesiannetwork_tpu/core/rng.py``. ``KeyStream``
turns one seed into a stream whose n-th draw depends only on (seed, n).
Each draw carries a ``torch.Generator`` for plain tensor ops and a 64-bit
seed for the sweep kernels, which generate their own uniforms with
Philox-4x32-10 (``philox_uniforms`` is the same generator in int64 torch
ops, so a plain version can reproduce a kernel's draws bit for bit).

The torch-op sweeps draw from a ``RowStream``: Philox-4x32-10 keyed by the
call's seed with counter (particle, row, node, 4 | (j << 3)), so every
draw is a function of (key, global particle, global row, node) alone. A
row's draws then do not depend on its batch, and a rank of a mesh that
sweeps particles ``[p0, p0 + s)`` of rows ``[r0, r0 + b)`` draws exactly
the unmeshed ones. On the card the values come from the ``vbn_uniforms``
kernel (``ops/rng.py``), a list of nodes a launch; ``stream_values_many``
is its plain version. A level group of the per-node sweep makes its
nodes' draws ahead in one launch each (``RowStream.predraw``) and hands
them to the vmapped ``_sample_flat`` as a dict (``Drawn``); the stacked
forms draw a chunk of nodes ahead (``ChunkedDraws``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from ..utils.profiling import annotate

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


def fold(draw: Draw, *indices: int) -> Draw:
    """A sub-stream of ``draw`` for each integer folded in (the counterpart
    of the JAX package's ``fold(key, *indices)``)."""
    seed = draw.seed
    for idx in indices:
        seed = mix64(seed, idx)
    return Draw(seed, draw.device)


class KeyStream:
    """Host-side counter turning one seed into a deterministic stream."""

    def __init__(self, seed: int, device: torch.device) -> None:
        self.seed = int(seed)
        self.device = device
        self._counter = 0

    @property
    def root(self) -> Draw:
        """The seed's root draw: ``fold(root, n)`` is the stream's n-th."""
        return Draw(self.seed & _MASK64, self.device)

    def next(self) -> Draw:
        s = mix64(self.seed, self._counter)
        self._counter += 1
        return Draw(s, self.device)

    def next_spec(self):
        """``(root, counter)`` with ``fold(root, counter)`` the draw that
        ``next()`` would give, advancing the stream as ``next()`` does."""
        counter = self._counter
        self._counter += 1
        return self.root, counter

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
    row0: int = 0, node0: int = 0, grouped: bool = False,
) -> torch.Tensor:
    """The sweep kernels' in-kernel uniforms as a [B, words*N, S] tensor.

    Key = ``seed``, for query rows ``row0 .. row0 + B - 1`` and nodes
    ``node0 .. node0 + N - 1``. Row ``words*i + w`` holds word ``w`` of node
    ``node0 + i``: an LG node's Box-Muller pair (``words=2``), or with one
    word a node a categorical stream. This is the external-uniform layout
    the kernels take, so feeding the result back as ``u_ext`` reproduces an
    in-kernel random mode (``row0`` and ``node0`` let a caller rebuild a
    large batch's draws a slice of rows or nodes at a time).

    By default one call a node, counter (particle, row, node, 0), words 0
    and 1: a stream no kernel draws in-kernel, kept as a fixed source of
    external uniforms.

    ``grouped=True`` is the stream of the kernels that share one call
    among several nodes, its tag in the last counter word:

    - ``words=1`` (``vbn_cat_scan``, ``vbn_cat_sweep``): four nodes a call,
      counter (particle, row, node >> 2, 1), node i takes word ``i & 3``;
    - ``words=2`` (``vbn_lg_scan``): two nodes a call, counter (particle,
      row, node >> 1, 3), node i takes words ``2 (i & 1)`` and
      ``2 (i & 1) + 1`` as its Box-Muller pair.
    """
    shift, tag = {1: (2, 1), 2: (1, 3)}[words] if grouped else (0, 0)
    i64 = dict(dtype=torch.int64, device=device)
    nodes = torch.arange(node0, node0 + n_nodes, **i64)
    c0 = torch.arange(s, **i64).view(1, 1, s)
    c1 = torch.arange(row0, row0 + b, **i64).view(b, 1, 1)
    c2 = (nodes >> shift).view(1, n_nodes, 1)
    c0, c1, c2 = torch.broadcast_tensors(c0, c1, c2)
    out = philox4x32_10(c0, c1, c2, torch.full_like(c0, tag), int(seed))
    if grouped:
        first = (nodes & ((1 << shift) - 1)) * words  # the node's first word
        stacked = torch.stack(out, dim=0)
        out = [stacked.gather(0, (first + w).view(1, 1, n_nodes, 1)
                              .expand(1, b, n_nodes, s))[0]
               for w in range(words)]
    u = torch.stack([uniform_from_bits(w) for w in out[:words]], dim=2)
    return u.reshape(b, n_nodes * words, s)


STREAM_TAG = 4  # the row stream's tag: tags 0-3 are the kernels' streams
U_MAX = 1.0 - 2.0**-24  # the largest float32 below 1


def box_muller(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Standard normals from uniform pairs in (0, 1]: ``-r cos(2 pi (u2 -
    1/2))`` with ``r = sqrt(-2 log u1)``, the LG walk's formula
    (``csrc/lg_walk.cuh``; ``u2 - 1/2`` is exact, so the cosine's argument
    lies in [-pi, pi])."""
    two_pi = torch.tensor(6.283185307179586, dtype=torch.float32,
                          device=u1.device)
    r = torch.sqrt(-2.0 * torch.log(u1))
    return -(r * torch.cos(two_pi * (u2 - 0.5)))


def stream_words(seed: int, b: int, s: int, node, at: int, words: int,
                 device, row0: int = 0, particle0: int = 0) -> torch.Tensor:
    """Slots ``at .. at + words - 1`` of the row stream as int64 [B, S,
    words] holding 32-bit words: slot ``4 j + w`` is word ``w`` of the call
    with counter (particle0 + p, row0 + r, node, 4 | (j << 3)). With a
    list of nodes, [G, B, S, words]: the node counter broadcast over the
    list."""
    i64 = dict(dtype=torch.int64, device=device)
    many = isinstance(node, (list, tuple, range))
    nodes = torch.as_tensor(list(node) if many else [node], **i64)
    c0 = torch.arange(particle0, particle0 + s, **i64).view(1, 1, s)
    c1 = torch.arange(row0, row0 + b, **i64).view(1, b, 1)
    c0, c1, c2 = torch.broadcast_tensors(c0, c1, nodes.view(-1, 1, 1))
    out = []
    for j in range(at >> 2, ((at + words - 1) >> 2) + 1):
        ws = philox4x32_10(c0, c1, c2, torch.full_like(c0, STREAM_TAG | (j << 3)),
                           int(seed))
        out.extend(ws)
    first = at - ((at >> 2) << 2)
    bits = torch.stack(out[first : first + words], dim=-1)
    return bits if many else bits[0]


def stream_values_many(seed: int, b: int, s: int, nodes: Sequence[int],
                       k: int, *, at: int = 0, normal: bool = False,
                       row0: int = 0, particle0: int = 0,
                       device="cpu") -> torch.Tensor:
    """The row stream's [G, B*S, k] float32 values of the G ``nodes`` (the
    plain version of ``vbn_uniforms``). Uniforms: slot ``at + c`` by
    ``uniform_from_bits`` clamped to ``U_MAX``, so in (0, 1). Normals
    (``at`` even): column c by ``box_muller`` from slots ``at + 2c`` and
    ``at + 2c + 1``, unclamped. The node counter is broadcast over the
    list, so node g's block is its ``stream_values`` bit for bit."""
    if normal and at % 2:
        raise ValueError(f"normal draws start at an even slot, not {at}")
    words = 2 * k if normal else k
    nodes = [int(n) for n in nodes]
    bits = stream_words(seed, b, s, nodes, at, words, device, row0,
                        particle0)
    u = uniform_from_bits(bits)
    if normal:
        v = box_muller(u[..., 0::2], u[..., 1::2])
    else:
        v = torch.clamp(u, max=U_MAX)
    return v.reshape(len(nodes), b * s, k)


def stream_values(seed: int, b: int, s: int, node: int, k: int, *,
                  at: int = 0, normal: bool = False, row0: int = 0,
                  particle0: int = 0, device="cpu") -> torch.Tensor:
    """One node's [B*S, k] values: the one-node case of
    ``stream_values_many``."""
    return stream_values_many(seed, b, s, [node], k, at=at, normal=normal,
                              row0=row0, particle0=particle0,
                              device=device)[0]


class RowStream:
    """The draws of one sweep over rows ``row0 .. row0 + b - 1`` and
    particles ``particle0 .. particle0 + s - 1`` of a batch of ``n_rows``
    rows of ``n_particles`` particles (``b`` and ``s`` unless this is one
    rank's block of a mesh), keyed by ``draw``'s seed. ``uniform(node, k)``
    and ``normal(node, k)`` give [b*s, k] rows in row-major (row, particle)
    order; ``node(i)`` binds a node for a CPD's ``_sample_flat``."""

    def __init__(self, draw: Draw, b: int, s: int, row0: int = 0,
                 particle0: int = 0, n_particles: Optional[int] = None,
                 n_rows: Optional[int] = None):
        self.seed = int(draw.seed)
        self.device = torch.device(draw.device)
        self.b, self.s = int(b), int(s)
        self.row0, self.particle0 = int(row0), int(particle0)
        self.n_particles = self.s if n_particles is None else int(n_particles)
        self.n_rows = self.b if n_rows is None else int(n_rows)

    @property
    def m(self) -> int:
        return self.b * self.s

    def values(self, node: int, k: int, at: int = 0,
               normal: bool = False) -> torch.Tensor:
        return self.values_many([node], k, at, normal)[0]

    def values_many(self, nodes: Sequence[int], k: int, at: int = 0,
                    normal: bool = False) -> torch.Tensor:
        """[G, b*s, k]: the G nodes' values, one ``vbn_uniforms`` launch for
        each 64 nodes on the card, each node on its own counters (a
        ``vbn.draw`` span)."""
        from ..ops.rng import stream_values_many as launch

        with annotate("vbn.draw"):
            return launch(self.seed, self.b, self.s, [int(n) for n in nodes],
                          int(k), at=at, normal=normal, row0=self.row0,
                          particle0=self.particle0, device=self.device)

    def predraw(self, nodes: Sequence[int],
                draws: Sequence[Tuple[int, int, bool]]) -> "Drawn":
        """The draws ``(k, at, normal)`` of every node of ``nodes``, each one
        ``values_many`` launch: ``{draw_key(k, at, normal): [G, b*s, k]}``.
        Sliced at node g (or vmapped over dim 0) it is a ``Drawn`` source
        that gives node g the values ``node(nodes[g])`` would draw."""
        return {draw_key(k, at, normal): self.values_many(nodes, k, at, normal)
                for k, at, normal in draws}

    def uniform(self, node: int, k: int = 1, at: int = 0) -> torch.Tensor:
        return self.values(node, k, at)

    def normal(self, node: int, k: int = 1, at: int = 0) -> torch.Tensor:
        return self.values(node, k, at, normal=True)

    def node(self, idx: int) -> "NodeStream":
        return NodeStream(self, int(idx))


class NodeStream:
    """A ``RowStream`` with its node bound: what a CPD's ``_sample_flat``
    draws from in place of a ``torch.Generator``."""

    def __init__(self, stream: RowStream, idx: int):
        self.stream, self.idx = stream, idx

    @property
    def m(self) -> int:
        return self.stream.m

    def uniform(self, k: int = 1, at: int = 0) -> torch.Tensor:
        return self.stream.uniform(self.idx, k, at)

    def normal(self, k: int = 1, at: int = 0) -> torch.Tensor:
        return self.stream.normal(self.idx, k, at)

    @property
    def seed(self) -> int:
        """The node's own 64-bit key, ``mix64(seed, node)`` (the KDE
        pick's in-kernel stream)."""
        return mix64(self.stream.seed, self.idx)


NODES_PER_LAUNCH = 64  # nodes of one vbn_uniforms launch (csrc/rng.cu)
CHUNK_BYTES = 1 << 28  # the most a chunk of nodes drawn ahead holds


class ChunkedDraws:
    """Node i's [b*s, k] values for a loop over nodes 0 .. n - 1 in order,
    drawn ahead a chunk of C nodes at a time (one ``values_many`` call: one
    ``vbn_uniforms`` launch on the card), C at most 64 and the chunk at
    most ``CHUNK_BYTES``. The values are node i's own, bit for bit."""

    def __init__(self, stream: RowStream, n: int, k: int = 1,
                 normal: bool = False):
        self.stream, self.n, self.k = stream, int(n), int(k)
        self.normal = normal
        per_node = 4 * stream.m * self.k
        self.chunk = max(1, min(NODES_PER_LAUNCH, CHUNK_BYTES // per_node,
                                self.n))
        self.lo, self.buf = 0, None

    def __call__(self, i: int) -> torch.Tensor:
        if self.buf is None or not self.lo <= i < self.lo + self.buf.shape[0]:
            self.lo = i
            self.buf = self.stream.values_many(
                range(i, min(i + self.chunk, self.n)), self.k,
                normal=self.normal)
        return self.buf[i - self.lo]


def draw_key(k: int, at: int, normal: bool) -> str:
    """The key of a draw of ``k`` values from slot ``at`` in a ``Drawn``
    source: ``"u1@0"``, ``"n2@4"``."""
    return f"{'n' if normal else 'u'}{int(k)}@{int(at)}"


# A node's draws made ahead of its ``_sample_flat``: {draw_key: [m, k]}
# (``RowStream.predraw`` sliced at the node; a level group's sample runs
# under ``torch.func.vmap``, where no kernel can launch, so its draws are
# made before it and enter as this dict, batched over the group).
Drawn = Dict[str, torch.Tensor]
Source = Union[torch.Generator, NodeStream, Drawn]


def _check_rows(src: NodeStream, m: int) -> None:
    if src.m != m:
        raise ValueError(f"the row stream has {src.m} rows; the draw wants {m}")


def _drawn(src: Drawn, m: int, k: int, at: int, normal: bool):
    key = draw_key(k, at, normal)
    if key not in src:
        raise KeyError(f"draw {key} was not made ahead (made: {sorted(src)})")
    v = src[key]
    if tuple(v.shape) != (m, k):
        raise ValueError(f"draw {key} holds {tuple(v.shape)}, not {(m, k)}")
    return v


def uniforms(src: Source, m: int, k: int, device, at: int = 0,
             dtype=torch.float32) -> torch.Tensor:
    """[m, k] uniforms: slots ``at ..`` of a node's row stream (in (0, 1)),
    made ahead (``Drawn``) or now, or ``torch.rand`` on a generator (in
    [0, 1))."""
    if isinstance(src, dict):
        return _drawn(src, m, k, at, False).to(dtype)
    if isinstance(src, NodeStream):
        _check_rows(src, m)
        return src.uniform(k, at).to(dtype)
    return torch.rand((m, k), generator=src, device=device, dtype=dtype)


def normals(src: Source, m: int, k: int, device, at: int = 0,
            dtype=torch.float32) -> torch.Tensor:
    """[m, k] standard normals: slots ``at ..`` of a node's row stream
    (Box-Muller pairs), made ahead (``Drawn``) or now, or ``torch.randn``
    on a generator."""
    if isinstance(src, dict):
        return _drawn(src, m, k, at, True).to(dtype)
    if isinstance(src, NodeStream):
        _check_rows(src, m)
        return src.normal(k, at).to(dtype)
    return torch.randn((m, k), generator=src, device=device, dtype=dtype)


WORD_LIMIT = 1 << 32  # a Philox counter word holds 32 bits


def chain_word(step: int, width: int, i: int) -> int:
    """The node word ``step * width + i`` of a chain sampler's draw: step
    ``step`` of a sampler that draws ``width`` words a step (Gibbs: one a
    node; HMC and NUTS: one a purpose). Raises where the word would pass
    2^32 (a wrapped word would repeat an earlier step's draws)."""
    if not 0 <= i < width:
        raise ValueError(f"chain word: index {i} outside a step of {width}")
    word = int(step) * int(width) + int(i)
    if not 0 <= word < WORD_LIMIT:
        raise ValueError(
            f"chain word {word} (step {step} x {width} + {i}) passes 2^32: "
            "fewer steps or nodes a call")
    return word


def next_slot(k: int) -> int:
    """The first slot of a second draw after ``k`` slots: ``k`` rounded up
    to a whole call (4 words)."""
    return 4 * ((k + 3) // 4)
