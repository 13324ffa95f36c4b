"""The [B, C] chains of the MCMC samplers: their draws and their mesh block.

Every random value of a chain step is a function of the call's key, the
global chain, the global row and a counter word for the step and what is
drawn, and of nothing else: a ``RowStream`` with the chain as its particle
index (``stream``), the word ``core/rng.py::chain_word(step, width, i)``.
So row 0 of a batch draws what a batch of one draws (the JAX package's
contract, ``tests/test_invariants.py``), and a rank of a mesh that runs
chains ``[c0, c0 + C_l)`` of rows ``[r0, r0 + B_l)`` draws exactly their
unmeshed values. On the card the values are ``vbn_uniforms`` launches.

Under a ('data', 'particle') mesh, rows split over 'data' and chains over
'particle', as ``ops/sweep.py::shard_trace`` splits particles. A batch
that does not split (B % n_data or C % n_particle) runs whole on every
rank. The cross-chain quantities (the step-size adaptation's mean accept
statistic, NUTS's "any chain still going") are taken over the whole
batch: ``whole`` gathers a per-chain vector in the unmeshed order, so its
reductions are the unmeshed ones bit for bit, and ``any`` is a MAX over the
mesh, so every rank takes the same loop trips and issues the same
collectives.
"""

from __future__ import annotations

import torch

from ..core.rng import Draw, RowStream
from ..ops.sweep import shard_refusal
from ..parallel.mesh import (
    DATA_AXIS,
    PARTICLE_AXIS,
    all_reduce,
    block,
    gather_blocks,
    mesh_coords,
    mesh_shape,
)
from ..utils.profiling import counter

# meshed sampler calls by how they ran
CHAINS = counter("CHAINS", ("sharded", "whole"))


class ChainBlock:
    """This rank's block of B rows of C chains: all of them with no mesh
    or a batch the gates refuse, else rows ``[row0, row0 + b)`` and chains
    ``[chain0, chain0 + c)``."""

    def __init__(self, mesh, b: int, c: int):
        self.n_rows, self.n_chains = int(b), int(c)
        self.mesh = mesh if mesh is not None and \
            shard_refusal(mesh, b, c) is None else None
        if mesh is not None:
            CHAINS["sharded" if self.mesh is not None else "whole"] += 1
        (nd, npart), (di, pi) = mesh_shape(self.mesh), mesh_coords(self.mesh)
        self.b, self.c = b // nd, c // npart
        self.row0, self.chain0 = di * self.b, pi * self.c
        self._di, self._nd = di, nd

    @property
    def m(self) -> int:
        return self.b * self.c

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This block's rows of a [B, ...] tensor."""
        return block(x, self._nd, self._di).contiguous()

    def stream(self, draw: Draw, per_chain: int = 1) -> RowStream:
        """The block's stream of ``draw``: [b * c * per_chain, k] values in
        (row, chain, j) order, element (r, c, j) at particle
        ``c * per_chain + j`` of row r (Gibbs's K candidates a chain)."""
        k = int(per_chain)
        return RowStream(draw, self.b, self.c * k, row0=self.row0,
                         particle0=self.chain0 * k,
                         n_particles=self.n_chains * k, n_rows=self.n_rows)

    def gather(self, t: torch.Tensor, dims=(0, 1)) -> torch.Tensor:
        """The global tensor of a block along (rows, chains) ``dims``."""
        return t if self.mesh is None else gather_blocks(t, self.mesh, dims)

    def whole(self, v: torch.Tensor) -> torch.Tensor:
        """A per-chain [b * c] vector -> the batch's [B * C], in the
        unmeshed (row, chain) order."""
        if self.mesh is None:
            return v
        return self.gather(v.reshape(self.b, self.c)).reshape(-1)

    def any(self, flags: torch.Tensor) -> bool:
        """Whether any chain of the batch has its flag set: one device read,
        a MAX over the mesh first when sharded."""
        hit = flags.any().to(torch.int32)
        if self.mesh is not None:
            import torch.distributed as dist

            for axis in (DATA_AXIS, PARTICLE_AXIS):
                hit = all_reduce(hit, self.mesh, axis, dist.ReduceOp.MAX)
        return bool(hit)
