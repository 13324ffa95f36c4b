"""The ('data', 'particle') device mesh over ``torch.distributed``.

Port of ``vectorizedbayesiannetwork_tpu/parallel/mesh.py``. The JAX package
runs one program over a mesh through ``shard_map``; the port runs SPMD: one
process per device, each holding the whole model and its own block of the
work, meeting at collectives. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` of shape (n_data, n_particle)
named ('data', 'particle'); rank ``di * n_particle + pi`` sits at (di, pi).

The JAX constructs map so:

- ``axis_index(ax)`` -> ``mesh_coords(mesh)``;
- ``pmax`` / ``psum`` over an axis -> ``all_reduce(t, mesh, ax, op)``;
- ``all_gather`` over an axis -> ``all_gather(t, mesh, ax)``;
- the ``ppermute`` shift-left ring -> ``ring_shift(t, mesh, ax)``;
- a global array out of ``shard_map`` -> ``gather_blocks``: every rank
  gets the whole tensor, so a meshed call returns what an unmeshed one
  returns.

``constrain_bs`` / ``constrain_bsd`` / ``constrain_rows`` keep the JAX names.
In SPMD they cannot annotate a global array; they return this rank's block
of one, under the active mesh (and the tensor itself with none).

Gloo's ``all_reduce`` and ``all_gather`` take CUDA tensors, its
point-to-point send and receive do not (on an H100 the rank raises, or
aborts writing the device pointer to its socket): under gloo the ring
stages a CUDA window through host memory. NCCL takes device tensors for
all of them.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
PARTICLE_AXIS = "particle"

_ACTIVE_MESH = None


def make_mesh(n_data: int = 1, n_particle: Optional[int] = None,
              device_type: Optional[str] = None):
    """A ('data', 'particle') mesh over the process group's ranks.

    The world size plays the part of the JAX package's device count: with
    ``n_particle`` None it must divide by ``n_data``. Unlike the JAX mesh,
    which may take the first ``n_data * n_particle`` devices, every rank of
    the group is in the mesh (a rank outside it would have no work).
    ``device_type`` is "cuda" unless "cpu" is asked for."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: call "
            "parallel.initialize_distributed() first")
    world = dist.get_world_size()
    if n_particle is None:
        if world % n_data != 0:
            raise ValueError(f"{world} devices not divisible by n_data={n_data}")
        n_particle = world // n_data
    if n_data * n_particle != world:
        raise ValueError(
            f"a ({n_data}, {n_particle}) mesh needs {n_data * n_particle} "
            f"ranks; the process group has {world}")
    device_type = "cuda" if device_type is None else str(device_type)
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device; pass device_type='cpu' "
                           "to build a mesh on the CPU")
    return init_device_mesh(device_type, (n_data, n_particle),
                            mesh_dim_names=(DATA_AXIS, PARTICLE_AXIS))


def get_active_mesh():
    return _ACTIVE_MESH


@contextlib.contextmanager
def active_mesh(mesh):
    """The mesh ``constrain_*`` cut blocks for, inside the block."""
    global _ACTIVE_MESH
    prev = _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    try:
        yield
    finally:
        _ACTIVE_MESH = prev


def mesh_signature(mesh) -> tuple:
    """(axis names, shape, ranks in mesh order); () for no mesh."""
    if mesh is None:
        return ()
    return (
        tuple(mesh.mesh_dim_names),
        tuple(mesh.mesh.shape),
        tuple(int(r) for r in mesh.mesh.flatten().tolist()),
    )


def mesh_shape(mesh) -> Tuple[int, int]:
    """(n_data, n_particle); (1, 1) for no mesh."""
    if mesh is None:
        return 1, 1
    return mesh.size(0), mesh.size(1)


def mesh_coords(mesh) -> Tuple[int, int]:
    """This rank's (data index, particle index); (0, 0) for no mesh."""
    if mesh is None:
        return 0, 0
    return mesh.get_local_rank(DATA_AXIS), mesh.get_local_rank(PARTICLE_AXIS)


def block(x: torch.Tensor, n: int, i: int, dim: int = 0) -> torch.Tensor:
    """Block ``i`` of ``n`` equal blocks of ``x`` along ``dim``."""
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"dimension {dim} of size {size} does not split "
                         f"into {n} blocks")
    step = size // n
    return x.narrow(dim, i * step, step)


def constrain_bs(x: torch.Tensor) -> torch.Tensor:
    """This rank's [B/n_data, S/n_particle] block of a [B, S] tensor."""
    mesh = _ACTIVE_MESH
    if mesh is None:
        return x
    (nd, npart), (di, pi) = mesh_shape(mesh), mesh_coords(mesh)
    return block(block(x, nd, di, 0), npart, pi, 1)


def constrain_bsd(x: torch.Tensor) -> torch.Tensor:
    """This rank's block of a [B, S, D] tensor (D whole)."""
    return constrain_bs(x)


def constrain_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's row block of an [N, D] data matrix sharded over both
    axes, block ``di * n_particle + pi``: fit-time row reductions become a
    sum over the whole mesh."""
    mesh = _ACTIVE_MESH
    if mesh is None:
        return x
    (nd, npart), (di, pi) = mesh_shape(mesh), mesh_coords(mesh)
    return block(x, nd * npart, di * npart + pi, 0)


# ---------------------------------------------------------------------------
# Collectives over one mesh axis
# ---------------------------------------------------------------------------


def all_reduce(t: torch.Tensor, mesh, axis: str, op=dist.ReduceOp.SUM):
    """``t`` reduced over ``axis`` (a new tensor; ``t`` is left as it is)."""
    out = t.clone()
    dist.all_reduce(out, op=op, group=mesh.get_group(axis))
    return out


def all_gather(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """[n, *t.shape]: every rank's ``t`` along ``axis``, in axis order."""
    group = mesh.get_group(axis)
    src = t.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.stack(parts)


def gather_blocks(t: torch.Tensor, mesh, dims=(0, 1)) -> torch.Tensor:
    """The global tensor of which ``t`` is this rank's block: blocks along
    ``dims[0]`` come from the 'data' axis and, when ``dims`` has two
    entries, along ``dims[1]`` from the 'particle' axis."""
    if len(dims) > 1:
        t = torch.cat(all_gather(t, mesh, PARTICLE_AXIS).unbind(0), dim=dims[1])
    return torch.cat(all_gather(t, mesh, DATA_AXIS).unbind(0), dim=dims[0])


def ring_shift(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The ``t`` of the next rank along ``axis`` (index i + 1 mod n): every
    rank sends its own to index i - 1, the JAX ring's shift left."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    if n == 1:
        return t
    me = dist.get_rank(group)
    ranks = dist.get_process_group_ranks(group)
    src = t.contiguous()
    if src.is_cuda and dist.get_backend(group) == "gloo":
        src = src.cpu()  # gloo sends and receives host memory only
    out = torch.empty_like(src)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, src, ranks[(me - 1) % n], group),
        dist.P2POp(dist.irecv, out, ranks[(me + 1) % n], group),
    ])
    for r in reqs:
        r.wait()
    return out.to(t.device)
