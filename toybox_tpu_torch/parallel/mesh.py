"""Process groups and the data-parallel layout (port of
toybox_tpu.parallel.mesh, the replacement of the reference's MPI layer):

- ``MpiAdamOptimizer``'s gradient Allreduce -> ``all_reduce`` of the
  flattened gradients inside each sharded learner (rl/ppo.py, rl/acktr.py)
- ``mpi_util.sync_from_root`` broadcast     -> ``replicate``
- ``mpi_moments``                           -> ``mesh_moments``
- ``mpi_fork`` rank spawning                -> ``initialize_distributed``
  (``torch.distributed.init_process_group``; ``torchrun`` or any launcher
  that gives each process its rank)
- per-rank seed offsets (cmd_util.py:32)    -> ``process_seed_offset``

The JAX package runs one program over a mesh of devices and lets XLA
place the collectives. Here every rank of a process group runs its own
copy of the program on its share of the env axis, and the learners call
the collectives themselves on plain tensors (no DTensor). A ``Mesh`` is
the group with JAX's axis names; without a process group it is one rank
with no group, and every collective is the identity.

The learners take one path whether they run on a mesh or not: without
one they run on ``SINGLE`` (``mesh=None`` means it everywhere here), a
mesh of one rank whose collectives return their input, and whose
``Block`` of any axis is the whole axis.

Backends: NCCL for CUDA tensors, gloo for CPU tensors
(``backend_for``). NCCL refuses two ranks on one GPU, so two ranks that
share a card (the one-card machine) use gloo, whose CUDA support covers
``broadcast`` and ``all_reduce`` only. So this layer uses nothing else:
its gather (``all_gather_rows``) is an all-reduce of a zero buffer in
which each rank wrote its own rows, on whichever device the tensors lie.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["Mesh", "SINGLE", "Sharding", "Block", "make_mesh", "env_sharding",
           "replicated", "shard_batch", "replicate", "process_seed_offset",
           "mesh_moments", "initialize_distributed", "backend_for",
           "all_reduce", "all_reduce_tensors", "all_gather_rows",
           "env_block", "tree_map"]

#: how long a collective waits for a lost peer before it fails
DEFAULT_TIMEOUT = datetime.timedelta(seconds=120)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Ranks of one process group laid out on named axes. ``shape`` maps
    each axis name to its size (JAX's ``Mesh.shape``); ``rank`` is this
    process's index in the mesh; ``group`` is None for a single process
    without a process group (every collective is then the identity)."""
    axis_names: tuple
    shape: dict
    ranks: tuple
    group: object = None

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def rank(self) -> int:
        if self.group is None:
            return 0
        return self.ranks.index(dist.get_rank())

    @property
    def root(self) -> int:
        """The global rank of the mesh's first member (the broadcast's
        source)."""
        return self.ranks[0]


#: one process without a process group: every collective is the identity
SINGLE = Mesh(("env",), {"env": 1}, (0,))


def _group(mesh: Optional[Mesh]):
    """The mesh's process group; None for one process (``mesh`` None or
    ``SINGLE``)."""
    return None if mesh is None else mesh.group


class Sharding(NamedTuple):
    """Which axis of a tensor is split over the mesh: ``spec`` ("env",)
    splits the leading axis, () keeps the tensor whole on every rank."""
    mesh: Mesh
    spec: tuple


def make_mesh(axis_names: Sequence[str] = ("env",),
              shape: Optional[Sequence[int]] = None,
              devices=None) -> Mesh:
    """A mesh over the ranks of the default process group (``devices``: a
    subset of its ranks), all on one ``env`` (data-parallel) axis by
    default; one rank with no group when no process group is
    initialised."""
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        ranks = tuple(range(world)) if devices is None else tuple(devices)
        group = (dist.group.WORLD if len(ranks) == world
                 else dist.new_group(list(ranks)))
    else:
        ranks = tuple(devices) if devices is not None else (0,)
        if len(ranks) != 1:
            raise ValueError(f"{len(ranks)} ranks need a process group "
                             "(initialize_distributed)")
        group = None
    if shape is None:
        shape = (len(ranks),) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names) or math.prod(shape) != len(ranks):
        raise ValueError(f"mesh shape {shape} over axes {tuple(axis_names)} "
                         f"does not hold {len(ranks)} ranks")
    return Mesh(tuple(axis_names), dict(zip(axis_names, shape)), ranks,
                group)


def env_sharding(mesh: Mesh, axis: str = "env") -> Sharding:
    """The leading (per-env) axis split over ``axis``."""
    return Sharding(mesh, (axis,))


def replicated(mesh: Mesh) -> Sharding:
    """Whole on every rank."""
    return Sharding(mesh, ())


def tree_map(fn, tree):
    """``fn`` on every tensor of a tree of dicts, lists, tuples, named
    tuples and dataclasses; other leaves pass through."""
    if torch.is_tensor(tree):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def shard_batch(tree, mesh: Mesh, axis: str = "env"):
    """This rank's block of the leading axis of every tensor in ``tree``
    (each leading axis must split evenly over the mesh)."""
    if axis not in mesh.shape:
        raise ValueError(f"no axis {axis!r} in the mesh {mesh.axis_names}")

    def take(x):
        if x.dim() == 0:
            return x
        n = x.shape[0]
        if n % mesh.size:
            raise ValueError(f"a leading axis of {n} does not split over "
                             f"{mesh.size} ranks")
        k = n // mesh.size
        return x[mesh.rank * k:(mesh.rank + 1) * k]

    return tree_map(take, tree)


def replicate(tree, mesh: Optional[Mesh]):
    """Broadcast every tensor of ``tree`` from the mesh's first rank, in
    place (the reference's ``sync_from_root``); returns ``tree``."""
    if _group(mesh) is not None:
        def bcast(x):
            dist.broadcast(x.data, src=mesh.root, group=mesh.group)
            return x
        tree_map(bcast, tree)
    return tree


def process_seed_offset(base_seed: int, envs_per_process: int) -> int:
    """Disjoint per-process seed ranges: ``base + rank * envs_per_process``
    (replaces the reference's seed + 10000 * mpi_rank scheme)."""
    rank = dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0
    return base_seed + rank * envs_per_process


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(x: torch.Tensor, mesh: Optional[Mesh],
               op: str = "sum") -> torch.Tensor:
    """``x`` reduced over the mesh (a new tensor; bool as uint8 and
    back); ``x`` itself for one process."""
    if _group(mesh) is None:
        return x
    out = x.to(torch.uint8) if x.dtype == torch.bool else x.clone()
    dist.all_reduce(out, op=_OPS[op], group=mesh.group)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def all_reduce_tensors(tensors: list, mesh: Optional[Mesh]) -> list:
    """Each tensor of a list summed over the mesh, by one all-reduce of
    their flattened concatenation (f32 tensors)."""
    if _group(mesh) is None:
        return list(tensors)
    flat = all_reduce(torch.cat([t.reshape(-1) for t in tensors]), mesh)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    return out


def all_gather_rows(x: torch.Tensor, mesh: Optional[Mesh],
                    dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` joined in rank order along ``dim`` (size n on
    each rank, size * n after): each rank writes its block into a zero
    buffer, then one all-reduce sums the buffers (gloo's CUDA tensors
    take no all_gather)."""
    if _group(mesh) is None:
        return x
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = mesh.size * n
    buf = torch.zeros(shape,
                      dtype=torch.uint8 if x.dtype == torch.bool else x.dtype,
                      device=x.device)
    buf.narrow(dim, mesh.rank * n, n).copy_(x)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    return buf.to(torch.bool) if x.dtype == torch.bool else buf


def mesh_moments(x: torch.Tensor, mesh: Optional[Mesh]):
    """(mean, population std, count) of ``x`` over every rank's elements,
    in JAX's order: the count and the sum all-reduced, then the centred
    sum of squares (the reference's ``mpi_moments``)."""
    n = all_reduce(torch.full((), float(x.numel()), dtype=torch.float32,
                              device=x.device), mesh)
    mean = all_reduce(x.sum(), mesh) / n
    var = all_reduce(torch.square(x - mean).sum(), mesh) / n
    return mean, torch.sqrt(var), n


@dataclasses.dataclass(frozen=True)
class Block:
    """This rank's contiguous block ``[lo, lo + n_local)`` of an axis of
    ``n_global`` entries split evenly over the mesh (the env axis, or a
    replay ring's slots)."""
    mesh: Mesh
    lo: int
    n_local: int
    n_global: int

    def take(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This block's part of a tensor whose axis ``dim`` is global (a
        draw made alike on every rank)."""
        return x.narrow(dim, self.lo, self.n_local)

    def runs(self, start: int, n: int) -> list:
        """Where the ``n`` global indices start, start + 1, ... (modulo
        ``n_global``, a ring's cursor onwards) fall in this block: a list
        of host-int runs (j0, j1, l0), entries j0..j1 of the sequence at
        the block's offsets l0 onwards, so that a write takes slices and
        no index tensor."""
        out, j = [], 0
        while j < n:
            g = (start + j) % self.n_global
            seg = min(n - j, self.n_global - g)     # up to the axis's end
            a, b = max(g, self.lo), min(g + seg, self.lo + self.n_local)
            if a < b:
                out.append((j + a - g, j + b - g, a - self.lo))
            j += seg
        return out

    def scatter(self, dst: torch.Tensor, g: torch.Tensor,
                values: torch.Tensor) -> None:
        """``dst[g - lo] = values`` in place, for the global indices ``g``
        that fall in the block; the others are written to a spare slot
        past the block's end and dropped, so that no mask is read on the
        host."""
        own = (g >= self.lo) & (g < self.lo + self.n_local)
        buf = torch.cat([dst, dst.new_zeros((1,) + tuple(dst.shape[1:]))])
        buf[torch.where(own, g - self.lo, self.n_local)] = values
        dst.copy_(buf[:-1])


def env_block(mesh: Optional[Mesh], n_local: int) -> Block:
    """The block of ``n_local`` entries this rank holds of an axis split
    evenly over the mesh, ``n_local * size`` in all (the env axis, or a
    replay ring's slots); for one process (``mesh`` None), the whole
    axis."""
    mesh = SINGLE if mesh is None else mesh
    return Block(mesh, mesh.rank * n_local, n_local, n_local * mesh.size)


def backend_for(device) -> str:
    """NCCL for CUDA, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, backend: str | None = None,
                           timeout: datetime.timedelta = DEFAULT_TIMEOUT):
    """Join the process group (replaces mpi_fork / MPI.COMM_WORLD
    discovery). A no-op at one process or fewer. ``coordinator_address``
    is ``host:port`` (a TCP rendezvous, rank 0 listening) or a
    ``file://`` / ``tcp://`` URL; without it the launcher's environment
    (``torchrun``'s MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE) is
    read, and so are ``num_processes`` and ``process_id`` when not given.
    ``backend`` defaults to NCCL when CUDA is available, else gloo. A
    collective that waits longer than ``timeout`` for a lost peer
    fails."""
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1:
        return
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            timeout=timeout)
