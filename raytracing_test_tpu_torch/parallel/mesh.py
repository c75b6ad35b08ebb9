"""The device mesh as process groups, and the collectives over its axes.

Port of ``raytracing_test_tpu/parallel/mesh.py``. One process per rank, joined
by ``torch.distributed``; the mesh has the reference's two axes:

  axis "data"  -- rays, pixels and views split in contiguous blocks (the
                  reference's ``P("data")``); the voxel field gradients are
                  summed or averaged over it.
  axis "space" -- the voxel grid split along x (parallel/spatial.py,
                  parallel/handoff.py).

Rank ``d * n_space + s`` sits at (data ``d``, space ``s``): the order in which
``jax.make_mesh`` reshapes its devices (:38). ``make_mesh`` builds one group
per data column and one per space row with ``new_group`` (every rank of the
world calls it for every group, as ``torch.distributed`` requires).

Every collective of the port is a method of ``Mesh`` (``psum``, ``pmean``,
``pmax``, ``all_gather``, ``psum_scatter``, ``ppermute``) over an axis name or
a tuple of names; no other module talks to ``torch.distributed``. Boolean
tensors are cast to int32 before they travel, as the reference does
(handoff.py:141-146).

Backends: the caller names one (NCCL for CUDA tensors, gloo for CPU
tensors); nothing here switches it. Gloo carries only ``all_reduce`` and
``broadcast`` for CUDA tensors, so on a gloo group holding CUDA tensors (two
ranks sharing one card) ``all_gather`` and ``ppermute`` move their tensors
through host memory: the data moves between ranks that way, every
computation stays on the card. ``Mesh.host_copies`` counts those tensors.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

DATA_AXIS = "data"
SPACE_AXIS = "space"
Axis = Union[str, Tuple[str, ...]]


def default_backend(device) -> str:
    """The backend for a device type: NCCL for CUDA, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_multihost(addr: Optional[str] = None, rank: Optional[int] = None,
                         world_size: Optional[int] = None, backend: str = "nccl") -> None:
    """Join the process group: ``addr`` (``tcp://host:port``), ``rank`` and
    ``world_size`` as given, or from ``torchrun``'s environment (``env://``:
    MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE) where left out."""
    if rank is None:
        rank = int(os.environ["RANK"])
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    dist.init_process_group(backend, init_method=addr or "env://", rank=rank,
                            world_size=world_size)


def launched_world() -> int:
    """The world size a launcher (``torchrun``) started this process in; 1
    for a plain process."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def in_group() -> bool:
    """Whether this process has joined a process group."""
    return dist.is_initialized()


def world_size() -> int:
    """The size of this process's group; 1 for a process in none."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_rank() -> int:
    """This process's rank; 0 for a process in no group."""
    return dist.get_rank() if dist.is_initialized() else 0


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


class Mesh:
    """This rank's view of an (n_data, n_space) mesh: its coordinates, its
    device and the groups of its two axes. A rank of the world beyond the
    mesh's ``n_data * n_space`` ranks has ``coords`` None and no groups (as
    ``jax.make_mesh`` takes the first devices)."""

    def __init__(self, n_data: int, n_space: int, device: torch.device, backend: str,
                 coords: Optional[Tuple[int, int]], groups: Dict[Axis, object],
                 ranks: Dict[Axis, List[int]]):
        self.n_data, self.n_space = n_data, n_space
        self.shape = {DATA_AXIS: n_data, SPACE_AXIS: n_space}
        self.device = device
        self.backend = backend
        self.coords = coords
        self._groups = groups
        self._ranks = ranks
        self.host_copies = 0  # tensors a gloo group moved through host memory

    @property
    def size(self) -> int:
        return self.n_data * self.n_space

    @property
    def member(self) -> bool:
        return self.coords is not None

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on ``axis``."""
        return self.coords[0 if axis == DATA_AXIS else 1]

    def axis_size(self, axis: Axis) -> int:
        return len(self._ranks[_key(axis)])

    def block(self, x: torch.Tensor, axis: str = DATA_AXIS) -> torch.Tensor:
        """This rank's contiguous block of ``x``'s leading dimension (the
        reference's ``P(axis)``). Raises if the blocks would be uneven."""
        n = self.shape[axis]
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} rows do not split into {n} {axis} blocks")
        w = x.shape[0] // n
        i = self.axis_index(axis)
        return x[i * w:(i + 1) * w]

    # ------------------------------------------------------------ collectives

    def _host(self, x: torch.Tensor) -> bool:
        return self.backend == "gloo" and x.is_cuda

    def psum(self, x: torch.Tensor, axis: Axis) -> torch.Tensor:
        """Sum over ``axis`` (one ``all_reduce``); bool travels as int32."""
        return self._reduce(x, axis, dist.ReduceOp.SUM)

    def psum_(self, x: torch.Tensor, axis: Axis) -> torch.Tensor:
        """``psum`` in place on ``x`` (a buffer of the caller's, not bool)."""
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self._groups[_key(axis)])
        return x

    def pmax(self, x: torch.Tensor, axis: Axis) -> torch.Tensor:
        return self._reduce(x, axis, dist.ReduceOp.MAX)

    def pmean(self, x: torch.Tensor, axis: Axis) -> torch.Tensor:
        """Sum over ``axis`` divided by its size (the reference's ``pmean``)."""
        n = self.axis_size(axis)
        return self.psum(x, axis) / torch.tensor(float(n), dtype=x.dtype, device=x.device)

    def _reduce(self, x: torch.Tensor, axis: Axis, op) -> torch.Tensor:
        is_bool = x.dtype == torch.bool
        y = x.to(torch.int32) if is_bool else x.clone()
        dist.all_reduce(y, op=op, group=self._groups[_key(axis)])
        return y != 0 if is_bool else y

    def all_gather(self, x: torch.Tensor, axis: Axis) -> torch.Tensor:
        """The blocks of every rank of ``axis``, concatenated on dim 0 in axis
        order."""
        group = self._groups[_key(axis)]
        is_bool = x.dtype == torch.bool
        y = x.to(torch.int32) if is_bool else x.contiguous()
        host = self._host(y)
        if host:
            self.host_copies += 1
            y = y.cpu()
        parts = [torch.empty_like(y) for _ in range(self.axis_size(axis))]
        dist.all_gather(parts, y, group=group)
        out = torch.cat(parts)
        if host:
            out = out.to(x.device)
        return out != 0 if is_bool else out

    def psum_scatter(self, x: torch.Tensor, axis: Axis) -> torch.Tensor:
        """Sum over ``axis``, then this rank's block of dim 0 (a reduce-scatter
        as the all-reduce's slice: gloo has no reduce-scatter)."""
        y = self.psum(x, axis)
        n = self.axis_size(axis)
        w = y.shape[0] // n
        if w * n != y.shape[0]:
            raise ValueError(f"{y.shape[0]} rows do not split into {n} blocks")
        i = self._ranks[_key(axis)].index(dist.get_rank())
        return y[i * w:(i + 1) * w].contiguous()

    def ppermute(self, x: torch.Tensor, axis: str, shift: int) -> torch.Tensor:
        """Send ``x`` to the rank ``shift`` places along ``axis`` and return
        what the rank ``shift`` places back sent (zeros where no rank is
        there: the axis does not wrap, as the reference's permutation lists).
        One ``batch_isend_irecv`` of at most one send and one receive."""
        ranks = self._ranks[axis]
        i = self.axis_index(axis)
        is_bool = x.dtype == torch.bool
        y = x.to(torch.int32) if is_bool else x.contiguous()
        host = self._host(y)
        if host:
            self.host_copies += 1
            y = y.cpu()
        out = torch.zeros_like(y)
        ops = []
        group = self._groups[axis]
        if 0 <= i + shift < len(ranks):
            ops.append(dist.P2POp(dist.isend, y, ranks[i + shift], group=group))
        if 0 <= i - shift < len(ranks):
            ops.append(dist.P2POp(dist.irecv, out, ranks[i - shift], group=group))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        if host:
            out = out.to(x.device)
        return out != 0 if is_bool else out


def _key(axis: Axis) -> Axis:
    if isinstance(axis, str):
        return axis
    axis = tuple(axis)
    return axis[0] if len(axis) == 1 else (DATA_AXIS, SPACE_AXIS)


def make_mesh(n_data: Optional[int] = None, n_space: int = 1, device=None,
              backend: Optional[str] = None) -> Mesh:
    """Mesh of shape (data, space) over the first ``n_data * n_space`` ranks
    of the world; ``n_data`` defaults to all ranks on the data axis. Every
    rank of the world calls it (the groups are made collectively).

    ``device`` defaults to ``cuda:<LOCAL_RANK>``. A process in no process
    group joins a one-rank group of its own first (``backend``, default
    ``default_backend(device)``), so a plain process renders and fits
    through the mesh as the reference does on one device."""
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    device = torch.device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend or default_backend(device), store=dist.HashStore(),
                                rank=0, world_size=1)
    backend = dist.get_backend()
    if device.type == "cuda" and backend == "nccl":
        torch.cuda.set_device(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None:
        n_data = world // n_space
    if n_data < 1 or n_space < 1 or n_data * n_space > world:
        raise ValueError(f"a ({n_data}, {n_space}) mesh needs more than the {world} ranks")
    grid = [[d * n_space + s for s in range(n_space)] for d in range(n_data)]
    groups: Dict[Axis, object] = {}
    ranks: Dict[Axis, List[int]] = {}

    def add(axis: Axis, members: Sequence[int]):
        g = dist.new_group(ranks=list(members))
        if rank in members:
            groups[axis], ranks[axis] = g, list(members)

    for s in range(n_space):  # the data axis: one group per space coordinate
        add(DATA_AXIS, [grid[d][s] for d in range(n_data)])
    for d in range(n_data):  # the space axis: one group per data coordinate
        add(SPACE_AXIS, grid[d])
    add((DATA_AXIS, SPACE_AXIS), [r for row in grid for r in row])
    coords = divmod(rank, n_space) if rank < n_data * n_space else None
    return Mesh(n_data, n_space, device, backend, coords, groups, ranks)
