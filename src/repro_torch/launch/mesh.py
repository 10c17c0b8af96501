"""Device meshes over ``torch.distributed`` (port of
``repro/launch/mesh.py``).

The port runs SPMD: one process per rank, every rank the same program on
the same inputs. A ``Mesh`` names the ranks' grid: ``axis_names``,
``shape`` (an ordered name -> size mapping, as a JAX mesh's), each axis's
process group and this rank's coordinate on it. A mesh-native function
takes global values on every rank, works on the slice its coordinates
select and hands back the global result on every rank; an axis of size 1
issues no collective (a JAX ``ppermute`` over one device is an identity).

``make_mesh`` starts the process group when none is running: a one-rank
mesh in-process (a ``HashStore``), a larger one from the environment
(``RANK``, ``WORLD_SIZE`` and a ``FileStore`` named by
``REPRO_TORCH_FILESTORE``, as ``repro_torch.testing.run_ranks`` sets
them; else ``MASTER_ADDR`` / ``MASTER_PORT``). ``abstract_mesh`` is the
same description with no process group, for specs and sharding rules.

Functions only (no module-level mesh), so importing this module starts
nothing.
"""

from __future__ import annotations

import atexit
import datetime
import math
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch

STORE_ENV = "REPRO_TORCH_FILESTORE"
# A collective that waits longer than this raises instead of hanging.
PG_TIMEOUT = datetime.timedelta(seconds=300)


class Mesh:
    """A named grid of ranks. ``shape`` maps axis name -> size in axis
    order; ``devices_shape`` is the same sizes as a tuple. An abstract
    mesh (``abstract_mesh``) has no process group: ``group`` and
    ``coordinate`` raise on it."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str], *,
                 device: Optional[torch.device] = None, device_mesh=None):
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {tuple(shape)} and axes "
                             f"{tuple(axes)} differ in length")
        self.axis_names = tuple(axes)
        self.devices_shape = tuple(int(s) for s in shape)
        self.shape = dict(zip(self.axis_names, self.devices_shape))
        self.device = device
        self.device_mesh = device_mesh

    @property
    def size(self) -> int:
        return math.prod(self.devices_shape)

    def _live(self):
        if self.device_mesh is None:
            raise ValueError("an abstract mesh has no process group: use "
                             "make_mesh for collectives")
        return self.device_mesh

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        self._live()
        import torch.distributed as dist

        coords = np.unravel_index(dist.get_rank(), self.devices_shape)
        return int(coords[self.axis_names.index(axis)])

    def ranks(self, axis: str) -> list[int]:
        """Global ranks along ``axis`` through this rank, in coordinate
        order (the ring's neighbours are ``ranks[(i +- 1) % n]``)."""
        self._live()
        import torch.distributed as dist

        grid = np.arange(self.size).reshape(self.devices_shape)
        coords = list(np.unravel_index(dist.get_rank(), self.devices_shape))
        coords[self.axis_names.index(axis)] = slice(None)
        return [int(r) for r in grid[tuple(coords)]]

    def group(self, axis: str):
        """The process group of the ranks along ``axis`` through this
        rank."""
        return self._live().get_group(axis)

    def __repr__(self) -> str:
        return describe(self)


def abstract_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """The mesh's description alone: names and sizes, no process group."""
    return Mesh(shape, axes)


def _world() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def ensure_process_group(device: torch.device) -> None:
    """Start the default process group unless one is running: NCCL for a
    card, gloo for the CPU; one rank on an in-process ``HashStore``, more
    from the environment (see the module docstring)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if world == 1:
        store = dist.HashStore()
    elif os.environ.get(STORE_ENV):
        store = dist.FileStore(os.environ[STORE_ENV], world)
    else:
        dist.init_process_group(backend, rank=rank, world_size=world,
                                timeout=PG_TIMEOUT)
        atexit.register(_shutdown)
        sys.excepthook = _note_failure
        return
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=PG_TIMEOUT)
    atexit.register(_shutdown)
    sys.excepthook = _note_failure


_FAILED: list = []


def _note_failure(kind, value, tb) -> None:
    _FAILED.append(kind)
    _EXCEPTHOOK(kind, value, tb)


_EXCEPTHOOK = sys.excepthook


def _shutdown() -> None:
    """Leave together and tear the group down before the interpreter
    does: a gloo group left to interpreter exit can abort the process
    while its threads still run. A rank dying of an exception leaves at
    once (its peers may be waiting in a collective it never reaches)."""
    import torch.distributed as dist

    if dist.is_initialized() and not _FAILED:
        if dist.get_world_size() > 1:
            dist.barrier()
        dist.destroy_process_group()


def _rank_device(device) -> torch.device:
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


_MESHES: dict[tuple, Mesh] = {}


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device="cuda") -> Mesh:
    """A live mesh over every rank of the world (row-major: rank r sits at
    ``np.unravel_index(r, shape)``). Raises when the world is smaller than
    the mesh, as JAX's does, and when it is larger (the port's meshes
    cover the world). Every rank must call it, in the same order."""
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    n = math.prod(shape)
    have = _world()
    if have < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices, have {have} — start one "
            "process per rank (repro_torch.testing.run_ranks), or describe "
            "the mesh with abstract_mesh")
    if have > n:
        raise RuntimeError(
            f"mesh {shape} covers {n} ranks of a world of {have}: a mesh "
            "spans every rank")
    dev = _rank_device(device)
    key = (shape, axes, dev.type)
    if key not in _MESHES:
        ensure_process_group(dev)
        from torch.distributed.device_mesh import init_device_mesh

        dm = init_device_mesh(dev.type, shape, mesh_dim_names=axes)
        _MESHES[key] = Mesh(shape, axes, device=dev, device_mesh=dm)
    return _MESHES[key]


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """Single pod: (16, 16) = 256 ranks, axes (data, model).
    Multi-pod: (2, 16, 16) = 512 ranks, axes (pod, data, model)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def describe(mesh: Mesh) -> str:
    return f"mesh(shape={dict(mesh.shape)}, devices={mesh.size})"


def require_global(*tensors) -> None:
    """Mesh-native calls take global values on every rank; a DTensor (a
    sharded value with its own placement) is refused rather than read
    as its local shard."""
    from torch.distributed.tensor import DTensor

    for t in tensors:
        if isinstance(t, DTensor):
            raise TypeError(
                "mesh-native calls take global values on every rank, not a "
                "DTensor: pass dtensor.full_tensor()")


# -- collectives along one mesh axis (JAX's ppermute / psum / all_gather
# inside a shard_map body). An axis of size 1 issues none.


def ring_shift(tensors: Sequence[torch.Tensor], mesh: Mesh, axis: str):
    """Post the send of each tensor to the next rank along ``axis`` and
    the receive of its counterpart from the previous one (JAX's
    ``ppermute`` with ``perm = [(i, (i + 1) % n)]``). Returns (received,
    wait): the received tensors may be read only after ``wait()``."""
    if mesh.shape[axis] == 1:
        return list(tensors), lambda: None
    import torch.distributed as dist

    ranks = mesh.ranks(axis)
    i, n = mesh.coordinate(axis), len(ranks)
    nxt, prev = ranks[(i + 1) % n], ranks[(i - 1) % n]
    group = mesh.group(axis)
    recv = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), nxt, group)
           for t in tensors]
    ops += [dist.P2POp(dist.irecv, r, prev, group) for r in recv]
    reqs = dist.batch_isend_irecv(ops)

    def wait():
        for r in reqs:
            r.wait()

    return recv, wait


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str,
               dim: int) -> torch.Tensor:
    """Every rank's ``t`` along ``axis`` concatenated on ``dim`` in
    coordinate order."""
    if mesh.shape[axis] == 1:
        return t
    import torch.distributed as dist

    parts = [torch.empty_like(t) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, t.contiguous(), group=mesh.group(axis))
    return torch.cat(parts, dim=dim)


def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of every rank's ``t`` along ``axis`` (JAX's ``psum``); a
    new tensor, ``t`` is left as it was."""
    if mesh.shape[axis] == 1:
        return t
    import torch.distributed as dist

    out = t.clone()
    dist.all_reduce(out, group=mesh.group(axis))
    return out
