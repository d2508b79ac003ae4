"""Device meshes over ``torch.distributed`` (counterpart of
``repro/launch/mesh.py``).

The port runs a mesh as SPMD processes: one process per rank, each running
the whole program, launched from outside (``torchrun --standalone
--nproc-per-node DP*TP -m repro_torch.launch.serve ... --mesh DP,TP``, or
``torch.multiprocessing`` in tests). A :class:`Mesh` lays the world's ranks
out row-major over named axes, as ``jax.make_mesh`` lays out devices, and
holds one process group per axis. Plans placed on it
(:mod:`repro_torch.engine.mesh`) keep this rank's slice, and their
matmuls end in collectives over the axis groups.

Devices and backends. Rank r uses ``cuda:(local_rank % device_count)``
unless the caller asks for the CPU, so ranks may share a card. NCCL refuses
two ranks on one card, so :func:`init_distributed` chooses the backend:
``nccl`` when every rank of the host has a card of its own, ``gloo`` when
ranks share a card or run on the CPU. A failed collective raises; nothing
retries on another backend.
"""
from __future__ import annotations

import math
import os
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import DATA_AXES

Axes = Union[str, Tuple[str, ...]]


def _world() -> Tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def _device_of(rank: int, device) -> torch.device:
    """Rank ``rank``'s device: the CPU when asked for, a CUDA device named
    with an index as given, else ``cuda:(local_rank % device_count)``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu" or dev.index is not None:
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "mesh on the CPU (gloo)")
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def rank_device(device=None) -> torch.device:
    """This rank's device (see :func:`_device_of`)."""
    return _device_of(_world()[0], device)


def choose_backend(device, local_world_size: int) -> str:
    """``nccl`` when every rank of the host has a CUDA device of its own,
    else ``gloo`` (ranks on the CPU, or sharing a card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(device=None, init_method: str = "env://",
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> str:
    """Join the process group (unless this process already has) with the
    backend :func:`choose_backend` picks for ``device``; returns the
    backend. ``rank`` and ``world_size`` default to the launcher's
    ``RANK`` and ``WORLD_SIZE``."""
    if dist.is_initialized():
        return dist.get_backend()
    if rank is None:
        rank = int(os.environ["RANK"])
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    dev = _device_of(rank, device)
    backend = choose_backend(dev, local)
    if backend == "nccl":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return backend


class Mesh:
    """The world's ranks laid out row-major over named axes, with this
    rank's coordinates and one process group per axis of size > 1 (and one
    over the data axes together). ``shape`` maps axis -> size, as a JAX
    mesh's does. Building a mesh is collective: every rank builds the same
    one, in the same order."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device=None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} does not match its "
                             f"axes {tuple(axis_names)}")
        rank, world = _world()
        if math.prod(shape) != world:
            raise ValueError(
                f"a {'x'.join(map(str, shape))} mesh needs "
                f"{math.prod(shape)} ranks, the world has {world}")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, shape))
        self.rank = rank
        self.device = rank_device(device)
        self.backend = dist.get_backend() if dist.is_initialized() else None
        self.coords = self._coords_of(rank)
        self._groups: Dict[Tuple[str, ...], object] = {}
        data = tuple(a for a in DATA_AXES if a in self.axis_names)
        for axes in [(a,) for a in self.axis_names] + [data]:
            if axes and axes not in self._groups:
                self._groups[axes] = self._new_group(axes)

    def _new_group(self, axes: Tuple[str, ...]):
        """The group of ranks that differ only along ``axes`` (None when
        they span one rank)."""
        if self.size(axes) == 1:
            return None
        members: Dict[tuple, list] = {}
        for r in range(math.prod(self.shape.values())):
            c = self._coords_of(r)
            key = tuple(c[a] for a in self.axis_names if a not in axes)
            members.setdefault(key, []).append(r)
        group, _ = dist.new_subgroups_by_enumeration(list(members.values()))
        return group

    def _coords_of(self, r: int) -> Dict[str, int]:
        out = {}
        for a in reversed(self.axis_names):
            out[a] = r % self.shape[a]
            r //= self.shape[a]
        return out

    @staticmethod
    def _axes(axes: Axes) -> Tuple[str, ...]:
        return (axes,) if isinstance(axes, str) else tuple(axes)

    def size(self, axes: Axes) -> int:
        """Ranks along ``axes`` (one name or several)."""
        return math.prod(self.shape[a] for a in self._axes(axes))

    def index(self, axes: Axes) -> int:
        """This rank's position along ``axes``, row-major over them."""
        i = 0
        for a in self._axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes: Axes):
        """The process group along ``axes``; None where it is one rank."""
        axes = self._axes(axes)
        if self.size(axes) == 1:
            return None
        return self._groups[axes]

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return (f"Mesh({dims}; rank {self.rank} on {self.device}, "
                f"backend {self.backend})")


def _parse(spec: str) -> Tuple[int, int]:
    try:
        dp, tp = (int(p) for p in spec.split(","))
    except ValueError:
        raise ValueError(
            f"--mesh expects 'dp,tp' (two comma-separated ints), got "
            f"{spec!r}") from None
    if dp < 1 or tp < 1:
        raise ValueError(f"--mesh axes must be >= 1, got dp={dp}, tp={tp}")
    return dp, tp


def _join_launched(device) -> None:
    """Join the process group a launcher set up (``WORLD_SIZE`` in the
    environment), unless this process already has one."""
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE",
                                                        "1")) > 1:
        init_distributed(device)


def make_mesh(spec: str, device=None,
              module: str = "repro_torch.launch.serve") -> Mesh:
    """A ("data", "model") mesh from a CLI ``"dp,tp"`` spec over the
    world's ranks. dp * tp must equal the world size: each rank is a
    process started by the launcher, and a single process never stands in
    for a mesh (the error names ``module``'s torchrun line)."""
    dp, tp = _parse(spec)
    _join_launched(device)
    _, world = _world()
    if dp * tp != world:
        raise ValueError(
            f"--mesh {spec!r} needs {dp * tp} ranks but this run has "
            f"{world}; start one process per rank, e.g. torchrun "
            f"--standalone --nproc-per-node {dp * tp} -m {module} ... "
            f"--mesh {spec}")
    return Mesh((dp, tp), ("data", "model"), device)


make_serve_mesh = make_mesh     # serve's --mesh


__all__ = ["Mesh", "choose_backend", "init_distributed", "make_mesh",
           "make_serve_mesh", "rank_device"]
