"""Meshes over ``torch.distributed`` ranks.

The reference's ``repro/launch/mesh.py`` builds ``jax.sharding.Mesh``es of
devices.  A port ``Mesh`` is a grid of process-group ranks (one device
each, ``launch/distributed.py``) under the reference's axis names —
``('data', 'model')`` or ``('pod', 'data', 'model')`` — with

  * ``shape``: axis name -> size, in axis order (all that
    ``sharding.rules.MeshRules`` reads, so layouts resolve on an abstract
    mesh with no process group too);
  * ``device_mesh``: the ``torch.distributed.device_mesh.DeviceMesh`` of
    those ranks when a process group is up (it owns one process group per
    axis);
  * collectives over named axes (``all_gather``, ``all_reduce_sum``).  An
    axis of size 1 needs none, so a 1x1 mesh runs exactly the unsharded
    program.  Under gloo a CUDA tensor is staged through pinned host memory
    (gloo's collectives are host-side); the staged bytes are returned, so
    callers count them;
  * ``twin``: the same grid over process groups of its own, for a second
    thread's collectives (gloo is not safe with two threads issuing
    collectives on one group); ``release`` destroys them.

Functions, not module constants: importing this module creates no
process-group state.
"""
from __future__ import annotations

import datetime
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

_CACHE: Dict[Tuple, object] = {}     # (ranks, axis names) -> DeviceMesh


def clear_cache() -> None:
    """Forget the DeviceMeshes built so far (their groups die with the
    process group)."""
    _CACHE.clear()


def _world() -> Tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a process
    group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """A grid of ranks (``ranks``: an int array shaped by the axes) under
    ``axis_names``.  ``abstract`` meshes (the planners') name no process:
    they resolve layouts and run nothing."""

    def __init__(self, ranks, axis_names: Sequence[str], *,
                 device_mesh=None, abstract: bool = False,
                 groups: Optional[Dict[str, object]] = None,
                 owned: Sequence[object] = ()):
        self.ranks = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.ranks.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.ranks.shape} needs "
                             f"{self.ranks.ndim} axis names, got "
                             f"{self.axis_names}")
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              self.ranks.shape))
        self.device_mesh = device_mesh
        self.abstract = abstract
        self._groups = dict(groups or {})   # axis -> this rank's group
        self._owned = list(owned)           # what ``release`` destroys

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    # ---------------------------------------------------------- coordinates
    def coordinate(self) -> Dict[str, int]:
        """This process's index along every axis.  Raises for a rank the
        mesh does not hold, and on an abstract mesh."""
        if self.abstract:
            raise ValueError("an abstract mesh holds no process")
        rank, _ = _world()
        where = np.argwhere(self.ranks == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not in the mesh "
                             f"{self.ranks.tolist()}")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def axis_index(self, axis: str) -> int:
        return self.coordinate()[axis]

    def axes_size(self, axes: Sequence[str]) -> int:
        return int(np.prod([self.shape[a] for a in axes], dtype=np.int64))

    def axes_index(self, axes: Sequence[str]) -> int:
        """This rank's row-major index over ``axes`` (the first major)."""
        c, idx = self.coordinate(), 0
        for a in axes:
            idx = idx * self.shape[a] + c[a]
        return idx

    # ---------------------------------------------------------- collectives
    def twin(self, timeout: Optional[datetime.timedelta] = None) -> "Mesh":
        """This grid over process groups of its own, made with ``timeout``
        (each collective waits at most that long): one group per line of
        every axis of size > 1.  Every rank of the process group must call
        it in the same order (``new_group`` is collective)."""
        rank, _ = _world()
        groups, made = {}, []
        for d, axis in enumerate(self.axis_names):
            n = self.shape[axis]
            if n < 2:
                continue
            for line in np.moveaxis(self.ranks, d, -1).reshape(-1, n):
                g = dist.new_group([int(r) for r in line], timeout=timeout)
                made.append(g)
                if rank in line:
                    groups[axis] = g
        return Mesh(self.ranks, self.axis_names, groups=groups, owned=made)

    def release(self) -> None:
        """Destroy the process groups ``twin`` made for this mesh, in the
        order it made them (every rank of the process group calls it); a
        mesh that ``twin`` did not make owns none.  Its collectives raise
        afterwards; a second call does nothing."""
        owned, self._owned = self._owned, []
        self._groups.clear()
        if dist.is_available() and dist.is_initialized():
            for g in owned:
                dist.destroy_process_group(g)

    def _group(self, axis: str):
        if axis in self._groups:
            return self._groups[axis]
        if self.device_mesh is None:
            raise RuntimeError(f"mesh axis {axis!r} of size "
                               f"{self.shape[axis]} needs a process group "
                               "(launch/distributed.initialize)")
        return self.device_mesh.get_group(mesh_dim=axis)

    def _gather_axis(self, t: torch.Tensor, axis: str
                     ) -> Tuple[torch.Tensor, int]:
        n = self.shape[axis]
        g = self._group(axis)
        src = t.contiguous()
        staged = src.device.type == "cuda" and \
            dist.get_backend(g) == "gloo"
        if staged:
            host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            host.copy_(src)                     # waits for the producer
            src_c = host
        else:
            src_c = src
        parts = [torch.empty_like(src_c) for _ in range(n)]
        dist.all_gather(parts, src_c, group=g)
        out = torch.cat(parts)
        if staged:
            nbytes = host.nbytes + out.nbytes
            return out.to(t.device), nbytes
        return out, 0

    def all_gather(self, t: torch.Tensor, axes: Sequence[str]
                   ) -> Tuple[torch.Tensor, int]:
        """The ranks' ``t`` concatenated along dim 0 in their row-major
        order over ``axes`` (the first axis major), on every rank of those
        axes; with the bytes staged through host memory.  Axes of size 1
        cost nothing.  bool tensors travel as uint8."""
        out, staged = t, 0
        as_bool = t.dtype == torch.bool
        if as_bool:
            out = out.view(torch.uint8)
        for a in reversed(tuple(axes)):
            if self.shape[a] > 1:
                out, nb = self._gather_axis(out, a)
                staged += nb
        return (out.view(torch.bool) if as_bool else out), staged

    def all_reduce_sum(self, t: torch.Tensor, axes: Sequence[str]
                       ) -> torch.Tensor:
        """The sum of the ranks' ``t`` over ``axes`` (a new tensor), in rank
        order: the partials are gathered and added in one fixed order, so
        every rank gets the same bits."""
        parts, _ = self.all_gather(t.reshape((1,) + tuple(t.shape)), axes)
        return parts.sum(dim=0)


def _make(shape: Tuple[int, ...], axes: Tuple[str, ...],
          ranks: Optional[np.ndarray] = None) -> Mesh:
    """A mesh over ``ranks`` (default: the first prod(shape) ranks), with a
    DeviceMesh when a process group is up.  Every rank of the process group
    must make the same meshes in the same order (a DeviceMesh creates its
    groups collectively)."""
    _, world = _world()
    need = int(np.prod(shape))
    if ranks is None:
        if need > world:
            raise ValueError(f"mesh {dict(zip(axes, shape))} needs {need} "
                             f"ranks, the process group has {world}")
        ranks = np.arange(need).reshape(shape)
    dm = None
    if dist.is_available() and dist.is_initialized():
        key = (tuple(ranks.reshape(-1).tolist()), tuple(ranks.shape), axes)
        dm = _CACHE.get(key)
        if dm is None:
            from torch.distributed.device_mesh import DeviceMesh

            backend = dist.get_backend()
            dm = DeviceMesh("cuda" if backend == "nccl" else "cpu",
                            torch.as_tensor(ranks), mesh_dim_names=axes)
            _CACHE[key] = dm
    return Mesh(ranks, axes, device_mesh=dm)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: (16, 16) ('data', 'model') = 256 ranks.
    Multi-pod:  (2, 16, 16) ('pod', 'data', 'model') = 512 ranks.
    `pod` acts as an outer data-parallel axis (batch sharded over
    ('pod', 'data')); params replicate across pods.  Raises ``ValueError``
    when the process group is smaller (``abstract_mesh`` resolves layouts
    for it without any ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make(shape, axes)


def abstract_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh's shape and axis names with no ranks behind it:
    ``MeshRules`` resolves layouts on it (the planners)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(np.arange(int(np.prod(shape))).reshape(shape), axes,
                abstract=True)


def make_host_mesh() -> Mesh:
    """Degenerate 1x1 mesh on this process's own device (smoke tests): the
    unsharded program, no collective.  It holds a DeviceMesh only in a
    process group of one rank (other ranks make their own host meshes)."""
    rank, world = _world()
    ranks = np.array([[rank]])
    if world == 1:
        return _make((1, 1), ("data", "model"), ranks)
    return Mesh(ranks, ("data", "model"))


def make_scaleout_mesh(data: int = 0, model: int = 1) -> Mesh:
    """('data', 'model') mesh over the first ``data*model`` ranks.

    Unlike the production mesh this accepts a SUBSET of the ranks, which is
    what scaling curves need.  ``data=0`` means "all ranks on the data
    axis" — the default scale-out for fused scoring, where rows shard over
    ``data`` and the committee replicates.  Without a process group the
    world is this one process."""
    _, world = _world()
    if data <= 0:
        if world % model:
            raise ValueError(
                f"make_scaleout_mesh: {world} ranks not divisible by "
                f"model={model}")
        data = world // model
    need = data * model
    if need > world:
        raise ValueError(
            f"make_scaleout_mesh: need {data}x{model}={need} ranks, have "
            f"{world}")
    return _make((data, model), ("data", "model"))
