"""Logical-axis sharding rules (MaxText-style) with divisibility fallback.

The reference's ``repro/sharding/rules.py`` without JAX.  Every parameter
and activation dimension in the model zoo is annotated with a *logical*
axis name (``configs/base.py``).  A rules table maps each logical axis to a
tuple of physical mesh axes.  The resolver drops a mesh axis from a
dimension's mapping (the dimension degrades toward replicated) when the
dimension's size is not divisible by the product of the mapped axis sizes,
or when an earlier dimension of the same tensor already took that axis —
recording the fallback so it can be reported instead of failing.

A resolved layout is a ``PartitionSpec``: one entry per dimension, each the
mesh axis (or tuple of axes) the dimension is split over, or ``None``.  A
``NamedSharding`` pairs it with a mesh (``launch/mesh.Mesh``: ranks of a
``torch.distributed`` process group under the reference's axis names) and
names the slice of a global tensor each rank owns.  ``MeshRules`` reads
only the mesh's ``shape`` (axis name -> size), so it resolves layouts on an
abstract mesh with no process group as well.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.utils._pytree as pytree

from repro_torch.configs import base as axes

log = logging.getLogger(__name__)

# logical axis -> physical mesh axes.  () means explicitly replicated.
Rules = Mapping[str, Tuple[str, ...]]

DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    axes.BATCH: ("pod", "data"),
    axes.SEQ: (),
    axes.EMBED: (),
    axes.HEADS: ("model",),
    axes.KV_HEADS: ("model",),
    axes.HEAD_DIM: (),
    axes.MLP: ("model",),
    axes.VOCAB: ("model",),
    axes.EXPERTS: ("model",),
    axes.EXPERT_MLP: (),
    axes.LAYERS: (),
    axes.STATE: (),
    axes.CONV: (),
    axes.COMMITTEE: ("model",),
    axes.CACHE_SEQ: (),
    axes.ENC_SEQ: (),
}


class PartitionSpec(tuple):
    """One entry per tensor dimension: a mesh axis name, a tuple of mesh
    axis names (the dimension split over their product, the first axis
    major), or ``None`` (replicated).  Compares equal to the tuple of its
    entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def spec_axes(entry) -> Tuple[str, ...]:
    """A spec entry as a tuple of mesh axis names (() for ``None``)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A ``PartitionSpec`` on a mesh: which slice of a global tensor each
    rank of the mesh owns.  Dimension i of size n split over axes with
    sizes (s0, s1, ...) gives the rank at coordinates (c0, c1, ...) the
    contiguous range of n / (s0 * s1 * ...) rows starting at its
    row-major index (c0 * s1 + c1) * ... times that length."""

    mesh: Any
    spec: PartitionSpec

    def local_slices(self, shape: Sequence[int]) -> Tuple[slice, ...]:
        """This rank's slice of a global tensor of ``shape``."""
        out = []
        for i, n in enumerate(shape):
            entry = self.spec[i] if i < len(self.spec) else None
            parts, idx = 1, 0
            for a in spec_axes(entry):
                sz = int(self.mesh.shape[a])
                idx = idx * sz + self.mesh.axis_index(a)
                parts *= sz
            if n % parts:
                raise ValueError(f"dim {i} of size {n} does not split over "
                                 f"{spec_axes(entry)} ({parts} parts)")
            step = n // parts
            out.append(slice(idx * step, (idx + 1) * step))
        return tuple(out)

    def shard(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the global tensor ``t`` (a view)."""
        return t[self.local_slices(tuple(t.shape))]


def merged_rules(*overrides: Optional[Rules]) -> Dict[str, Tuple[str, ...]]:
    out = dict(DEFAULT_RULES)
    for ov in overrides:
        if ov:
            out.update({k: tuple(v) for k, v in ov.items()})
    return out


@dataclasses.dataclass
class FallbackRecord:
    tensor: str
    dim: int
    logical: str
    wanted: Tuple[str, ...]
    reason: str
    chosen: Tuple[str, ...] = ()   # mesh axes actually kept for this dim


class MeshRules:
    """Resolves logical-axis tuples to PartitionSpecs on a mesh (anything
    with a ``shape`` mapping of axis name -> size)."""

    def __init__(self, mesh, rules: Optional[Rules] = None):
        self.mesh = mesh
        self.rules = merged_rules(rules)
        self.fallbacks: List[FallbackRecord] = []

    def _mesh_axes_for(self, logical: Optional[str]) -> Tuple[str, ...]:
        if logical is None:
            return ()
        wanted = self.rules.get(logical, ())
        # drop mesh axes that don't exist on this mesh (e.g. 'pod' single-pod)
        return tuple(a for a in wanted if a in self.mesh.shape)

    def pspec(
        self,
        logical_axes: Sequence[Optional[str]],
        dims: Optional[Sequence[int]] = None,
        name: str = "?",
    ) -> PartitionSpec:
        """PartitionSpec for a tensor with the given logical axes.

        `dims` (concrete sizes) enables the divisibility fallback; without it
        the mapping is trusted.
        """
        used: set = set()
        entries = []
        for i, logical in enumerate(logical_axes):
            mesh_axes = self._mesh_axes_for(logical)
            if not mesh_axes:
                entries.append(None)
                continue
            # greedy subset fallback: keep every axis that is still free and
            # keeps the dim divisible, instead of dropping the whole mapping
            # (e.g. mlp -> ('model','data') with 'data' taken by batch must
            # degrade to ('model',), not to replicated).
            chosen = []
            prod = 1
            dropped_reasons = []
            for a in mesh_axes:
                if a in used:
                    dropped_reasons.append(f"{a}: mesh axis reuse")
                    continue
                sz = self.mesh.shape[a]
                if dims is not None and dims[i] % (prod * sz) != 0:
                    dropped_reasons.append(
                        f"{a}: dim {dims[i]} % {prod * sz} != 0")
                    continue
                chosen.append(a)
                prod *= sz
            if dropped_reasons:
                self.fallbacks.append(
                    FallbackRecord(name, i, logical or "?", mesh_axes,
                                   "; ".join(dropped_reasons),
                                   chosen=tuple(chosen)))
            if not chosen:
                entries.append(None)
                continue
            used.update(chosen)
            entries.append(tuple(chosen) if len(chosen) > 1 else chosen[0])
        return P(*entries)

    def sharding(
        self,
        logical_axes: Sequence[Optional[str]],
        dims: Optional[Sequence[int]] = None,
        name: str = "?",
    ) -> NamedSharding:
        return NamedSharding(self.mesh, self.pspec(logical_axes, dims, name))

    # ------------------------------------------------------------- pytrees
    def tree_pspecs(self, axes_tree, shape_tree=None):
        """Map a pytree of logical-axis tuples (+ optional leaves with a
        ``shape``) to a pytree of PartitionSpecs."""
        def is_axes(x):
            return isinstance(x, tuple)

        if shape_tree is None:
            return pytree.tree_map(lambda ax: self.pspec(ax), axes_tree,
                                   is_leaf=is_axes)
        flat, spec = pytree.tree_flatten(axes_tree, is_leaf=is_axes)
        shapes = spec.flatten_up_to(shape_tree)
        out = [self.pspec(ax, tuple(s.shape), name=str(tuple(s.shape)))
               for ax, s in zip(flat, shapes)]
        return pytree.tree_unflatten(out, spec)

    def tree_shardings(self, axes_tree, shape_tree=None):
        ps = self.tree_pspecs(axes_tree, shape_tree)
        return pytree.tree_map(lambda p: NamedSharding(self.mesh, p), ps,
                               is_leaf=lambda x: isinstance(x, P))


def logical_to_pspec(mesh, logical_axes, rules: Optional[Rules] = None,
                     dims=None) -> PartitionSpec:
    return MeshRules(mesh, rules).pspec(logical_axes, dims)


def logical_sharding(mesh, logical_axes, rules: Optional[Rules] = None,
                     dims=None) -> NamedSharding:
    return MeshRules(mesh, rules).sharding(logical_axes, dims)


def committee_shardings(mesh_rules: "MeshRules", cparams):
    """NamedShardings for a stacked-committee pytree (leading K axis).

    The leading axis follows the COMMITTEE logical-axis rules
    (``COMMITTEE -> ('model',)`` by default) and every other dimension is
    replicated: per-member parameters are small, it is the K-way ensemble
    that scales out over the mesh.  The standard divisibility fallback
    applies — a committee whose K does not divide the mapped mesh axes
    (e.g. K=3 on a 2-way model axis) degrades to replicated, recorded in
    ``mesh_rules.fallbacks``.  Leaves are anything with a ``shape``
    (tensors, numpy arrays; a quantized moment's ``q`` and ``scale``)."""
    def leaf(a):
        shape = tuple(int(s) for s in getattr(a, "shape", ()))
        if not shape:                       # 0-d leaf: replicate
            return mesh_rules.sharding((), (), name="cparams")
        logical = (axes.COMMITTEE,) + (None,) * (len(shape) - 1)
        return mesh_rules.sharding(logical, shape, name="cparams")

    return pytree.tree_map(leaf, cparams)


def warn_fallbacks(mesh_rules: Optional["MeshRules"], context: str,
                   *, start: int = 0) -> int:
    """Log a WARNING for every divisibility/axis-reuse fallback recorded on
    ``mesh_rules`` since ``start``, naming the layout actually chosen.

    A fallback is legal (the program still runs, with less parallelism than
    the rules asked for), but silently losing e.g. the committee axis on a
    K=3 committee over a 2-way mesh is a slowdown that hides until someone
    profiles — so mesh consumers (``FusedEngine``, ``CommitteeTrainer``)
    surface it once at construction.  Returns the new high-water mark into
    ``mesh_rules.fallbacks`` so repeated calls don't re-warn old records.
    """
    if mesh_rules is None:
        return start
    recs = mesh_rules.fallbacks[start:]
    for r in recs:
        chosen = ",".join(r.chosen) if r.chosen else "replicated"
        log.warning(
            "%s: sharding fallback on %s dim %d (logical %s): wanted "
            "mesh axes (%s) -> using (%s) [%s]",
            context, r.tensor, r.dim, r.logical, ",".join(r.wanted),
            chosen, r.reason)
    return len(mesh_rules.fallbacks)


def shard_constraint(x, mesh_rules: Optional["MeshRules"], logical_axes):
    """``x`` unchanged.  In the reference this is a layout hint to XLA
    (``with_sharding_constraint``) that changes no value; the port lays
    tensors out explicitly where it shards them (``NamedSharding.shard``),
    so the hint has nothing to do.  The spec is still resolved, so a
    mapping that does not fit ``x`` is recorded as a fallback as it is in
    the reference."""
    if mesh_rules is not None:
        mesh_rules.pspec(logical_axes, tuple(x.shape))
    return x
