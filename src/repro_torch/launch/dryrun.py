"""Multi-pod dry-run: plan every (architecture x input shape) on the
production meshes, with memory / cost / collective analysis.

The reference's ``repro/launch/dryrun.py`` lowers and compiles each cell's
step under the production mesh with GSPMD and reads four things from XLA.
The port has no partitioner (``torch.distributed.tensor`` cannot carry
these models: sharding propagation fails on their matmuls and mixed
tensors), so it reads them as follows:

  * resident bytes per device: exact, from the layouts ``MeshRules``
    resolves for the params, the batch, the optimizer state (quantized
    moments included) and the cache, as pure arithmetic on their
    ``PartitionSpec``s (``sharded_bytes_per_device``);
  * "lower" means to trace: the cell's step (``make_train_step``,
    ``make_prefill_fn`` or ``make_decode_fn``) runs with ``impl="plain"``
    (the reference's dry-run lowers its default ``xla`` path; the hand
    kernels launch on raw pointers and cannot run on fake tensors) on
    ``FakeTensorMode`` tensors at the cell's global shapes, on ``cuda`` by
    default or on the CPU when the caller asks.  A training step runs its
    layers under the arch's remat policy (``cfg.remat``), as the
    reference compiles it: the checkpoint's recompute runs inside the
    trace, so the FLOPs and bytes count it and the peak sees the
    activations it frees;
  * cost: ``flops`` from ``FlopCounterMode`` over the trace;
    ``bytes_accessed`` the sum over every aten op that is not a view of
    its tensor operands' and results' bytes; ``memory.temp_size_in_bytes``
    the peak of the bytes of storages the trace allocated and still held
    (the step's new state included, as the port's step holds it beside
    the old one until it copies it in).  The trace is global; per-device
    values are global / chips, the reference's convention
    (``repro/launch/roofline.py``);
  * collectives: the port's own estimate from the resolved layouts
    (``estimate_collectives``), where the reference parses XLA's
    partitioned HLO.  Per device, by the reference's kind names.  ``D`` is
    the set of mesh axes the batch is sharded over:

      1. parameter all-gathers: a parameter leaf sharded over axes in D of
         total size G is all-gathered once in each forward pass and again
         in training's backward pass, local bytes x (G - 1) each time;
      2. gradient reductions (training): over the D axes a leaf is sharded
         on, a reduce-scatter of its gradient (local gradient bytes x
         (G - 1)); over the D axes it is replicated on (size R), an
         all-reduce of 2 x local gradient bytes x (R - 1) / R.  The
         gradient is bf16 under ``grad_compression="bf16"``, else fp32;
      3. tensor-parallel all-reduces: a weight whose contraction dims are
         sharded over non-D axes of size T has one all-reduce of its output
         activation, 2 x bytes x (T - 1) / T, in each forward pass (once
         per layer it holds) and one more in training's backward pass.  In
         the ``(in, out)`` layout the contraction dim is ``shape[-2]``; in
         the attention projections' ``(embed, heads, head_dim)`` layouts
         the output is (heads, head_dim) for q/k/v and the contraction is
         (heads, head_dim) for the output projection.  Expert weights count
         the tokens routed to them (tokens x top_k);
      4. sequence-sharded caches (decode): when the KV cache's sequence is
         sharded over axes of size Q, each attention layer all-gathers the
         split-KV partials (fp32 acc, m and l per query head and token:
         ``kernels/flash_attention.pack_partials``), partial bytes x
         (Q - 1), as ``ops.attention(kv_seq_shard=True)`` merges them.

    A 1x1 mesh gives no collective.

Report keys follow the reference's, with ``"traced"`` for ``"compiled"``,
``"trace_seconds"`` for ``"compile_seconds"`` and
``"collective_bytes_per_device"`` for ``"hlo_collective_bytes_per_device"``,
plus ``"impl": "plain"`` and ``"device"``.  A decode step traces at the
last position (index = seq_len - 1), attending over the whole cache.  The
meshes are ``launch/mesh.abstract_mesh`` (the production shapes with no
process behind them), so nothing here needs 256 ranks.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out results/dryrun]
  (add --device cpu to trace on the CPU)
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import base as ax
from repro_torch.configs import get_arch, get_shape, list_archs
from repro_torch.configs.base import ArchSpec, ShapeConfig, TrainConfig
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.launch.platform import DeviceLike, resolve_device
from repro_torch.models import common as cm
from repro_torch.models import model_zoo
from repro_torch.sharding.rules import MeshRules, NamedSharding, spec_axes
from repro_torch.training.train_step import make_train_state, make_train_step

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")

# ---------------------------------------------------------------------------
# Sharding resolution
# ---------------------------------------------------------------------------


def make_rules(spec: ArchSpec, shape: ShapeConfig, mesh,
               extra: Optional[Dict] = None) -> MeshRules:
    merged = dict(spec.rules)
    if shape.kind != "train":
        merged.update(spec.serve_rules)
    merged.update(shape.rule_overrides)
    if extra:
        merged.update(extra)
    return MeshRules(mesh, merged)


def spec_shardings(rules: MeshRules, specs) -> Any:
    """ParamSpec tree -> NamedSharding tree (divisibility-checked)."""
    return cm.map_specs(
        lambda s: rules.sharding(s.axes, s.shape, name=str(s.shape)), specs)


def abstract_tree(specs) -> Any:
    return cm.abstract_params(specs)


def abstract_tree_bf16(specs) -> Any:
    """Serving-path params: inference weights ship in bf16 (fp32 master
    stays on the training side)."""
    def cast(s):
        a = s.abstract()
        if a.dtype == torch.float32:
            return torch.empty(a.shape, dtype=torch.bfloat16, device="meta")
        return a
    return cm.map_specs(cast, specs)


def batch_shardings(rules: MeshRules, batch_sds: Dict[str, Any]) -> Dict:
    out = {}
    for k, v in batch_sds.items():
        axes = (ax.BATCH,) + (None,) * (len(v.shape) - 1)
        out[k] = rules.sharding(axes, tuple(v.shape), name=k)
    return out


def state_shardings(rules: MeshRules, model, train_cfg) -> Tuple[Any, Any]:
    """(abstract TrainState, TrainState of NamedShardings).  The abstract
    state is ``make_train_state`` run on ``meta`` params (the reference's
    ``jax.eval_shape``)."""
    from repro_torch.optim.adamw import (
        AdamWState, QTensor, quantize, resolve_moments)
    from repro_torch.training.train_step import TrainState

    specs = model.param_specs()
    p_sds = abstract_tree(specs)
    p_sh = spec_shardings(rules, specs)
    state_sds = make_train_state(p_sds, train_cfg)
    repl = rules.sharding((), ())

    if resolve_moments(getattr(train_cfg, "opt_moments", ""),
                       train_cfg.quantized_opt_state) != "int8":
        state_sh = TrainState(step=repl, params=p_sh,
                              opt=AdamWState(step=repl, mu=p_sh, nu=p_sh))
        return state_sds, state_sh

    def q_shard(spec: cm.ParamSpec):
        qt = quantize(torch.zeros(spec.shape, dtype=torch.float32,
                                  device="meta"))
        q_sh = rules.sharding(spec.axes, tuple(qt.q.shape),
                              name="q" + str(spec.shape))
        # scale keeps the param's rank (blocked dim shrunk in place), so it
        # reuses the same logical axes; divisibility fallback handles the
        # shrunk dim when it no longer divides.
        s_axes = spec.axes if len(spec.shape) else ()
        s_sh = rules.sharding(s_axes, tuple(qt.scale.shape),
                              name="qs" + str(spec.shape))
        return QTensor(q=q_sh, scale=s_sh, block=qt.block, axis=qt.axis)

    m_sh = cm.map_specs(q_shard, specs)
    state_sh = TrainState(step=repl, params=p_sh,
                          opt=AdamWState(step=repl, mu=m_sh, nu=m_sh))
    return state_sds, state_sh


def committee_state_bytes(member_params, k: int, train_cfg=None,
                          policy=None) -> int:
    """Exact bytes of a K-member stacked committee ``TrainState``.

    Delegates to ``optim/memory_policy.stacked_state_nbytes`` (shapes and
    dtypes of the trainer's own constructor, ``QTensor`` scale arrays
    included).  ``policy`` wins over ``train_cfg``; both absent means
    fp32."""
    from repro_torch.optim.adamw import resolve_moments
    from repro_torch.optim.memory_policy import (
        MemoryPolicy, resolve_policy, stacked_state_nbytes)

    p = resolve_policy(policy)
    if p is None:
        fmt = "fp32"
        if train_cfg is not None:
            fmt = resolve_moments(getattr(train_cfg, "opt_moments", ""),
                                  getattr(train_cfg, "quantized_opt_state",
                                          False))
        p = MemoryPolicy(name=fmt, moments=fmt)
    return stacked_state_nbytes(member_params, k, p)


def _is_sharding(x) -> bool:
    return isinstance(x, NamedSharding)


def _split_over(mesh, entry) -> int:
    return math.prod(int(mesh.shape[a]) for a in spec_axes(entry))


def sharded_bytes_per_device(sds_tree, sharding_tree, mesh) -> int:
    """Exact per-device resident bytes of a sharded tree (``meta`` tensors
    beside their ``NamedSharding``s)."""
    leaves_s = pytree.tree_leaves(sds_tree)
    leaves_sh = pytree.tree_leaves(sharding_tree, is_leaf=_is_sharding)
    if len(leaves_s) != len(leaves_sh):
        raise ValueError(f"{len(leaves_s)} leaves against "
                         f"{len(leaves_sh)} shardings")
    total = 0
    for sds, sh in zip(leaves_s, leaves_sh):
        nbytes = math.prod(sds.shape) * sds.dtype.itemsize
        used = math.prod(_split_over(mesh, e) for e in sh.spec)
        total += nbytes // max(used, 1)
    return total


# ---------------------------------------------------------------------------
# Collectives: the rule of the module docstring
# ---------------------------------------------------------------------------


def _contraction_dims(axes: Sequence[Optional[str]]) -> Tuple[int, ...]:
    """The dims a weight of these logical axes contracts over: the output
    is the last dim, or (heads, head_dim) for the q/k/v projections; the
    contraction is the run of dims before it back to a layers or experts
    dim."""
    n = len(axes)
    n_out = 2 if n >= 2 and axes[-1] == ax.HEAD_DIM and \
        axes[-2] in (ax.HEADS, ax.KV_HEADS) else 1
    dims = []
    for i in range(n - n_out - 1, -1, -1):
        if axes[i] in (ax.LAYERS, ax.EXPERTS):
            break
        dims.append(i)
    return tuple(sorted(dims))


def _leaves_with_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def estimate_collectives(
    specs, shardings, mesh, batch_axes: Sequence[str], *, train: bool,
    tokens: Callable[[str, cm.ParamSpec], int],
    act_itemsize: int, param_itemsize: int, grad_itemsize: int = 4,
    seq_gathers: Tuple[int, float] = (0, 0.0),
) -> Dict[str, Dict[str, float]]:
    """Per-device collectives of one step by the rule of the module
    docstring: ``{kind: {"count", "bytes"}}`` for the kinds that occur.

    ``specs`` / ``shardings``: the parameter ``ParamSpec`` tree and its
    ``NamedSharding`` tree; ``batch_axes``: D; ``tokens(path, spec)``: the
    tokens (per device) the weight at ``path`` is applied to in one pass;
    ``param_itemsize``: the bytes of a parameter element as the step holds
    it; ``seq_gathers``: (count, bytes each) of rule 4."""
    def size(axes) -> int:
        return math.prod(int(mesh.shape[a]) for a in axes)

    d_axes = tuple(batch_axes)
    passes = 2 if train else 1
    out: Dict[str, Dict[str, float]] = {}

    def add(kind, count, nbytes):
        if count:
            rec = out.setdefault(kind, {"count": 0, "bytes": 0.0})
            rec["count"] += count
            rec["bytes"] += float(nbytes)

    sh_of = dict(_leaves_with_paths(shardings))
    for path, spec in _leaves_with_paths(specs):
        entries = tuple(sh_of[path].spec) + (None,) * len(spec.shape)
        dim_axes = [spec_axes(entries[i]) for i in range(len(spec.shape))]
        used = {a for axes in dim_axes for a in axes}
        n = math.prod(spec.shape)
        # 1. parameter all-gathers over the batch axes the leaf is split on
        g = size([a for a in d_axes if a in used])
        local = n * param_itemsize / size(used)
        if g > 1:
            add("all-gather", passes, passes * local * (g - 1))
        # 2. gradient reductions
        if train:
            glocal = n * grad_itemsize / size(used)
            if g > 1:
                add("reduce-scatter", 1, glocal * (g - 1))
            r = size([a for a in d_axes if a not in used])
            if r > 1:
                add("all-reduce", 1, 2 * glocal * (r - 1) / r)
        # 3. tensor-parallel all-reduces of the output activation
        c_dims = _contraction_dims(spec.axes)
        t = size({a for i in c_dims for a in dim_axes[i]
                  if a not in d_axes})
        if t > 1:
            out_dims = range(max(c_dims) + 1, len(spec.shape))
            width = math.prod(spec.shape[i] / size(dim_axes[i])
                              for i in out_dims)
            apps = math.prod(spec.shape[i] for i, a in enumerate(spec.axes)
                             if a == ax.LAYERS)
            act = tokens(path, spec) * width * act_itemsize
            if act:
                add("all-reduce", passes * apps,
                    passes * apps * 2 * act * (t - 1) / t)
    # 4. split-KV partials of a sequence-sharded cache
    add("all-gather", seq_gathers[0], seq_gathers[0] * seq_gathers[1])
    return out


def _kv_partial_gathers(cfg, cache_specs, cache_sh, mesh) -> Tuple[int, float]:
    """Rule 4 for a decode step: (attention layers, bytes each) when the
    KV cache's sequence axis is split over mesh axes of size > 1."""
    spec = cache_specs.get("k")
    if spec is None or ax.CACHE_SEQ not in spec.axes:
        return 0, 0.0
    entries = tuple(cache_sh["k"].spec) + (None,) * len(spec.shape)

    def split(logical) -> int:
        return _split_over(mesh, entries[spec.axes.index(logical)])

    q = split(ax.CACHE_SEQ)
    if q <= 1:
        return 0, 0.0
    layers = math.prod(spec.shape[i] for i, a in enumerate(spec.axes)
                       if a == ax.LAYERS)
    b_local = spec.shape[spec.axes.index(ax.BATCH)] // split(ax.BATCH)
    kv_local = spec.shape[spec.axes.index(ax.KV_HEADS)] // \
        split(ax.KV_HEADS)
    heads = kv_local * (cfg.num_heads // cfg.num_kv_heads)
    d = spec.shape[spec.axes.index(ax.HEAD_DIM)]
    partial = b_local * heads * 1 * (d + 2) * 4      # one query token
    return layers, partial * (q - 1)


# ---------------------------------------------------------------------------
# The trace: cost and memory
# ---------------------------------------------------------------------------

_NO_TRAFFIC = ("_unsafe_view", "detach", "lift_fresh", "alias")


def _tensors(tree):
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _CostMode(TorchDispatchMode):
    """Counts, over the ops of a trace: ``ops``; ``bytes`` (tensor operands
    and results of every op that writes a tensor and is not a view: a
    metadata query such as ``prim.device`` moves nothing); and the live
    bytes of storages the ops allocated (``live``, ``peak``), each storage
    counted once and released when it is freed."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._held: Dict[int, Any] = {}

    def _release(self, key: int, nbytes: int) -> None:
        self._held.pop(key, None)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        name = func.overloadpacket.__name__
        moves = bool(outs) or func._schema.is_mutable   # not a query
        if moves and not getattr(func, "is_view", False) and \
                name not in _NO_TRAFFIC:
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        known = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in known or key in self._held:
                continue
            nb = st.nbytes()
            self._held[key] = weakref.finalize(st, self._release, key, nb)
            self.live += nb
        self.peak = max(self.peak, self.live)
        return out


def _fake_inputs(args, device: torch.device):
    """``meta`` leaves -> empty tensors of their shapes on ``device`` (fake
    under the active ``FakeTensorMode``); other leaves unchanged."""
    return pytree.tree_map(
        lambda a: torch.empty(a.shape, dtype=a.dtype, device=device)
        if isinstance(a, torch.Tensor) and a.device.type == "meta" else a,
        args)


def trace_cost(fn, args: Sequence[Any], *, chips: int = 1,
               device: DeviceLike = "cuda",
               collectives: Optional[Dict[str, Dict[str, float]]] = None
               ) -> Dict[str, Any]:
    """Trace ``fn(*args)`` on ``FakeTensorMode`` tensors of ``args``' shapes
    (``meta`` leaves) on ``device``; the counterpart of the reference's
    ``analyze_compiled``.  Returns per-device ``flops``,
    ``bytes_accessed``, ``cost``, ``memory`` (``argument_size_in_bytes``,
    ``output_size_in_bytes``, ``temp_size_in_bytes``), ``aten_ops``,
    ``trace_seconds`` and, given the cell's ``collectives`` estimate,
    ``collectives`` and ``collective_bytes_per_device``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    dev = resolve_device(device)
    t0 = time.perf_counter()
    with FakeTensorMode():
        fake = _fake_inputs(tuple(args), dev)
        flop = FlopCounterMode(display=False)
        cost = _CostMode()
        with flop, cost:
            out = fn(*fake)
        out_bytes = sum(_nbytes(t) for t in _tensors(out))
        in_bytes = sum(_nbytes(t) for t in _tensors(fake))
        peak = cost.peak
        del out, fake
    flops = float(flop.get_total_flops())
    rep: Dict[str, Any] = {
        "flops": flops / chips,
        "bytes_accessed": float(cost.bytes) / chips,
        "memory": {"argument_size_in_bytes": in_bytes // chips,
                   "output_size_in_bytes": out_bytes // chips,
                   "temp_size_in_bytes": peak // chips},
        "aten_ops": cost.ops,
        "trace_seconds": round(time.perf_counter() - t0, 2),
    }
    rep["cost"] = {"flops": rep["flops"],
                   "bytes accessed": rep["bytes_accessed"]}
    if collectives is not None:
        rep["collectives"] = collectives
        rep["collective_bytes_per_device"] = float(
            sum(v["bytes"] for v in collectives.values()))
    return rep


# ---------------------------------------------------------------------------
# Cell lowering
# ---------------------------------------------------------------------------


def _tokens_per_weight(cfg, shape: ShapeConfig, b_local: int):
    """Rule 3's tokens per device for the leaf at ``path``: the encoder's
    frames and the vision projector's patches run in training and prefill
    only; expert weights see top_k x the tokens."""
    decode = shape.kind == "decode"
    seq = 1 if decode else shape.seq_len

    def tokens(path: str, spec: cm.ParamSpec) -> int:
        if path.startswith("encoder/"):
            n = 0 if decode else cfg.encoder_seq
        elif path == "mm_proj":
            n = 0 if decode else cfg.vision_tokens
        else:
            n = seq
        if ax.EXPERTS in spec.axes:
            n *= cfg.moe_top_k
        return b_local * n

    return tokens


def lower_shape(
    arch_name: str,
    shape: ShapeConfig,
    mesh,
    *,
    cfg=None,
    train_cfg: Optional[TrainConfig] = None,
    rule_extra: Optional[Dict] = None,
    compile_it: bool = True,
    device: DeviceLike = "cuda",
) -> Dict[str, Any]:
    """``lower_cell`` for a ``ShapeConfig`` that need not be one of the
    arch's shapes, on ``mesh``: ``cfg`` (default the arch's model) and
    ``train_cfg`` (default the arch's) as given."""
    spec = get_arch(arch_name)
    cfg = cfg or spec.model
    train_cfg = train_cfg or spec.train
    rules = make_rules(spec, shape, mesh, rule_extra)
    model = model_zoo.build_model(cfg, impl="plain", max_seq=shape.seq_len)
    specs = model.param_specs()
    chips = math.prod(int(v) for v in mesh.shape.values())
    report: Dict[str, Any] = {
        "arch": arch_name, "shape": shape.name,
        "mesh": dict(mesh.shape), "kind": shape.kind,
        "n_params": cm.count_params(specs),
        "impl": "plain",
    }

    t0 = time.perf_counter()
    train = shape.kind == "train"
    if train:
        state_sds, state_sh = state_shardings(rules, model, train_cfg)
        batch_sds = model_zoo.input_specs(cfg, shape)
        batch_sh = batch_shardings(rules, batch_sds)
        tok_sh = batch_sh["tokens"]
        p_sh = state_sh.params
        fn = make_train_step(model_zoo.make_loss_fn(model), train_cfg)
        args = (state_sds, batch_sds)
        resident = sharded_bytes_per_device(state_sds, state_sh, mesh)
        seq_gathers = (0, 0.0)
    elif shape.kind == "prefill":
        p_sds, p_sh = abstract_tree_bf16(specs), spec_shardings(rules, specs)
        batch_sds = model_zoo.input_specs(cfg, shape)
        batch_sh = batch_shardings(rules, batch_sds)
        tok_sh = batch_sh["tokens"]
        cache_specs = model.cache_specs(shape.global_batch, shape.seq_len)
        c_sds = abstract_tree(cache_specs)
        c_sh = spec_shardings(rules, cache_specs)
        fn = model_zoo.make_prefill_fn(model)
        args = (p_sds, batch_sds, c_sds)
        resident = (sharded_bytes_per_device(p_sds, p_sh, mesh)
                    + sharded_bytes_per_device(c_sds, c_sh, mesh))
        seq_gathers = (0, 0.0)
    else:  # decode
        p_sds, p_sh = abstract_tree_bf16(specs), spec_shardings(rules, specs)
        dec = model_zoo.decode_input_specs(cfg, shape, model)
        cache_specs = model.cache_specs(shape.global_batch, shape.seq_len)
        c_sh = spec_shardings(rules, cache_specs)
        tok_sh = rules.sharding((ax.BATCH, None), tuple(dec["tokens"].shape))
        # the trace is global: the plain attention reads the whole cache;
        # its sequence split shows in the resident bytes and in rule 4
        fn = model_zoo.make_decode_fn(model)
        args = (p_sds, dec["tokens"], dec["cache"], shape.seq_len - 1)
        resident = (sharded_bytes_per_device(p_sds, p_sh, mesh)
                    + sharded_bytes_per_device(dec["cache"], c_sh, mesh))
        seq_gathers = _kv_partial_gathers(cfg, cache_specs, c_sh, mesh)
    report["lower_seconds"] = round(time.perf_counter() - t0, 2)
    report["resident_bytes_per_device"] = int(resident)
    report["resident_gib_per_device"] = round(resident / 2**30, 3)
    report["fallbacks"] = [
        f"{f.tensor} dim{f.dim} {f.logical}->{f.wanted}: {f.reason}"
        for f in rules.fallbacks]

    if compile_it:
        d_axes = spec_axes(tok_sh.spec[0])
        b_local = shape.global_batch // _split_over(mesh, tok_sh.spec[0])
        grad = 2 if train_cfg.grad_compression == "bf16" else 4
        coll = estimate_collectives(
            specs, p_sh, mesh, d_axes, train=train,
            tokens=_tokens_per_weight(cfg, shape, b_local),
            act_itemsize=cm.torch_dtype(cfg.dtype).itemsize,
            param_itemsize=4 if train else 2, grad_itemsize=grad,
            seq_gathers=seq_gathers)
        dev = resolve_device(device)
        report["device"] = str(dev)
        report.update(trace_cost(fn, args, chips=chips, device=dev,
                                 collectives=coll))
        report["traced"] = True
    return report


def lower_cell(
    arch_name: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    mesh=None,
    rule_extra: Optional[Dict] = None,
    train_overrides: Optional[Dict] = None,
    model_overrides: Optional[Dict] = None,
    compile_it: bool = True,
    device: DeviceLike = "cuda",
) -> Dict[str, Any]:
    """Lay out (and trace) one (arch x shape x mesh) cell; returns a report
    dict.  ``mesh`` defaults to ``abstract_mesh(multi_pod=...)``;
    ``compile_it=False`` resolves the layouts and resident bytes only."""
    spec = get_arch(arch_name)
    shape = get_shape(spec, shape_name)
    if shape_name in spec.skip_shapes:
        return {"arch": arch_name, "shape": shape_name,
                "skipped": spec.skip_shapes[shape_name]}
    mesh = mesh or abstract_mesh(multi_pod=multi_pod)
    cfg = spec.model
    if model_overrides:
        cfg = cfg.replace(**model_overrides)
    train_cfg = spec.train
    if train_overrides:
        train_cfg = dataclasses.replace(train_cfg, **train_overrides)
    return lower_shape(arch_name, shape, mesh, cfg=cfg, train_cfg=train_cfg,
                       rule_extra=rule_extra, compile_it=compile_it,
                       device=device)


# ---------------------------------------------------------------------------
# CLI sweep
# ---------------------------------------------------------------------------


def run_sweep(archs, shapes, multi_pod: bool, out_dir: str,
              stop_on_error: bool = False,
              device: DeviceLike = "cuda") -> Dict[str, Any]:
    os.makedirs(out_dir, exist_ok=True)
    mesh = abstract_mesh(multi_pod=multi_pod)
    mesh_tag = "multipod" if multi_pod else "singlepod"
    results = []
    for a in archs:
        spec = get_arch(a)
        for s in shapes:
            if not any(sh.name == s for sh in spec.shapes):
                continue
            tag = f"{a}_{s}_{mesh_tag}"
            print(f"=== {tag} ===", flush=True)
            try:
                rep = lower_cell(a, s, multi_pod=multi_pod, mesh=mesh,
                                 device=device)
            except Exception as e:  # noqa: BLE001  (the sweep reports it)
                rep = {"arch": a, "shape": s, "error": repr(e),
                       "traceback": traceback.format_exc()}
                print(f"FAILED: {e!r}", flush=True)
                if stop_on_error:
                    raise
            results.append(rep)
            with open(os.path.join(out_dir, tag + ".json"), "w") as fh:
                json.dump(rep, fh, indent=1, default=str)
            if "skipped" in rep:
                print(f"skipped: {rep['skipped']}", flush=True)
            elif "error" not in rep:
                print(f"ok: {rep.get('resident_gib_per_device', '?')} GiB/dev, "
                      f"flops={rep.get('flops', 0):.3e}, "
                      f"lower={rep.get('lower_seconds')}s "
                      f"trace={rep.get('trace_seconds')}s", flush=True)
    summary = {
        "mesh": mesh_tag,
        "n_cells": len(results),
        "ok": sum(1 for r in results if r.get("traced")),
        "skipped": sum(1 for r in results if "skipped" in r),
        "failed": sum(1 for r in results if "error" in r),
    }
    with open(os.path.join(out_dir, f"summary_{mesh_tag}.json"), "w") as fh:
        json.dump({"summary": summary, "results": results}, fh, indent=1,
                  default=str)
    print(json.dumps(summary))
    return summary


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--all", action="store_true")
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--out", default="results/dryrun")
    p.add_argument("--stop-on-error", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="the fake tensors' device (cuda, or cpu)")
    args = p.parse_args(argv)

    shapes = [args.shape] if args.shape else list(SHAPES)
    archs = [args.arch] if args.arch else list_archs()
    if not (args.all or args.arch):
        p.error("pass --arch or --all")
    return run_sweep(archs, shapes, args.multi_pod, args.out,
                     args.stop_on_error, device=args.device)


if __name__ == "__main__":
    main()
