"""Train/eval step builders: loss -> grads -> clip -> schedule -> AdamW, with
gradient accumulation and an optional bf16 gradient-compression cast.

The reference's ``repro/training/train_step.py`` in torch.  The returned
step is a pure function (state, batch) -> (new_state, metrics) of tensor
ops that reads nothing on the host, so it is captured into one CUDA graph.
Its gradient path is chosen once, when the step is built:

  * default: ``torch.autograd.grad`` on requires-grad copies of the
    params.  This is the LM step's (``CapturedTrainStep``,
    ``launch/train.py``, the planners): it takes the checkpointed layers
    of ``cfg.remat`` "dots" and "full" (``models/transformer._remat``),
    and it frees each saved activation as the backward pass reads it
    (torch.func differentiates with ``create_graph=True``, which keeps
    them to the end).
  * ``functional=True``: ``torch.func.grad_and_value(loss_fn,
    has_aux=True)``, which composes with ``torch.func.vmap``: the committee
    trainer maps it over the stacked K axis.  A torch.func transform
    cannot take a checkpoint, so a model with ``remat != "none"`` raises
    there; the committee's models keep "none", as the reference's.

The loss is differentiated at fp32 copies of the floating params (a no-op
for fp32 storage): torch's matmul does not promote a bf16 weight against
fp32 inputs as jnp does, and the update math is fp32 either way.

``CapturedTrainStep`` is the counterpart of the reference's
``jax.jit(train_step, donate_argnums=(0,))`` in ``launch/train.py``: on the card one CUDA graph
per batch shape, the new state written into the state's own tensors.
``train_state_from_reference`` carries a reference ``TrainState`` across.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch
import torch.utils._pytree as pytree
from torch.func import grad_and_value

from repro_torch.checkpoint.pytree_ckpt import leaf_from_host, leaf_to_host
from repro_torch.configs.base import TrainConfig
from repro_torch.kernels import graphs
from repro_torch.launch.platform import DeviceLike, resolve_device
from repro_torch.optim.adamw import (
    AdamWConfig, AdamWState, QTensor, adamw_init, adamw_update,
    clip_by_global_norm,
)
from repro_torch.optim.schedule import make_schedule


class TrainState(NamedTuple):
    step: torch.Tensor
    params: Any
    opt: AdamWState


def make_train_state(params: Any, train_cfg: TrainConfig) -> TrainState:
    first = pytree.tree_leaves(params)[0]
    return TrainState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        params=params,
        opt=adamw_init(params, quantized=train_cfg.quantized_opt_state,
                       moments=getattr(train_cfg, "opt_moments", "")),
    )


def _as_fp32(params):
    return pytree.tree_map(
        lambda p: p.to(torch.float32) if p.is_floating_point() else p,
        params)


def _autograd_grad_and_value(loss_fn):
    """``grad_and_value(loss_fn, has_aux=True)`` by ``torch.autograd.grad``:
    the params become fresh requires-grad leaves (detached views, so the
    caller's tensors are not marked); an unused leaf gets zeros, as under
    torch.func; the loss and the metrics come back detached."""
    def grad_fn(params, batch):
        with torch.enable_grad():
            params = pytree.tree_map(lambda p: p.detach().requires_grad_(),
                                     params)
            loss, aux = loss_fn(params, batch)
            leaves, spec = pytree.tree_flatten(params)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        aux = pytree.tree_map(
            lambda t: t.detach() if isinstance(t, torch.Tensor) else t, aux)
        return pytree.tree_unflatten(list(grads), spec), (loss.detach(), aux)

    return grad_fn


def make_train_step(
    loss_fn: Callable[[Any, Dict[str, torch.Tensor]],
                      Tuple[torch.Tensor, Dict]],
    train_cfg: TrainConfig,
    *,
    functional: bool = False,
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Tuple[TrainState, Dict]]:
    """The step of ``loss_fn``; ``functional`` picks the gradient path (see
    the module docstring)."""
    schedule = make_schedule(
        train_cfg.schedule, train_cfg.learning_rate,
        warmup_steps=train_cfg.warmup_steps,
        decay_steps=train_cfg.decay_steps,
        stable_steps=train_cfg.stable_steps,
        min_lr_ratio=train_cfg.min_lr_ratio,
    )
    adam_cfg = AdamWConfig(
        beta1=train_cfg.beta1, beta2=train_cfg.beta2, eps=train_cfg.eps,
        weight_decay=train_cfg.weight_decay,
        quantized=train_cfg.quantized_opt_state,
        moments=getattr(train_cfg, "opt_moments", ""),
    )
    grad_fn = (grad_and_value(loss_fn, has_aux=True) if functional
               else _autograd_grad_and_value(loss_fn))
    accum = max(1, train_cfg.accum_steps)

    def compute_grads(params, batch):
        params = _as_fp32(params)
        if accum == 1:
            grads, (loss, metrics) = grad_fn(params, batch)
        else:
            # microbatches over the leading batch dim, summed in order
            grads, loss = None, None
            for i in range(accum):
                mb = pytree.tree_map(
                    lambda x: x[i * (x.shape[0] // accum):
                                (i + 1) * (x.shape[0] // accum)], batch)
                g, (l, _) = grad_fn(params, mb)
                grads = g if grads is None else pytree.tree_map(
                    torch.add, grads, g)
                loss = l if loss is None else loss + l
            grads = pytree.tree_map(lambda g: g / accum, grads)
            loss = loss / accum
            metrics = {}
        if train_cfg.grad_compression == "bf16":
            # the cast at the cross-replica reduction point (half the
            # all-reduce bytes under data parallelism)
            grads = pytree.tree_map(lambda g: g.to(torch.bfloat16), grads)
        return loss, metrics, grads

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        loss, metrics, grads = compute_grads(state.params, batch)
        grads, gnorm = clip_by_global_norm(grads, train_cfg.grad_clip_norm)
        lr = schedule(state.step)
        new_params, new_opt = adamw_update(grads, state.opt, state.params,
                                           lr, adam_cfg)
        metrics = dict(metrics)
        metrics.update({"loss": loss, "grad_norm": gnorm, "lr": lr})
        return TrainState(state.step + 1, new_params, new_opt), metrics

    return train_step


def make_eval_step(loss_fn):
    def eval_step(params, batch):
        loss, metrics = loss_fn(params, batch)
        return metrics

    return eval_step


# ---------------------------------------------------------------------------
# The reference's state, and the state in place
# ---------------------------------------------------------------------------


def _is_qtensor(t) -> bool:
    return all(hasattr(t, a) for a in ("q", "scale", "block", "axis"))


def _map_state(fn, tree):
    """``fn`` at every array leaf of a (reference or port) ``TrainState``,
    rebuilt as the port's ``TrainState`` / ``AdamWState`` / ``QTensor``."""
    def walk(t):
        if _is_qtensor(t):
            return QTensor(walk(t.q), walk(t.scale), int(t.block),
                           int(t.axis))
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(x) for x in t)
        return fn(t)

    return TrainState(step=walk(tree.step), params=walk(tree.params),
                      opt=AdamWState(step=walk(tree.opt.step),
                                     mu=walk(tree.opt.mu),
                                     nu=walk(tree.opt.nu)))


def train_state_from_reference(tree, device: DeviceLike = None) -> TrainState:
    """The reference's ``TrainState`` (jax or numpy leaves; AdamW moments in
    each format its ``adamw_init`` makes: fp32, ml_dtypes bfloat16, or
    ``QTensor`` with ``q``/``scale``/``block``/``axis``) -> the port's
    ``TrainState`` on ``device`` (default: the CUDA device), bit for bit.
    Dict keys keep the reference's order."""
    dev = resolve_device(device)
    return _map_state(lambda a: leaf_from_host(leaf_to_host(a), dev), tree)


def train_state_to_reference(state: TrainState) -> TrainState:
    """The inverse, on the host: the same tree with numpy leaves (bf16 as
    ``BF16Bits``), from which the reference's ``TrainState`` is rebuilt."""
    return _map_state(leaf_to_host, state)


# ---------------------------------------------------------------------------
# One captured step per batch shape
# ---------------------------------------------------------------------------


class _Graph(NamedTuple):
    graph: Any
    batch: Dict[str, torch.Tensor]        # the graph's static inputs
    metrics: Dict[str, torch.Tensor]      # its static outputs


class CapturedTrainStep:
    """``make_train_step`` run in place on a state it owns.

    ``step(batch)`` computes the step and writes the new state into the
    tensors of ``self.state`` (``torch._foreach_copy_``): what donation
    gives the reference's jitted step, and what lets a CUDA graph replay on
    fixed addresses.  On the card the first batch of each shape (keys,
    shapes, dtypes) is copied into static buffers, the pure step runs twice
    as a warm-up (kernel and cuBLAS initialisation, and any host-built
    constant a model caches, may not happen under capture), and the step
    is captured on the step's own stream (``kernels.graphs.capture``);
    every later batch of that shape is one copy into the buffers and one
    ``graph.replay()``.  ``capture=False`` runs the same program eagerly;
    on the CPU it always runs eagerly.

    Each call orders the step's stream after the caller's, and the
    caller's after the step, so a checkpoint, a metric read or
    ``load_state_`` on the caller's stream sees whole steps.  The metrics
    (``loss``, ``grad_norm``, ``lr`` and the loss's own, such as
    ``moe_aux``) stay on the device; a captured step returns the graph's
    output tensors, overwritten by the next replay.

    Counters: ``captures`` (one per batch shape), ``replays``.
    """

    def __init__(self, loss_fn, train_cfg: TrainConfig, state: TrainState,
                 *, capture: bool = True):
        self.state = state
        self.device = state.step.device
        self._step = make_train_step(loss_fn, train_cfg)
        self._spec = pytree.tree_structure(state)
        cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        self.capture = bool(capture) and cuda
        self._graphs: Dict[Any, _Graph] = {}
        self.captures = 0
        self.replays = 0

    def _program(self, batch) -> Dict[str, torch.Tensor]:
        new_state, metrics = self._step(self.state, batch)
        if pytree.tree_structure(new_state) != self._spec:
            raise ValueError("the step returned a state of another "
                             "structure than the one it was given")
        torch._foreach_copy_(pytree.tree_leaves(self.state),
                             pytree.tree_leaves(new_state))
        return metrics

    def _capture(self, bufs) -> _Graph:
        def warmup():
            for _ in range(2):
                self._step(self.state, bufs)

        (graph,), (metrics,), _ = graphs.capture(
            [lambda: self._program(bufs)], self._stream, warmup=warmup)
        self.captures += 1
        return _Graph(graph, bufs, metrics)

    def __call__(self, batch: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        """One step on ``batch`` (tensors on the host, pinned for an
        asynchronous copy, or on the device)."""
        if self._stream is None:
            return self._program(batch)
        caller = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(caller)
        with torch.cuda.stream(self._stream):
            if not self.capture:
                bufs = {k: v.to(self.device, non_blocking=True)
                        for k, v in batch.items()}
                metrics = self._program(bufs)
            else:
                key = tuple((k, tuple(v.shape), v.dtype)
                            for k, v in sorted(batch.items()))
                entry = self._graphs.get(key)
                bufs = entry.batch if entry is not None else {
                    k: torch.empty(tuple(v.shape), dtype=v.dtype,
                                   device=self.device)
                    for k, v in batch.items()}
                for k, v in batch.items():
                    bufs[k].copy_(v, non_blocking=True)
                if entry is None:
                    entry = self._graphs[key] = self._capture(bufs)
                entry.graph.replay()
                self.replays += 1
                metrics = entry.metrics
        caller.wait_stream(self._stream)
        return metrics

    def load_state_(self, snap) -> None:
        """Restore ``snap`` (a checkpoint's host tree, or a state on any
        device) into the step's state tensors in place, by key, on the
        caller's stream (the next step is ordered after it); a captured
        graph keeps its addresses.  Raises ``ValueError`` on another
        structure, shape or dtype."""
        def walk(dst, src, path):
            if isinstance(dst, QTensor):
                if not _is_qtensor(src) or (int(src.block),
                                            int(src.axis)) != (dst.block,
                                                               dst.axis):
                    raise ValueError(f"state {path}: quantized moment "
                                     f"layout")
                walk(dst.q, src.q, path + "/q")
                walk(dst.scale, src.scale, path + "/scale")
            elif isinstance(dst, dict):
                if not isinstance(src, dict) or set(src) != set(dst):
                    raise ValueError(f"state {path}: keys differ")
                for k in dst:
                    walk(dst[k], src[k], f"{path}/{k}")
            elif isinstance(dst, (list, tuple)):
                if not isinstance(src, (list, tuple)) or len(src) != len(dst):
                    raise ValueError(f"state {path}: sequence differs")
                for i, (d, s) in enumerate(zip(dst, src)):
                    walk(d, s, f"{path}/{i}")
            else:
                t = src if isinstance(src, torch.Tensor) else \
                    leaf_from_host(leaf_to_host(src), "cpu")
                if tuple(t.shape) != tuple(dst.shape) or t.dtype != dst.dtype:
                    raise ValueError(f"state {path}: {tuple(t.shape)} "
                                     f"{t.dtype} vs {tuple(dst.shape)} "
                                     f"{dst.dtype}")
                dst.copy_(t)

        walk(tuple(self.state), tuple(snap), "")
