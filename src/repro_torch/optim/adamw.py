"""AdamW with optional int8 block-quantized or bf16 moments.

The reference's ``repro/optim/adamw.py`` in torch ops, with its numerics:

* int8 moments: per-block (up to 128 along one dim) absmax quantization
  with fp32 scales; the second moment is stored as ``sqrt(nu)`` (the update
  only consumes ``sqrt(vhat)``, so int8 error enters the denominator
  linearly); rounding is half to even (``torch.round``, as ``jnp.round``);
* bf16 moments store ``mu`` and ``nu`` directly;
* all update math is fp32 whatever the storage, and the bias corrections
  are ``b ** step`` in fp32.

State is a tree shaped like the params.  ``QTensor`` is a registered
pytree node whose ``block`` and ``axis`` are static context, not leaves, so
``torch.func.vmap`` maps a stacked committee of quantized moments (leading
K axis on ``q`` and ``scale``; ``block`` and ``axis`` refer to one member's
shape, as in the reference's stacked state).  Every function is tensor ops
only — no value is read on the host — so the committee trainer captures the
update into its CUDA graph.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.utils._pytree as pytree

BLOCK = 128


# ---------------------------------------------------------------------------
# int8 blockwise quantization
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class QTensor:
    """int8 ``q`` of the source's shape and fp32 ``scale`` (the blocked dim
    divided by ``block``); ``block`` and ``axis`` are static ints."""

    q: Any
    scale: Any
    block: int
    axis: int


pytree.register_pytree_node(
    QTensor,
    lambda t: ((t.q, t.scale), (t.block, t.axis)),
    lambda ch, aux: QTensor(ch[0], ch[1], aux[0], aux[1]),
    serialized_type_name="repro_torch.optim.adamw.QTensor",
)


def _block_for(n: int) -> int:
    b = min(BLOCK, n)
    while n % b:
        b -= 1
    return b


def _pick_axis(shape) -> int:
    """The blocked dim: prefer one whose post-blocking quotient stays
    16-divisible (the reference's sharding-friendly choice); prefer the last
    on ties."""
    best, best_score = len(shape) - 1, -1
    for d in range(len(shape) - 1, -1, -1):
        n = shape[d]
        b = _block_for(n)
        score = 0
        if b >= 16:
            score += 1
        if (n // b) % 16 == 0 or n // b == 1:
            score += 2
        if score > best_score:
            best, best_score = d, score
    return best


def quantize(x: torch.Tensor, axis: Optional[int] = None) -> QTensor:
    """Shape-preserving per-block absmax int8 quantization along one dim."""
    if x.ndim == 0:
        t = quantize(x[None], axis=0)
        return QTensor(t.q[0], t.scale[0], t.block, 0)
    ax_ = _pick_axis(tuple(x.shape)) if axis is None else axis
    n = x.shape[ax_]
    b = _block_for(n)
    xm = torch.movedim(x.to(torch.float32), ax_, -1)
    xr = xm.reshape(*xm.shape[:-1], n // b, b)
    scale = torch.amax(torch.abs(xr), dim=-1) / 127.0
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(xr / safe[..., None]), -127, 127)
    q = torch.movedim(q.reshape(xm.shape), -1, ax_).to(torch.int8)
    scale = torch.movedim(scale, -1, ax_)   # blocked dim now n//b, in place
    return QTensor(q, scale, b, ax_)


def dequantize(t: QTensor) -> torch.Tensor:
    shape = tuple(t.q.shape)
    if len(shape) == 0:
        return t.q.to(torch.float32) * t.scale
    n = shape[t.axis]
    qm = torch.movedim(t.q.to(torch.float32), t.axis, -1)
    sm = torch.movedim(t.scale, t.axis, -1)
    xr = qm.reshape(*qm.shape[:-1], n // t.block, t.block) * sm[..., None]
    return torch.movedim(xr.reshape(qm.shape), -1, t.axis)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


MOMENT_FORMATS = ("fp32", "bf16", "int8")


def resolve_moments(moments: str = "", quantized: bool = False) -> str:
    """Moment storage format: an explicit ``moments`` wins; the legacy
    ``quantized`` boolean maps to ``int8``; default ``fp32``."""
    m = moments or ("int8" if quantized else "fp32")
    if m not in MOMENT_FORMATS:
        raise ValueError(f"unknown moment format {m!r}; expected one of "
                         f"{MOMENT_FORMATS}")
    return m


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    quantized: bool = False          # legacy alias for moments="int8"
    moments: str = ""                # "" | fp32 | bf16 | int8

    def moment_format(self) -> str:
        return resolve_moments(self.moments, self.quantized)


def _zip_map(fn, g, *rest):
    """``fn`` at every leaf of ``g`` with the matching subtrees of ``rest``
    (whole ``QTensor`` moments at a leaf of ``g``)."""
    if isinstance(g, dict):
        return {k: _zip_map(fn, g[k], *(r[k] for r in rest)) for k in g}
    if isinstance(g, (list, tuple)):
        return type(g)(_zip_map(fn, *xs) for xs in zip(g, *rest))
    return fn(g, *rest)


def _pick(tree, i, like):
    """The ``i``-th entry of every leaf tuple of ``tree`` (shaped as
    ``like``)."""
    if isinstance(like, dict):
        return {k: _pick(tree[k], i, like[k]) for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_pick(t, i, l) for t, l in zip(tree, like))
    return tree[i]


def adamw_init(params: Any, quantized: bool = False,
               moments: str = "") -> AdamWState:
    fmt = resolve_moments(moments, quantized)
    first = pytree.tree_leaves(params)[0]

    def zero(p):
        z = torch.zeros(tuple(p.shape), dtype=torch.float32, device=p.device)
        if fmt == "int8":
            return quantize(z)
        if fmt == "bf16":
            return z.to(torch.bfloat16)
        return z

    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        mu=_zip_map(zero, params),
        nu=_zip_map(zero, params),
    )


def global_norm(tree: Any) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(torch.float32)))
              for x in pytree.tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads: Any, max_norm: float):
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return (pytree.tree_map(lambda g: g.to(torch.float32) * scale, grads),
            gn)


def adamw_update(
    grads: Any,
    state: AdamWState,
    params: Any,
    lr: torch.Tensor,
    cfg: AdamWConfig = AdamWConfig(),
) -> Tuple[Any, AdamWState]:
    """Returns (new_params, new_state).  Math in fp32 regardless of storage."""
    step = state.step + 1
    b1, b2 = cfg.beta1, cfg.beta2
    c1 = 1.0 - torch.pow(b1, step.to(torch.float32))
    c2 = 1.0 - torch.pow(b2, step.to(torch.float32))
    fmt = cfg.moment_format()

    def upd(g, m, v, p):
        g = g.to(torch.float32)
        if fmt == "int8":
            mf = dequantize(m)
            vf = dequantize(v) ** 2          # nu is stored as sqrt(nu)
        else:
            mf = m.to(torch.float32)
            vf = v.to(torch.float32)
        mf = b1 * mf + (1 - b1) * g
        vf = b2 * vf + (1 - b2) * g * g
        mhat = mf / c1
        vhat = vf / c2
        pf = p.to(torch.float32)
        new_p = pf - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                           + cfg.weight_decay * pf)
        if fmt == "int8":
            mf, vf = quantize(mf), quantize(torch.sqrt(vf))
        elif fmt == "bf16":
            mf, vf = mf.to(torch.bfloat16), vf.to(torch.bfloat16)
        return new_p.to(p.dtype), mf, vf

    out = _zip_map(upd, grads, state.mu, state.nu, params)
    return (_pick(out, 0, grads),
            AdamWState(step=step, mu=_pick(out, 1, grads),
                       nu=_pick(out, 2, grads)))
