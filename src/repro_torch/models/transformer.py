"""Dense decoder-only transformer (GQA, optional SWA / qk-norm / tied embed).

The backbone of llama3.2-1b, minicpm-2b, h2o-danube-3-4b and
mistral-nemo-12b, ported from ``repro/models/transformer.py``.  Functional
style: ``param_specs(cfg)`` builds a ParamSpec tree and ``DenseLM`` consumes
the materialized tree, in the reference's layout and keys (``wq``/``wk``/
``wv`` are (D, heads, hd), ``wo`` is (H, hd, D); every product is a 2-D
matmul on reshaped weights, never a transpose of a stored one).  Weights
are cast to the activation dtype at each product, as the reference's
``p["wq"].astype(h.dtype)``; ``DenseLM.compute_params`` does that cast
once ahead, which gives the same bits.

Layers are stacked on a leading axis (as the reference's scanned layers);
``scan_stack``, a Python loop over per-layer views, takes the place of
``jax.lax.scan``.  ``_remat`` is the reference's remat policy
(``cfg.remat``), each layer of ``forward`` a
``torch.utils.checkpoint.checkpoint`` when autograd will use what it
saves: "none" keeps every activation the backward pass reads; "full"
keeps only the layer's input and recomputes the layer; "dots" keeps what
``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims`` keeps, the
outputs of the products with no batch dims (the weight projections) and
recomputes the rest (the attention's batched products, softmax, norms,
activations).  Every product with no batch dims in the reference's
einsums is a 2-D ``aten.mm`` here (``_proj``), and every product with
batch dims a ``torch.einsum`` (``aten.bmm``), so the policy saves
``aten.mm`` and nothing else.  The reference's sharding hints have no
counterpart on one card.

The KV cache is updated IN PLACE: one (L, B, max_seq, KV, hd) tensor each
for ``k`` and ``v``; layer ``i`` writes its rows ``[:, index:index+T]``
of its slice, and ``prefill`` / ``decode_step`` return the same dict they
were given.  The reference's functional ``dynamic_update_slice`` returns a
new cache; here nothing is copied.

A decode step's ``index`` is a host int, or a 0-dim integer tensor on the
model's device, as the reference's jitted step takes a traced int32: then
the positions are ``index + arange(T)``, the cache rows are written by
``index_copy_``, ``kv_len`` is ``index + T`` and the attention's offset
stays on the device, so a captured CUDA graph of the step replays at any
position and the step reads nothing back to the host.  The range check of
such an index is the caller's (``ServeEngine.generate`` knows every
position ahead).

``impl``: "auto" runs ``ops.attention``, which follows the tensors' device
(the CUDA kernel on the card, the plain version on the CPU); "plain" runs
the plain version on any device — only tests and ``chip_smoke.py`` set it,
to hold the kernel path against the plain one on the card.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.utils._pytree as pytree
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
    noop_context_fn,
)

from repro_torch.configs import base as ax
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.launch.platform import DeviceLike, resolve_device
from repro_torch.models import common as cm
from repro_torch.models.common import ParamSpec

Params = Dict[str, Any]
IMPLS = ("auto", "plain")
REMAT_MODES = ("none", "dots", "full")
# leaves the model casts to the activation dtype before use (norm weights
# are read in fp32 and stay as they are)
MATMUL_KEYS = ("wq", "wk", "wv", "wo", "wi", "wg", "embedding", "lm_head")


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------


def attn_specs(cfg: ModelConfig) -> Params:
    D, H, KV, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    s: Params = {
        "ln": ParamSpec((D,), (ax.EMBED,), init="ones"),
        "wq": ParamSpec((D, H, hd), (ax.EMBED, ax.HEADS, ax.HEAD_DIM)),
        "wk": ParamSpec((D, KV, hd), (ax.EMBED, ax.KV_HEADS, ax.HEAD_DIM)),
        "wv": ParamSpec((D, KV, hd), (ax.EMBED, ax.KV_HEADS, ax.HEAD_DIM)),
        "wo": ParamSpec((H, hd, D), (ax.HEADS, ax.HEAD_DIM, ax.EMBED)),
    }
    if cfg.qk_norm:
        s["q_norm"] = ParamSpec((hd,), (ax.HEAD_DIM,), init="ones")
        s["k_norm"] = ParamSpec((hd,), (ax.HEAD_DIM,), init="ones")
    return s


def mlp_specs(cfg: ModelConfig, d_ff: Optional[int] = None) -> Params:
    D = cfg.d_model
    F = d_ff if d_ff is not None else cfg.d_ff
    return {
        "ln": ParamSpec((D,), (ax.EMBED,), init="ones"),
        "wi": ParamSpec((D, F), (ax.EMBED, ax.MLP)),
        "wg": ParamSpec((D, F), (ax.EMBED, ax.MLP)),
        "wo": ParamSpec((F, D), (ax.MLP, ax.EMBED)),
    }


def layer_specs(cfg: ModelConfig) -> Params:
    return {"attn": attn_specs(cfg), "mlp": mlp_specs(cfg)}


def embed_specs(cfg: ModelConfig) -> Params:
    V, D = cfg.padded_vocab, cfg.d_model
    s: Params = {
        "embedding": ParamSpec((V, D), (ax.VOCAB, ax.EMBED), scale=1.0),
        "final_ln": ParamSpec((D,), (ax.EMBED,), init="ones"),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = ParamSpec((D, V), (ax.EMBED, ax.VOCAB))
    return s


def param_specs(cfg: ModelConfig) -> Params:
    return {
        "layers": cm.stack_tree(layer_specs(cfg), cfg.num_layers),
        **embed_specs(cfg),
    }


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, *out) -> (..., *out), in x's dtype."""
    w = w.to(x.dtype)
    K = x.shape[-1]
    out = x.reshape(-1, K) @ w.reshape(K, -1)
    return out.reshape(*x.shape[:-1], *w.shape[1:])


def _attend(q, k, v, impl: str, kv_seq_shard: bool = False,
            **kw) -> torch.Tensor:
    if impl == "plain" and not kv_seq_shard:
        return ops.plain_attention(q, k, v, **kw)
    return ops.attention(q, k, v, kv_seq_shard=kv_seq_shard, **kw)


def attention_block(
    p: Params,
    x: torch.Tensor,                   # (B, T, D)
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,           # (T,) or (B, T)
    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (B,S,KV,hd)
    index=None,                        # write offset (decode): decode_index
    impl: str = "auto",
    kv_seq_shard: bool = False,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
):
    """Pre-norm attention block.  Returns (out, cache); the cache views
    are written in place.  ``rope``: the (cos, sin) tables of
    ``positions`` when the caller computed them once for every layer."""
    B, T, D = x.shape
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    h = cm.rms_norm(x, p["ln"], cfg.norm_eps)
    q = _proj(h, p["wq"])
    k = _proj(h, p["wk"])
    v = _proj(h, p["wv"])
    if cfg.qk_norm:
        q = cm.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = cm.rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.rope_theta:
        cos, sin = rope if rope is not None else cm.rope_tables(
            positions, hd, cfg.rope_theta)
        q = cm.apply_rope(q, cos, sin)
        k = cm.apply_rope(k, cos, sin)

    if cache is not None:
        ck, cv = cache
        if isinstance(index, torch.Tensor):  # decode, position on device
            rows = index + torch.arange(T, device=x.device)
            ck.index_copy_(1, rows, k.to(ck.dtype))
            cv.index_copy_(1, rows, v.to(cv.dtype))
            kv_len = (index + T).to(torch.int32).repeat(B)
        elif index is not None:  # decode: write T new tokens at `index`
            ck[:, index:index + T] = k.to(ck.dtype)
            cv[:, index:index + T] = v.to(cv.dtype)
            kv_len = torch.full((B,), index + T, dtype=torch.int32,
                                device=x.device)
        if index is not None:
            o = _attend(q, ck, cv, impl, causal=False,
                        window=cfg.sliding_window, q_offset=index,
                        kv_len=kv_len, kv_seq_shard=kv_seq_shard)
        else:  # prefill: write at 0, causal within
            ck[:, :T] = k.to(ck.dtype)
            cv[:, :T] = v.to(cv.dtype)
            o = _attend(q, k, v, impl, causal=True,
                        window=cfg.sliding_window)
    else:
        o = _attend(q, k, v, impl, causal=True, window=cfg.sliding_window)
    out = _proj(o.reshape(B, T, H * hd),
                p["wo"].reshape(H * hd, D))
    return out, cache


def mlp_block(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = cm.rms_norm(x, p["ln"], cfg.norm_eps)
    act = cm.activation(cfg.act)
    g = _proj(h, p["wg"])
    u = _proj(h, p["wi"])
    return _proj(act(g) * u, p["wo"])


def dense_layer(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                positions, cache=None, index=None, impl="auto",
                kv_seq_shard=False, rope=None):
    a, new_cache = attention_block(
        p["attn"], x, cfg, positions=positions, cache=cache, index=index,
        impl=impl, kv_seq_shard=kv_seq_shard, rope=rope)
    x = x + a
    x = x + mlp_block(p["mlp"], x, cfg)
    return x, new_cache


def decode_index(index):
    """A decode step's position as the model takes it: a host int, or a
    0-dim integer tensor kept on the device (never read on the host)."""
    if isinstance(index, torch.Tensor):
        if index.dim() != 0 or index.dtype.is_floating_point:
            raise ValueError(f"a decode index tensor must be a 0-dim "
                             f"integer tensor, got {index.dtype} "
                             f"{tuple(index.shape)}")
        return index
    return int(index)


def layer_params(params: Params, num_layers: int,
                 key: str = "layers") -> List[Params]:
    """Per-layer views of the stacked ``params[key]`` (or the list as it
    is, when a caller split the stack once ahead)."""
    layers = params[key]
    if isinstance(layers, (list, tuple)):
        return list(layers)

    def take(tree, i):
        if isinstance(tree, dict):
            return {k: take(v, i) for k, v in tree.items()}
        return tree[i]

    return [take(layers, i) for i in range(num_layers)]


# ---------------------------------------------------------------------------
# Scan-over-layers helpers (shared by all families)
# ---------------------------------------------------------------------------

# the ops whose outputs "dots" saves: the products with no batch dims
NO_BATCH_PRODUCTS = (torch.ops.aten.mm.default,)


def dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """The selective-checkpoint policy of ``remat="dots"``."""
    if op in NO_BATCH_PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn: Callable, mode: str) -> Callable:
    """``fn`` under the remat policy ``mode`` (see the module docstring).
    The checkpoint is taken only when autograd will read what it saves
    (grad mode on and a tensor among the arguments that requires grad);
    otherwise ``fn`` runs as it is, as ``jax.checkpoint`` is the identity
    outside a gradient.  A checkpoint under a ``torch.func`` transform
    raises: torch.func cannot take its saved-tensor hooks, and dropping
    the checkpoint would change what the step keeps."""
    if mode not in REMAT_MODES:
        raise ValueError(f"remat must be one of {REMAT_MODES}, got {mode!r}")
    if mode == "none":
        return fn
    context_fn = (functools.partial(create_selective_checkpoint_contexts,
                                    dots_policy)
                  if mode == "dots" else noop_context_fn)

    @functools.wraps(fn)
    def layer(*args):
        if not (torch.is_grad_enabled() and any(
                isinstance(t, torch.Tensor) and t.requires_grad
                for t in pytree.tree_leaves(args))):
            return fn(*args)
        if torch._C._are_functorch_transforms_active():
            raise RuntimeError(
                f"remat={mode!r} checkpoints each layer, and a torch.func "
                f"transform cannot take a checkpoint; build the model with "
                f"remat='none' to run it under torch.func, or take its "
                f"gradient with torch.autograd.grad (make_train_step's "
                f"default)")
        # no layer draws random numbers, and JAX's checkpoint carries no
        # RNG state
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, context_fn=context_fn)

    return layer


def scan_stack(layer_fn: Callable, layers: List[Params], x, *,
               remat: str = "none"):
    """x' = layer_fn(params_i, x) folded over the per-layer views
    ``layers``, each layer under ``_remat(layer_fn, remat)``; ``x`` may be
    a tuple carry.  The reference's ``scan=True`` has no counterpart."""
    f = _remat(layer_fn, remat)
    for pl in layers:
        x = f(pl, x)
    return x


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


def unembed(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = cm.rms_norm(x, p["final_ln"], cfg.norm_eps)
    if cfg.tie_embeddings:
        # x @ embedding.T over the padded vocab, in the activation dtype
        B, T, D = x.shape
        logits = (x.reshape(B * T, D) @ p["embedding"].to(x.dtype).T
                  ).reshape(B, T, -1)
    else:
        logits = _proj(x, p["lm_head"])
    return cm.softcap(logits, cfg.logit_softcap)


def embed(p: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return cm.take_embedding(p["embedding"], tokens).to(
        cm.torch_dtype(cfg.dtype))


@dataclasses.dataclass
class DenseLM:
    """Decoder-only dense LM (see the module docstring for ``impl``)."""

    cfg: ModelConfig
    impl: str = "auto"
    # leaves ``compute_params`` casts to the activation dtype (a class
    # attribute, not a field)
    cast_keys = MATMUL_KEYS

    def __post_init__(self):
        if self.impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got "
                             f"{self.impl!r}")

    # ------------------------------------------------------------- specs
    def param_specs(self) -> Params:
        return param_specs(self.cfg)

    def init(self, generator: torch.Generator,
             device: DeviceLike = None) -> Params:
        """Random parameters drawn from ``generator`` (on its device; pass
        a CUDA generator for a full-width model), placed on ``device``
        (default: the CUDA device; raises without it)."""
        dev = resolve_device(device)
        return cm.init_params(self.param_specs(), generator, device=dev)

    def _layers(self, params: Params) -> List[Params]:
        return layer_params(params, self.cfg.num_layers)

    def _stacks(self, params: Params) -> Dict[str, List[Params]]:
        """The stacked layer trees of ``params``, each split into per-layer
        views (``compute_params`` keeps them split)."""
        return {"layers": self._layers(params)}

    def _rope(self, positions: torch.Tensor):
        """The rotary tables of one step, shared by every layer."""
        cfg = self.cfg
        if not cfg.rope_theta:
            return None
        return cm.rope_tables(positions, cfg.resolved_head_dim,
                              cfg.rope_theta)

    def compute_params(self, params: Params) -> Params:
        """The tree a server keeps: every leaf the model casts to the
        activation dtype (``cast_keys``) cast once ahead, norm weights
        left as they are, and each layer stack (``_stacks``) split into
        per-layer views.  The model's per-product casts then do nothing,
        and the bits are those of casting at each product."""
        dt = cm.torch_dtype(self.cfg.dtype)
        keys = self.cast_keys

        def cast(tree):
            return {k: (cast(v) if isinstance(v, dict)
                        else v.to(dt) if k in keys else v)
                    for k, v in tree.items()}

        stacks = self._stacks(params)
        out = cast({k: v for k, v in params.items() if k not in stacks})
        for key, layers in stacks.items():
            out[key] = [cast(pl) for pl in layers]
        return out

    # ------------------------------------------------------------- forward
    def _layer_fn(self, positions: torch.Tensor):
        """One layer of ``forward``, ``fn(params_i, x) -> x``."""
        cfg, impl, rope = self.cfg, self.impl, self._rope(positions)

        def fn(pl, x):
            y, _ = dense_layer(pl, x, cfg, positions=positions, impl=impl,
                               rope=rope)
            return y

        return fn

    def forward(self, params: Params,
                batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        tokens = batch["tokens"]
        x = embed(params, tokens, cfg)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
        x = scan_stack(self._layer_fn(positions), self._layers(params), x,
                       remat=cfg.remat)
        return unembed(params, x, cfg)

    # ------------------------------------------------------------- serving
    def cache_specs(self, batch: int, max_seq: int) -> Params:
        cfg = self.cfg
        kv_axes = (ax.LAYERS, ax.BATCH, ax.CACHE_SEQ, ax.KV_HEADS,
                   ax.HEAD_DIM)
        shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        dt = cm.torch_dtype(cfg.dtype)
        return {"k": ParamSpec(shape, kv_axes, init="zeros", dtype=dt),
                "v": ParamSpec(shape, kv_axes, init="zeros", dtype=dt)}

    def init_cache(self, batch: int, max_seq: int,
                   device: DeviceLike = None) -> Params:
        """Zeroed KV cache on ``device`` (default: the CUDA device)."""
        dev = resolve_device(device)
        return {k: torch.zeros(s.shape, dtype=s.dtype, device=dev)
                for k, s in self.cache_specs(batch, max_seq).items()}

    def prefill(self, params: Params, tokens: torch.Tensor, cache: Params):
        """Fill the cache with T prompt tokens; return (last_logits, cache)."""
        cfg = self.cfg
        x = embed(params, tokens, cfg)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
        rope = self._rope(positions)
        for i, pl in enumerate(self._layers(params)):
            x, _ = dense_layer(pl, x, cfg, positions=positions,
                               cache=(cache["k"][i], cache["v"][i]),
                               impl=self.impl, rope=rope)
        logits = unembed(params, x[:, -1:, :], cfg)
        return logits[:, 0, :], cache

    def decode_step(self, params: Params, tokens: torch.Tensor,
                    cache: Params, index, *, kv_seq_shard: bool = False):
        """One decode step: tokens (B, T) written at ``index`` (a host int
        or a 0-dim integer tensor on the device, ``decode_index``); the
        step adds no host sync either way."""
        cfg = self.cfg
        index = decode_index(index)
        x = embed(params, tokens, cfg)
        positions = index + torch.arange(tokens.shape[1], dtype=torch.int32,
                                         device=tokens.device)
        rope = self._rope(positions)
        for i, pl in enumerate(self._layers(params)):
            x, _ = dense_layer(pl, x, cfg, positions=positions,
                               cache=(cache["k"][i], cache["v"][i]),
                               index=index, impl=self.impl,
                               kv_seq_shard=kv_seq_shard, rope=rope)
        logits = unembed(params, x, cfg)
        return logits[:, -1, :], cache


# ---------------------------------------------------------------------------
# Loss (shared by the whole zoo)
# ---------------------------------------------------------------------------


def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor] = None, z_loss_coef: float = 0.0):
    """Next-token cross entropy in fp32.  labels: (B, T) int; -1 = ignore.
    Returns (loss, metrics) with ``nll``, ``tokens`` and, when
    ``z_loss_coef`` is set, ``z_loss``."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.clamp_min(0).to(torch.int64)[..., None]
                      )[..., 0]
    nll = lse - ll
    valid = labels >= 0
    if mask is not None:
        valid = valid & (mask > 0)
    w = valid.to(torch.float32)
    denom = torch.clamp_min(w.sum(), 1.0)
    loss = (nll * w).sum() / denom
    metrics = {"nll": loss, "tokens": w.sum()}
    if z_loss_coef:
        zl = z_loss_coef * ((lse * w) ** 2).sum() / denom
        loss = loss + zl
        metrics["z_loss"] = zl
    return loss, metrics
