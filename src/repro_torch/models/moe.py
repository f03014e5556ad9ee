"""Mixture-of-Experts LM (qwen2-moe-a2.7b, qwen3-moe-235b-a22b) and its
capacity-factor FFN, ported from ``repro/models/moe.py`` (Jamba's MoE
layers run the same ``moe_ffn``).

GShard/Switch-style routing as dense one-hot products over fixed shapes:
tokens are grouped (``moe_group_size``), each group builds a (S, E, C)
dispatch/combine tensor from each token's queue position inside each
expert, tokens past an expert's capacity C are dropped, and the experts
run as one batched product.  The router runs in fp32 on fp32 activations;
the expert weights are cast to the activation dtype at use.

Two places where PyTorch's primitives differ from JAX's are written out:
``jax.lax.top_k`` breaks ties by the lower index (a stable descending sort
here; ``torch.topk`` promises no order), and ``jax.nn.one_hot`` gives an
all-zero row for a position past the capacity (``F.one_hot`` raises; a
comparison against ``arange(C)`` here).

``MoELM`` is ``DenseLM`` with every FFN an MoE FFN: the attention blocks
run the ported flash kernel, the KV cache is written in place, and the
rotary tables are computed once per step for every layer.  ``forward``
remats each layer (``cfg.remat``) with the load-balance sum in the
checkpointed carry, as the reference does.  The router is a product with
no batch dims (saved under "dots"), the expert einsums have batch dims
(``g``, ``e``) and are recomputed, in both packages.

The reference's sharding hints (``shard_constraint``) have no counterpart
on one card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple

import torch

from repro_torch.configs import base as ax
from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm
from repro_torch.models.common import ParamSpec

Params = Dict[str, Any]
_proj = tfm._proj
# leaves cast to the activation dtype before use: the attention and expert
# weights, and the shared experts' gate; the router and the norm weights
# are read in fp32
CAST_KEYS = tfm.MATMUL_KEYS + ("gate",)


def moe_ffn_specs(cfg: ModelConfig) -> Params:
    D, E, F = cfg.d_model, cfg.moe_num_experts, cfg.d_ff
    s: Params = {
        "ln": ParamSpec((D,), (ax.EMBED,), init="ones"),
        "router": ParamSpec((D, E), (ax.EMBED, ax.EXPERTS), scale=0.1),
        "wi": ParamSpec((E, D, F), (ax.EXPERTS, ax.EMBED, ax.EXPERT_MLP)),
        "wg": ParamSpec((E, D, F), (ax.EXPERTS, ax.EMBED, ax.EXPERT_MLP)),
        "wo": ParamSpec((E, F, D), (ax.EXPERTS, ax.EXPERT_MLP, ax.EMBED)),
    }
    if cfg.moe_num_shared_experts:
        Fs = cfg.moe_shared_d_ff or cfg.moe_num_shared_experts * cfg.d_ff
        s["shared"] = {
            "wi": ParamSpec((D, Fs), (ax.EMBED, ax.MLP)),
            "wg": ParamSpec((D, Fs), (ax.EMBED, ax.MLP)),
            "wo": ParamSpec((Fs, D), (ax.MLP, ax.EMBED)),
            "gate": ParamSpec((D, 1), (ax.EMBED, None), scale=0.1),
        }
    return s


def layer_specs(cfg: ModelConfig) -> Params:
    return {"attn": tfm.attn_specs(cfg), "moe": moe_ffn_specs(cfg)}


def param_specs(cfg: ModelConfig) -> Params:
    return {
        "layers": cm.stack_tree(layer_specs(cfg), cfg.num_layers),
        **tfm.embed_specs(cfg),
    }


def _top_k_one_hot(gates: torch.Tensor, k: int):
    """gates: (..., E) -> (weights (..., k), one-hot (..., k, E)); ties go
    to the lower index, as ``jax.lax.top_k``'s."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    E = gates.shape[-1]
    oh = (idx[..., None] == torch.arange(E, device=gates.device)).to(
        gates.dtype)
    return vals, oh


class Routing(NamedTuple):
    """One layer's routing of (G, S) token groups over E experts."""
    xs: torch.Tensor        # (G, S, D) normed tokens
    probs: torch.Tensor     # (G, S, E) router softmax, fp32
    top_oh: torch.Tensor    # (G, S, K, E) the top-k choices
    sel: torch.Tensor       # (G, S, E) in {0, 1}: the token chose the expert
    w_se: torch.Tensor      # (G, S, E) normalized top-k weights
    pos: torch.Tensor       # (G, S, E) the token's queue position there
    in_cap: torch.Tensor    # (G, S, E) bool: chose it and fits its capacity
    capacity: int           # C, tokens per expert per group

    @property
    def dropped(self) -> int:
        """Choices past their expert's capacity (host sync)."""
        return int(((self.sel > 0) & ~self.in_cap).sum())


def route(p: Params, x: torch.Tensor, cfg: ModelConfig) -> Routing:
    """The routing half of ``moe_ffn``: x (B, T, D) -> ``Routing``."""
    B, T, D = x.shape
    E, K = cfg.moe_num_experts, cfg.moe_top_k
    h = cm.rms_norm(x, p["ln"], cfg.norm_eps)
    S = min(cfg.moe_group_size, B * T)
    while (B * T) % S != 0:   # largest divisor of B*T <= moe_group_size
        S -= 1
    G = (B * T) // S
    xs = h.reshape(G, S, D)

    gates = _proj(xs.to(torch.float32), p["router"])
    probs = torch.softmax(gates, dim=-1)
    top_vals, top_oh = _top_k_one_hot(probs, K)            # (G,S,K), (G,S,K,E)
    top_vals = top_vals / torch.clamp_min(top_vals.sum(-1, keepdim=True),
                                          1e-9)
    # reduce over k before the capacity one-hot (a token reaches an expert
    # at most once)
    sel = top_oh.sum(dim=2)                                # (G,S,E)
    w_se = (top_vals[..., None] * top_oh).sum(dim=2)       # (G,S,E)
    C = max(int(S * K * cfg.moe_capacity_factor / E), 1)
    C = min(C, S)
    pos = torch.cumsum(sel, dim=1) - sel                   # queue position
    in_cap = (sel > 0) & (pos < C)
    return Routing(xs, probs, top_oh, sel, w_se, pos, in_cap, C)


def moe_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig,
            return_aux: bool = False):
    """Capacity-factor MoE FFN.  x: (B, T, D) -> (B, T, D)[, aux_loss]."""
    B, T, D = x.shape
    E = cfg.moe_num_experts
    r = route(p, x, cfg)
    xs, C = r.xs, r.capacity
    # one-hot of the queue position, all-zero past C (jax.nn.one_hot's rule)
    pos_oh = (r.pos.to(torch.int64)[..., None]
              == torch.arange(C, device=x.device)).to(xs.dtype)
    disp = torch.where(r.in_cap[..., None], pos_oh,
                       torch.zeros((), dtype=xs.dtype, device=x.device))
    comb = disp * r.w_se[..., None].to(xs.dtype)           # (G,S,E,C)
    expert_in = torch.einsum("gsec,gsd->egcd", disp, xs)   # (E,G,C,D)

    act = cm.activation(cfg.act)
    dt = expert_in.dtype
    gph = torch.einsum("egcd,edf->egcf", expert_in, p["wg"].to(dt))
    uph = torch.einsum("egcd,edf->egcf", expert_in, p["wi"].to(dt))
    expert_out = torch.einsum("egcf,efd->egcd", act(gph) * uph,
                              p["wo"].to(dt))              # (E,G,C,D)
    out = torch.einsum("gsec,egcd->gsd", comb, expert_out)
    out = out.reshape(B, T, D).to(x.dtype)

    if "shared" in p:
        sp = p["shared"]
        h = xs.reshape(B, T, D)
        sh = act(_proj(h, sp["wg"])) * _proj(h, sp["wi"])
        sg = torch.sigmoid(_proj(h, sp["gate"]))
        out = out + sg * _proj(sh, sp["wo"])

    if not return_aux:
        return out
    # Switch-style load-balance loss: E * sum_e f_e * p_e
    frac = r.top_oh.sum(dim=2).mean(dim=(0, 1))            # (E,)
    mean_p = r.probs.mean(dim=(0, 1))
    return out, E * torch.sum(frac * mean_p)


def moe_layer(p: Params, x: torch.Tensor, cfg: ModelConfig, *, positions,
              cache=None, index=None, impl="auto", kv_seq_shard=False,
              with_aux=False, rope=None):
    """Attention block, then the MoE FFN.  Returns (x, cache[, aux])."""
    a, new_cache = tfm.attention_block(
        p["attn"], x, cfg, positions=positions, cache=cache, index=index,
        impl=impl, kv_seq_shard=kv_seq_shard, rope=rope)
    x = x + a
    if with_aux:
        m, aux = moe_ffn(p["moe"], x, cfg, return_aux=True)
        return x + m, new_cache, aux
    return x + moe_ffn(p["moe"], x, cfg), new_cache


@dataclasses.dataclass
class MoELM(tfm.DenseLM):
    """Every layer: attention + MoE FFN (the qwen MoE family), behind the
    dense model's serving API; ``impl`` as ``DenseLM.impl``."""

    cast_keys = CAST_KEYS

    def param_specs(self) -> Params:
        return param_specs(self.cfg)

    def forward(self, params: Params, batch: Dict[str, torch.Tensor],
                return_aux: bool = False):
        """Logits (B, T, V); with ``return_aux`` also the load-balance
        loss, ``moe_router_aux_coef`` times its mean over the layers."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = tfm.embed(params, tokens, cfg)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
        impl, rope = self.impl, self._rope(positions)

        def fn(pl, carry):
            x, aux = carry
            y, _, a = moe_layer(pl, x, cfg, positions=positions, impl=impl,
                                with_aux=True, rope=rope)
            return y, aux + a

        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        x, aux = tfm.scan_stack(fn, self._layers(params), (x, aux),
                                remat=cfg.remat)
        logits = tfm.unembed(params, x, cfg)
        if return_aux:
            return logits, cfg.moe_router_aux_coef * aux / cfg.num_layers
        return logits

    def _serve(self, params: Params, tokens: torch.Tensor, cache: Params,
               index, kv_seq_shard: bool) -> torch.Tensor:
        cfg = self.cfg
        x = tfm.embed(params, tokens, cfg)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
        if index is not None:
            positions = positions + index
        rope = self._rope(positions)
        for i, pl in enumerate(self._layers(params)):
            x, _ = moe_layer(pl, x, cfg, positions=positions,
                             cache=(cache["k"][i], cache["v"][i]),
                             index=index, impl=self.impl,
                             kv_seq_shard=kv_seq_shard, rope=rope)
        return x

    def prefill(self, params: Params, tokens: torch.Tensor, cache: Params):
        """Fill the cache with T prompt tokens; return (last_logits, cache),
        the cache updated in place."""
        x = self._serve(params, tokens, cache, None, False)
        logits = tfm.unembed(params, x[:, -1:, :], self.cfg)
        return logits[:, 0, :], cache

    def decode_step(self, params: Params, tokens: torch.Tensor,
                    cache: Params, index, *, kv_seq_shard: bool = False):
        """One decode step: tokens (B, T) at position ``index`` (a host int
        or a 0-dim integer tensor on the device, ``tfm.decode_index``)."""
        x = self._serve(params, tokens, cache, tfm.decode_index(index),
                        kv_seq_shard)
        logits = tfm.unembed(params, x, self.cfg)
        return logits[:, -1, :], cache
