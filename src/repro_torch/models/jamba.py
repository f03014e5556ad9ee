"""Jamba — hybrid Mamba + attention 1:7 interleave with MoE
[arXiv:2403.19887], ported from ``repro/models/jamba.py``.

Layers come in period-8 groups.  Within a group (offsets 0..7) the offset
``attn_layer_offset`` is a GQA attention layer (``transformer.
attention_block``, the ported flash kernel) and the other 7 are Mamba
mixers (``mamba.mamba_mixer``, the ported ssd kernel in the prefill); the
FFN is MoE (``moe.moe_ffn``) on the offsets ``o % moe_layer_period ==
moe_layer_offset`` and dense elsewhere.  Parameters keep the reference's
tree: ``layers`` stacks G groups, and inside a group ``mamba``, ``moe``
and ``dense`` stack their 7, 4 and 4 slices; a Python loop over both
levels takes the place of ``jax.lax.scan``.  ``forward`` remats per group
(``cfg.remat``), not per sublayer, as the reference does.

The cache is updated IN PLACE: ``k``/``v`` (G, B, S, KV, hd) and ``conv``
(G, 7, B, d_conv - 1, d_inner) in the activation dtype, ``ssd``
(G, 7, B, H, N, P) fp32.  ``prefill`` / ``decode_step`` return the dict
they were given.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs import base as ax
from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models import mamba as mb
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.common import ParamSpec

Params = Dict[str, Any]

PERIOD = 8
# leaves cast to the activation dtype before use (the attention, dense MLP
# and expert weights share the names wq..wg); the router, A_log, dt_bias
# and the norm weights (ln, norm_w, final_ln) are read in fp32
CAST_KEYS = tfm.MATMUL_KEYS + ("in_proj", "conv_w", "conv_b", "w_dt", "w_B",
                               "w_C", "D_skip", "out_proj")


def _offsets(cfg: ModelConfig):
    attn_o = cfg.attn_layer_offset
    mamba_os = [o for o in range(PERIOD) if o != attn_o]
    moe_os = [o for o in range(PERIOD)
              if o % cfg.moe_layer_period == cfg.moe_layer_offset]
    dense_os = [o for o in range(PERIOD) if o not in moe_os]
    return attn_o, mamba_os, moe_os, dense_os


def group_specs(cfg: ModelConfig) -> Params:
    _, mamba_os, moe_os, dense_os = _offsets(cfg)
    return {
        "attn": tfm.attn_specs(cfg),
        "mamba": cm.stack_tree(mb.mamba_specs(cfg), len(mamba_os)),
        "moe": cm.stack_tree(moe_mod.moe_ffn_specs(cfg), len(moe_os)),
        "dense": cm.stack_tree(tfm.mlp_specs(cfg), len(dense_os)),
    }


def param_specs(cfg: ModelConfig) -> Params:
    if cfg.num_layers % PERIOD:
        raise ValueError(f"{cfg.name}: num_layers={cfg.num_layers} is not a "
                         f"multiple of the period {PERIOD}")
    return {
        "layers": cm.stack_tree(group_specs(cfg), cfg.num_layers // PERIOD),
        **tfm.embed_specs(cfg),
    }


def _sub(tree, i: int):
    """Slice ``i`` of a stacked tree, or item ``i`` of one split ahead
    (``JambaLM.compute_params``)."""
    if isinstance(tree, list):
        return tree[i]
    return {k: _sub(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def group_forward(gp: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  positions: torch.Tensor, cache: Optional[Params] = None,
                  index=None, impl: str = "auto",
                  kv_seq_shard: bool = False, with_aux: bool = False,
                  rope=None):
    """One period-8 group.  ``cache``: this group's views {"k", "v" (B, S,
    KV, hd), "conv", "ssd" (stacked 7 for the mamba layers)}, updated in
    place.  Returns (x, aux); aux is the summed MoE load-balance loss when
    ``with_aux``, else 0."""
    attn_o, mamba_os, moe_os, dense_os = _offsets(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    m_i = 0
    for o in range(PERIOD):
        if o == attn_o:
            c = (cache["k"], cache["v"]) if cache is not None else None
            a, _ = tfm.attention_block(
                gp["attn"], x, cfg, positions=positions, cache=c, index=index,
                impl=impl, kv_seq_shard=kv_seq_shard, rope=rope)
        else:
            st = None
            if cache is not None:
                st = {"conv": cache["conv"][m_i], "ssd": cache["ssd"][m_i]}
            a = mb.mamba_mixer(_sub(gp["mamba"], m_i), x, cfg, states=st,
                               impl=impl)
            m_i += 1
        x = x + a
        if o in moe_os:
            p = _sub(gp["moe"], moe_os.index(o))
            if with_aux:
                m, a_l = moe_mod.moe_ffn(p, x, cfg, return_aux=True)
                aux = aux + a_l
            else:
                m = moe_mod.moe_ffn(p, x, cfg)
            x = x + m
        else:
            x = x + tfm.mlp_block(_sub(gp["dense"], dense_os.index(o)), x,
                                  cfg)
    return x, aux


@dataclasses.dataclass
class JambaLM(tfm.DenseLM):
    """The hybrid LM behind the dense model's serving API (``init``,
    ``init_cache``, ``prefill``, ``decode_step``, ``compute_params``);
    ``impl`` as ``DenseLM.impl``, for the attention and the SSD scan."""

    cast_keys = CAST_KEYS

    def param_specs(self) -> Params:
        return param_specs(self.cfg)

    @property
    def num_groups(self) -> int:
        return self.cfg.num_layers // PERIOD

    def _layers(self, params: Params) -> List[Params]:
        return tfm.layer_params(params, self.num_groups)

    def compute_params(self, params: Params) -> Params:
        """``DenseLM.compute_params`` with both stacking levels split: the
        G groups, and each group's mamba, moe and dense slices."""
        out = super().compute_params(params)
        _, mamba_os, moe_os, dense_os = _offsets(self.cfg)
        n = {"mamba": len(mamba_os), "moe": len(moe_os),
             "dense": len(dense_os)}
        out["layers"] = [
            {k: ([_sub(v, i) for i in range(n[k])] if k in n else v)
             for k, v in gp.items()}
            for gp in out["layers"]]
        return out

    def forward(self, params: Params, batch: Dict[str, torch.Tensor],
                return_aux: bool = False):
        cfg = self.cfg
        tokens = batch["tokens"]
        x = tfm.embed(params, tokens, cfg)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
        impl, rope = self.impl, self._rope(positions)

        def fn(gp, carry):
            x, aux = carry
            y, a = group_forward(gp, x, cfg, positions=positions, impl=impl,
                                 with_aux=True, rope=rope)
            return y, aux + a

        # remat per group (the Mamba mixers inside it), as the reference
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        x, aux = tfm.scan_stack(fn, self._layers(params), (x, aux),
                                remat=cfg.remat)
        logits = tfm.unembed(params, x, cfg)
        if return_aux:
            n_moe = self.num_groups * len(_offsets(cfg)[2])
            return logits, cfg.moe_router_aux_coef * aux / n_moe
        return logits

    # ------------------------------------------------------------- serving
    def cache_specs(self, batch: int, max_seq: int) -> Params:
        cfg = self.cfg
        G = self.num_groups
        n_mamba = PERIOD - 1
        kv_axes = (ax.LAYERS, ax.BATCH, ax.CACHE_SEQ, ax.KV_HEADS,
                   ax.HEAD_DIM)
        kv_shape = (G, batch, max_seq, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
        dt = cm.torch_dtype(cfg.dtype)
        ms = mb.mamba_state_specs(cfg, batch)

        def stack2(s: ParamSpec) -> ParamSpec:
            return dataclasses.replace(s, shape=(G, n_mamba) + s.shape,
                                       axes=(ax.LAYERS, None) + s.axes)

        return {
            "k": ParamSpec(kv_shape, kv_axes, init="zeros", dtype=dt),
            "v": ParamSpec(kv_shape, kv_axes, init="zeros", dtype=dt),
            "conv": stack2(ms["conv"]),
            "ssd": stack2(ms["ssd"]),
        }

    def _serve(self, params: Params, tokens: torch.Tensor, cache: Params,
               index, kv_seq_shard: bool) -> torch.Tensor:
        cfg = self.cfg
        x = tfm.embed(params, tokens, cfg)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
        if index is not None:
            positions = positions + index
        rope = self._rope(positions)
        for g, gp in enumerate(self._layers(params)):
            x, _ = group_forward(
                gp, x, cfg, positions=positions,
                cache={k: cache[k][g] for k in ("k", "v", "conv", "ssd")},
                index=index, impl=self.impl, kv_seq_shard=kv_seq_shard,
                rope=rope)
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
