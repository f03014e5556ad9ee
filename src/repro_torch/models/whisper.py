"""Whisper-small backbone — encoder-decoder with a STUB conv frontend
[arXiv:2212.04356], ported from ``repro/models/whisper.py``.

The mel + conv frontend is a stub, as in the reference: the caller gives
precomputed frame embeddings (B, 1500, 768).  The encoder is 12
bidirectional layers over those frames plus a sinusoidal table; the
decoder is 12 causal layers with cross-attention, learned positions
``dec_pos`` sized to the ``max_seq`` given at build time, and non-gated
MLPs (fc1 -> tanh GELU -> fc2).  Every attention call (encoder,
decoder self, cross) runs ``ops.attention``: the ported flash kernel on
the card, non-causal for the encoder and the cross-attention.

Parameters keep the reference's tree (``encoder`` and ``decoder`` stack
their layers, ``dec_pos``, ``embedding`` tied to the output); in
``forward`` and ``encode``, ``transformer.scan_stack`` runs each stack
under the remat policy (``cfg.remat``), as the reference's.  The cache is
updated IN PLACE: ``k``/``v`` (L, B, max_seq, KV, hd) for the decoder's
self-attention, and ``cross_k``/``cross_v`` (L, B, encoder_seq, KV, hd),
filled once by the prefill from the encoder's output.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs import base as ax
from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm
from repro_torch.models.common import ParamSpec

Params = Dict[str, Any]
_proj = tfm._proj
# leaves cast to the activation dtype before use (the decoder's learned
# positions too, as the reference's ``pos.astype(cfg.dtype)``)
CAST_KEYS = tfm.MATMUL_KEYS + ("dec_pos",)
_gelu = cm.activation("gelu")          # jax.nn.gelu's default: tanh


def _ffn_specs(cfg: ModelConfig) -> Params:
    D, F = cfg.d_model, cfg.d_ff
    return {
        "ln": ParamSpec((D,), (ax.EMBED,), init="ones"),
        "wi": ParamSpec((D, F), (ax.EMBED, ax.MLP)),
        "wo": ParamSpec((F, D), (ax.MLP, ax.EMBED)),
    }


def _ffn(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = cm.rms_norm(x, p["ln"], cfg.norm_eps)
    return _proj(_gelu(_proj(h, p["wi"])), p["wo"])


def enc_layer_specs(cfg: ModelConfig) -> Params:
    return {"attn": tfm.attn_specs(cfg), "ffn": _ffn_specs(cfg)}


def dec_layer_specs(cfg: ModelConfig) -> Params:
    return {
        "self_attn": tfm.attn_specs(cfg),
        "cross_attn": tfm.attn_specs(cfg),
        "ffn": _ffn_specs(cfg),
    }


def param_specs(cfg: ModelConfig, max_seq: int) -> Params:
    D = cfg.d_model
    return {
        "encoder": cm.stack_tree(enc_layer_specs(cfg), cfg.encoder_layers),
        "enc_final_ln": ParamSpec((D,), (ax.EMBED,), init="ones"),
        "decoder": cm.stack_tree(dec_layer_specs(cfg), cfg.num_layers),
        "dec_pos": ParamSpec((max_seq, D), (None, ax.EMBED), scale=0.02),
        "embedding": ParamSpec((cfg.padded_vocab, D), (ax.VOCAB, ax.EMBED)),
        "final_ln": ParamSpec((D,), (ax.EMBED,), init="ones"),
    }


def _heads_out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """o (B, T, H, hd) @ wo (H, hd, D) -> (B, T, D)."""
    B, T, H, hd = o.shape
    return _proj(o.reshape(B, T, H * hd), wo.reshape(H * hd, -1))


def _cross_attention(p: Params, x: torch.Tensor, enc_kv, cfg: ModelConfig,
                     impl: str) -> torch.Tensor:
    """Cross-attention: q from the decoder's x, (k, v) precomputed from the
    encoder's output; non-causal, every frame visible."""
    h = cm.rms_norm(x, p["ln"], cfg.norm_eps)
    k, v = enc_kv
    o = tfm._attend(_proj(h, p["wq"]), k, v, impl, causal=False)
    return _heads_out(o, p["wo"])


def _enc_kv(p: Params, enc_out: torch.Tensor):
    return _proj(enc_out, p["wk"]), _proj(enc_out, p["wv"])


@dataclasses.dataclass
class WhisperLM(tfm.DenseLM):
    """The encoder-decoder behind the dense model's serving API; ``impl``
    as ``DenseLM.impl``, for every attention call."""

    max_seq: int = 4096
    # the encoder's sinusoidal table per (frames, width, device): built
    # once on the host in float64, as the reference's (a constant of its
    # jitted program), instead of once per prefill
    _positions: Dict[Any, torch.Tensor] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)
    cast_keys = CAST_KEYS

    def param_specs(self) -> Params:
        return param_specs(self.cfg, self.max_seq)

    def _stacks(self, params: Params) -> Dict[str, List[Params]]:
        cfg = self.cfg
        return {"encoder": tfm.layer_params(params, cfg.encoder_layers,
                                            "encoder"),
                "decoder": tfm.layer_params(params, cfg.num_layers,
                                            "decoder")}

    # ------------------------------------------------------------ encoder
    def encode(self, params: Params,
               enc_embeds: torch.Tensor) -> torch.Tensor:
        """Frame embeddings (B, S, D) -> the encoder's output (B, S, D)."""
        cfg = self.cfg
        dt = cm.torch_dtype(cfg.dtype)
        B, S, D = enc_embeds.shape
        key = (S, D, enc_embeds.device)
        pos = self._positions.get(key)
        if pos is None:
            pos = cm.sinusoidal_positions(S, D).to(enc_embeds.device)
            self._positions[key] = pos
        x = enc_embeds.to(dt) + pos.to(dt)[None]
        impl = self.impl

        def fn(pl, h):
            pa = pl["attn"]
            hn = cm.rms_norm(h, pa["ln"], cfg.norm_eps)
            o = tfm._attend(_proj(hn, pa["wq"]), _proj(hn, pa["wk"]),
                            _proj(hn, pa["wv"]), impl, causal=False)
            h = h + _heads_out(o, pa["wo"])
            return h + _ffn(pl["ffn"], h, cfg)

        x = tfm.scan_stack(fn, self._stacks(params)["encoder"], x,
                           remat=cfg.remat)
        return cm.rms_norm(x, params["enc_final_ln"], cfg.norm_eps)

    # ------------------------------------------------------------ decoder
    def _dec_embed(self, params: Params, tokens: torch.Tensor,
                   offset) -> torch.Tensor:
        """Token embeddings plus the learned positions ``offset`` ..
        ``offset + T - 1``; ``offset`` a host int (checked against
        ``dec_pos``) or a 0-dim tensor on the device (rows gathered there,
        unchecked: the caller keeps it in range)."""
        dt = cm.torch_dtype(self.cfg.dtype)
        T = tokens.shape[1]
        table = params["dec_pos"]
        x = cm.take_embedding(params["embedding"], tokens).to(dt)
        if isinstance(offset, torch.Tensor):
            rows = table.index_select(
                0, offset + torch.arange(T, device=offset.device))
            return x + rows.to(dt)[None]
        if offset + T > table.shape[0]:
            raise ValueError(f"decoder positions {offset}..{offset + T - 1} "
                             f"past dec_pos ({table.shape[0]} rows, the "
                             f"max_seq the model was built with)")
        return x + table[offset:offset + T].to(dt)[None]

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x = cm.rms_norm(x, params["final_ln"], self.cfg.norm_eps)
        B, T, D = x.shape
        return (x.reshape(B * T, D) @ params["embedding"].to(x.dtype).T
                ).reshape(B, T, -1)

    def forward(self, params: Params,
                batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        tokens = batch["tokens"]
        enc_out = self.encode(params, batch["enc_embeds"])
        x = self._dec_embed(params, tokens, 0)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
        impl = self.impl

        def fn(pl, h):
            a, _ = tfm.attention_block(pl["self_attn"], h, cfg,
                                       positions=positions, impl=impl)
            h = h + a
            h = h + _cross_attention(pl["cross_attn"], h,
                                     _enc_kv(pl["cross_attn"], enc_out), cfg,
                                     impl)
            return h + _ffn(pl["ffn"], h, cfg)

        x = tfm.scan_stack(fn, self._stacks(params)["decoder"], x,
                           remat=cfg.remat)
        return self._logits(params, x)

    # ------------------------------------------------------------- serving
    def cache_specs(self, batch: int, max_seq: int) -> Params:
        cfg = self.cfg
        kv_axes = (ax.LAYERS, ax.BATCH, ax.CACHE_SEQ, ax.KV_HEADS,
                   ax.HEAD_DIM)
        ca_axes = (ax.LAYERS, ax.BATCH, ax.ENC_SEQ, ax.KV_HEADS, ax.HEAD_DIM)
        L, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
        dt = cm.torch_dtype(cfg.dtype)
        self_shape = (L, batch, max_seq, KV, hd)
        cross_shape = (L, batch, cfg.encoder_seq, KV, hd)
        return {
            "k": ParamSpec(self_shape, kv_axes, init="zeros", dtype=dt),
            "v": ParamSpec(self_shape, kv_axes, init="zeros", dtype=dt),
            "cross_k": ParamSpec(cross_shape, ca_axes, init="zeros",
                                 dtype=dt),
            "cross_v": ParamSpec(cross_shape, ca_axes, init="zeros",
                                 dtype=dt),
        }

    def _dec_run(self, params: Params, tokens: torch.Tensor, cache: Params,
                 index, kv_seq_shard: bool = False
                 ) -> torch.Tensor:
        cfg = self.cfg
        x = self._dec_embed(params, tokens, 0 if index is None else index)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
        if index is not None:
            positions = positions + index
        for i, pl in enumerate(self._stacks(params)["decoder"]):
            a, _ = tfm.attention_block(
                pl["self_attn"], x, cfg, positions=positions,
                cache=(cache["k"][i], cache["v"][i]), index=index,
                impl=self.impl, kv_seq_shard=kv_seq_shard)
            x = x + a
            x = x + _cross_attention(
                pl["cross_attn"], x, (cache["cross_k"][i],
                                      cache["cross_v"][i]), cfg, self.impl)
            x = x + _ffn(pl["ffn"], x, cfg)
        return x

    def prefill(self, params: Params, tokens: torch.Tensor, cache: Params,
                enc_embeds: Optional[torch.Tensor] = None):
        """Run the encoder and fill the cross-attention caches (when
        ``enc_embeds`` is given), then the prompt; return (last_logits,
        cache), the cache updated in place."""
        if enc_embeds is not None:
            enc_out = self.encode(params, enc_embeds)
            for i, pl in enumerate(self._stacks(params)["decoder"]):
                k, v = _enc_kv(pl["cross_attn"], enc_out)
                cache["cross_k"][i].copy_(k)
                cache["cross_v"][i].copy_(v)
        x = self._dec_run(params, tokens, cache, None)
        return self._logits(params, x[:, -1:, :])[:, 0, :], cache

    def decode_step(self, params: Params, tokens: torch.Tensor,
                    cache: Params, index, *, kv_seq_shard: bool = False):
        """One decode step: tokens (B, T) at position ``index`` (a host int
        or a 0-dim integer tensor on the device, ``tfm.decode_index``)."""
        x = self._dec_run(params, tokens, cache, tfm.decode_index(index),
                          kv_seq_shard)
        return self._logits(params, x)[:, -1, :], cache
