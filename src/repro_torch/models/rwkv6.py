"""RWKV6 "Finch" — attention-free LM with data-dependent decay
[arXiv:2404.05892], ported from ``repro/models/rwkv6.py``.

The reference's block structure: time-mix with ddlerp token-shift LoRAs, a
per-channel data-dependent decay w_t (through a decay LoRA), the bonus u,
the WKV6 recurrence (``ops.wkv6``: the hand-written CUDA kernel on the
card, its plain version on the CPU; a decode step runs the plain
``ops.wkv6_decode`` on both), per-head group norm and silu(g) gating;
channel-mix with squared ReLU.  Parameters keep the reference's keys and
``(in, out)`` layout, so its weights carry across with no transposes.

Dtypes follow the reference: the decay LoRA's second half (``w0``,
``decay_b``) and w = exp(-exp(.)) are fp32, and w is rounded to the
activation dtype before the recurrence; ``u`` reaches the recurrence in
fp32; norms are fp32 inside; every other weight is cast to the activation
dtype at its product (``RWKV6LM.cast_keys``, cast once ahead by
``compute_params``).

O(1) decode state, updated IN PLACE: ``wkv`` (L, B, H, N, N) fp32 and the
token-shift states ``tshift``/``cshift`` (L, B, D) in the activation
dtype.  A prefill writes each layer's new WKV state straight into that
layer's cache slice (the kernel reads a slice before it writes it); the
new shift state is the last row of the NORMED input of its block.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs import base as ax
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm
from repro_torch.models.common import ParamSpec

Params = Dict[str, Any]
_proj = tfm._proj
# leaves cast to the activation dtype before use; w0, decay_b, u and the
# norm weights (ln, gn_w, gn_b, final_ln) are read in fp32
CAST_KEYS = ("mu_x", "mu", "lora_a", "lora_b", "decay_a", "wr", "wk", "wv",
             "wg", "wo", "mu_k", "mu_r", "embedding", "lm_head")


def time_mix_specs(cfg: ModelConfig) -> Params:
    D = cfg.d_model
    R = cfg.rwkv_lora_rank
    Rd = cfg.rwkv_decay_lora_rank
    H = cfg.rwkv_num_heads
    N = cfg.rwkv_head_dim
    return {
        "ln": ParamSpec((D,), (ax.EMBED,), init="ones"),
        "mu_x": ParamSpec((D,), (ax.EMBED,), init="uniform", scale=0.5),
        "mu": ParamSpec((5, D), (None, ax.EMBED), init="uniform", scale=0.5),
        "lora_a": ParamSpec((D, 5, R), (ax.EMBED, None, None), scale=0.1),
        "lora_b": ParamSpec((5, R, D), (None, None, ax.EMBED), scale=0.1),
        "w0": ParamSpec((D,), (ax.EMBED,), init="uniform", scale=1.0),
        "decay_a": ParamSpec((D, Rd), (ax.EMBED, None), scale=0.1),
        "decay_b": ParamSpec((Rd, D), (None, ax.EMBED), scale=0.1),
        "u": ParamSpec((H, N), (ax.HEADS, ax.HEAD_DIM), init="uniform",
                       scale=0.5),
        "wr": ParamSpec((D, D), (ax.EMBED, ax.MLP)),
        "wk": ParamSpec((D, D), (ax.EMBED, ax.MLP)),
        "wv": ParamSpec((D, D), (ax.EMBED, ax.MLP)),
        "wg": ParamSpec((D, D), (ax.EMBED, ax.MLP)),
        "wo": ParamSpec((D, D), (ax.MLP, ax.EMBED)),
        "gn_w": ParamSpec((D,), (ax.EMBED,), init="ones"),
        "gn_b": ParamSpec((D,), (ax.EMBED,), init="zeros"),
    }


def channel_mix_specs(cfg: ModelConfig) -> Params:
    D, F_ = cfg.d_model, cfg.d_ff
    return {
        "ln": ParamSpec((D,), (ax.EMBED,), init="ones"),
        "mu_k": ParamSpec((D,), (ax.EMBED,), init="uniform", scale=0.5),
        "mu_r": ParamSpec((D,), (ax.EMBED,), init="uniform", scale=0.5),
        "wk": ParamSpec((D, F_), (ax.EMBED, ax.MLP)),
        "wv": ParamSpec((F_, D), (ax.MLP, ax.EMBED)),
        "wr": ParamSpec((D, D), (ax.EMBED, None)),
    }


def layer_specs(cfg: ModelConfig) -> Params:
    return {"tmix": time_mix_specs(cfg), "cmix": channel_mix_specs(cfg)}


def param_specs(cfg: ModelConfig) -> Params:
    return {
        "layers": cm.stack_tree(layer_specs(cfg), cfg.num_layers),
        **tfm.embed_specs(cfg),
    }


# ---------------------------------------------------------------------------
# Blocks.  ``shift_state`` is the last normed row of the previous segment
# (B, D); None for a forward without a cache (zero-pad shift).
# ---------------------------------------------------------------------------


def _token_shift(x: torch.Tensor,
                 shift_state: Optional[torch.Tensor]) -> torch.Tensor:
    """x_{t-1} (same shape as x)."""
    if x.shape[1] == 1 and shift_state is not None:
        return shift_state[:, None, :]
    prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    if shift_state is not None:
        prev[:, 0] = shift_state
    return prev


def _wkv(impl: str, *args, **kw):
    if impl == "plain":
        return ops.plain_wkv6(*args, **kw)
    return ops.wkv6(*args, **kw)


def time_mix(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
             wkv_state: Optional[torch.Tensor] = None,
             shift_state: Optional[torch.Tensor] = None,
             impl: str = "auto", chunk: int = 64
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (out, new_wkv_state, new_shift_state).  A prefill with a
    ``wkv_state`` writes the new state into that tensor and returns it; a
    decode step (T == 1 with a state) returns a new one."""
    B, T, D = x.shape
    H, N = cfg.rwkv_num_heads, cfg.rwkv_head_dim
    h = cm.rms_norm(x, p["ln"], cfg.norm_eps)
    dt = h.dtype
    prev = _token_shift(h, shift_state)
    delta = prev - h

    xxx = h + delta * p["mu_x"].to(dt)
    lo = _proj(xxx, p["lora_a"])                               # (B,T,5,R)
    adj = torch.einsum("btir,ird->btid", torch.tanh(lo), p["lora_b"].to(dt))
    mixed = h[:, :, None, :] + delta[:, :, None, :] * (p["mu"].to(dt) + adj)
    xw, xk, xv, xr, xg = mixed.unbind(dim=2)

    r = _proj(xr, p["wr"])
    k = _proj(xk, p["wk"])
    v = _proj(xv, p["wv"])
    g = _proj(xg, p["wg"])

    dlo = torch.tanh(_proj(xw, p["decay_a"]))
    dlog = p["w0"].to(torch.float32) + _proj(dlo.to(torch.float32),
                                             p["decay_b"].to(torch.float32))
    w = torch.exp(-torch.exp(dlog))                            # (B,T,D) in (0,1)

    def hd(z):
        return z.reshape(B, T, H, N)

    r4, k4, v4, w4 = hd(r), hd(k), hd(v), hd(w.to(dt))
    if T == 1 and wkv_state is not None:
        y4, new_state = ops.wkv6_decode(r4[:, 0], k4[:, 0], v4[:, 0],
                                        w4[:, 0], p["u"], wkv_state)
        y4 = y4[:, None]
    else:
        y4, new_state = _wkv(impl, r4, k4, v4, w4, p["u"], wkv_state,
                             chunk=min(chunk, T), state_out=wkv_state)
    y = y4.reshape(B, T, D)
    y = cm.group_norm(y, p["gn_w"], p["gn_b"], groups=H, eps=64e-5)
    y = y * F.silu(g)
    return _proj(y, p["wo"]), new_state, h[:, -1, :]


def channel_mix(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                shift_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    h = cm.rms_norm(x, p["ln"], cfg.norm_eps)
    dt = h.dtype
    prev = _token_shift(h, shift_state)
    delta = prev - h
    xk = h + delta * p["mu_k"].to(dt)
    xr = h + delta * p["mu_r"].to(dt)
    k = torch.square(F.relu(_proj(xk, p["wk"])))
    kv = _proj(k, p["wv"])
    rg = torch.sigmoid(_proj(xr, p["wr"]))
    return rg * kv, h[:, -1, :]


def rwkv_layer(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
               states: Optional[Params] = None, impl: str = "auto",
               chunk: int = 64) -> torch.Tensor:
    """``states``: None (no cache) or one layer's cache views dict(wkv,
    tshift, cshift), updated in place."""
    wkv_s = states["wkv"] if states else None
    t_s = states["tshift"] if states else None
    c_s = states["cshift"] if states else None
    a, new_wkv, new_tshift = time_mix(p["tmix"], x, cfg, wkv_state=wkv_s,
                                      shift_state=t_s, impl=impl, chunk=chunk)
    x = x + a
    c, new_cshift = channel_mix(p["cmix"], x, cfg, shift_state=c_s)
    x = x + c
    if states:
        if new_wkv is not wkv_s:
            wkv_s.copy_(new_wkv)
        t_s.copy_(new_tshift)
        c_s.copy_(new_cshift)
    return x


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RWKV6LM(tfm.DenseLM):
    """The RWKV6 LM behind the dense model's serving API (``init``,
    ``init_cache``, ``prefill``, ``decode_step``, ``compute_params``);
    ``impl`` as ``DenseLM.impl``, for the WKV recurrence."""

    wkv_chunk: int = 64
    cast_keys = CAST_KEYS

    def param_specs(self) -> Params:
        return param_specs(self.cfg)

    def forward(self, params: Params,
                batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        x = tfm.embed(params, batch["tokens"], cfg)
        impl, chunk = self.impl, self.wkv_chunk

        def fn(pl, h):
            return rwkv_layer(pl, h, cfg, impl=impl, chunk=chunk)

        x = tfm.scan_stack(fn, self._layers(params), x, remat=cfg.remat)
        return tfm.unembed(params, x, cfg)

    # ------------------------------------------------------------- serving
    def cache_specs(self, batch: int, max_seq: int) -> Params:
        """``max_seq`` is accepted for the dense signature: the state does
        not grow with the sequence."""
        cfg = self.cfg
        L, D = cfg.num_layers, cfg.d_model
        H, N = cfg.rwkv_num_heads, cfg.rwkv_head_dim
        dt = cm.torch_dtype(cfg.dtype)
        return {
            "wkv": ParamSpec((L, batch, H, N, N),
                             (ax.LAYERS, ax.BATCH, ax.HEADS, ax.HEAD_DIM,
                              None), init="zeros", dtype=torch.float32),
            "tshift": ParamSpec((L, batch, D), (ax.LAYERS, ax.BATCH,
                                                ax.EMBED),
                                init="zeros", dtype=dt),
            "cshift": ParamSpec((L, batch, D), (ax.LAYERS, ax.BATCH,
                                                ax.EMBED),
                                init="zeros", dtype=dt),
        }

    def _run_with_state(self, params: Params, tokens: torch.Tensor,
                        cache: Params) -> torch.Tensor:
        cfg = self.cfg
        x = tfm.embed(params, tokens, cfg)
        for i, pl in enumerate(self._layers(params)):
            states = {k: cache[k][i] for k in ("wkv", "tshift", "cshift")}
            x = rwkv_layer(pl, x, cfg, states=states, impl=self.impl,
                           chunk=self.wkv_chunk)
        return x

    def prefill(self, params: Params, tokens: torch.Tensor, cache: Params):
        """Run T prompt tokens from the cache's state; return
        (last_logits, cache), the cache updated in place."""
        x = self._run_with_state(params, tokens, cache)
        logits = tfm.unembed(params, x[:, -1:, :], self.cfg)
        return logits[:, 0, :], cache

    def decode_step(self, params: Params, tokens: torch.Tensor,
                    cache: Params, index, *, kv_seq_shard: bool = False):
        """One recurrent step; the position ``index`` and ``kv_seq_shard``
        are accepted for the dense signature and not read (O(1) state)."""
        del index, kv_seq_shard
        x = self._run_with_state(params, tokens, cache)
        logits = tfm.unembed(params, x, self.cfg)
        return logits[:, -1, :], cache
