"""InternVL2-2B backbone — an InternLM2-style dense LM with a STUB ViT
frontend [arXiv:2404.16821], ported from ``repro/models/internvl.py``.

The InternViT is a stub, as in the reference: the caller gives (B, 256,
2048) precomputed patch embeddings, projected by ``mm_proj`` into the LM's
embedding and used as a sequence prefix; text tokens fill the positions
after it.  The backbone is ``DenseLM`` (llama-like GQA, kv 8; its attention
runs the ported flash kernel).  ``forward`` returns logits for the text
positions only; ``prefill(..., patch_embeds=)`` fills the cache with the
prefix and the prompt, so decode positions start after both.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import base as ax
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm
from repro_torch.models.common import ParamSpec

Params = Dict[str, Any]
# leaves cast to the activation dtype before use (the projector too)
CAST_KEYS = tfm.MATMUL_KEYS + ("mm_proj",)


@dataclasses.dataclass
class InternVLM(tfm.DenseLM):
    """The vision-language LM behind the dense model's serving API;
    ``impl`` as ``DenseLM.impl``."""

    cast_keys = CAST_KEYS

    def param_specs(self) -> Params:
        s = tfm.param_specs(self.cfg)
        D = self.cfg.d_model
        # learned projector from the (stub) ViT patch space into the LM
        # embedding
        s["mm_proj"] = ParamSpec((D, D), (ax.EMBED, ax.EMBED))
        return s

    def _prefix_embed(self, params: Params, tokens: torch.Tensor,
                      patch_embeds: torch.Tensor) -> torch.Tensor:
        dt = cm.torch_dtype(self.cfg.dtype)
        tok_x = tfm.embed(params, tokens, self.cfg)
        patch = tfm._proj(patch_embeds.to(dt), params["mm_proj"])
        return torch.cat([patch, tok_x], dim=1)

    def _run(self, params: Params, x: torch.Tensor,
             cache: Optional[Params]) -> torch.Tensor:
        """The layers over x; without a cache (``forward``) under the remat
        policy, as the reference's ``scan_stack``."""
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        if cache is None:
            return tfm.scan_stack(self._layer_fn(positions),
                                  self._layers(params), x,
                                  remat=self.cfg.remat)
        rope = self._rope(positions)
        for i, pl in enumerate(self._layers(params)):
            x, _ = tfm.dense_layer(pl, x, self.cfg, positions=positions,
                                   cache=(cache["k"][i], cache["v"][i]),
                                   impl=self.impl, rope=rope)
        return x

    def forward(self, params: Params,
                batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Logits for the TEXT positions only: (B, T_text, V)."""
        patch = batch["patch_embeds"]
        x = self._run(params, self._prefix_embed(params, batch["tokens"],
                                                 patch), None)
        return tfm.unembed(params, x[:, patch.shape[1]:, :], self.cfg)

    def prefill(self, params: Params, tokens: torch.Tensor, cache: Params,
                patch_embeds: Optional[torch.Tensor] = None):
        """Fill the cache with the patch prefix and the T prompt tokens;
        return (last_logits, cache), the cache updated in place.  Without
        ``patch_embeds``, the dense model's prefill."""
        if patch_embeds is None:
            return super().prefill(params, tokens, cache)
        x = self._run(params, self._prefix_embed(params, tokens,
                                                 patch_embeds), cache)
        logits = tfm.unembed(params, x[:, -1:, :], self.cfg)
        return logits[:, 0, :], cache
