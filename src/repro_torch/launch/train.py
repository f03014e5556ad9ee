"""Size presets of the LM training driver (``repro/launch/train.py``).

Only ``PRESETS`` and ``reduced_config`` live here for now: the serving
driver (``launch/serve.py``) shrinks an arch with them, as the reference's
does.  The LM training entry point (the reference's ``main``) is
queued (ROADMAP §A: launch/train.main); its pieces are ported
(``model_zoo.make_loss_fn``, ``training.make_train_step``,
``data.synthetic``).  The committee trainer is ``training/``.
"""
from __future__ import annotations

PRESETS = {
    # (layers, d_model, heads, kv, d_ff, vocab)
    "smoke": dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                  d_ff=256, vocab_size=2048),
    "100m": dict(num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
                 d_ff=2048, vocab_size=32768),
}


def reduced_config(cfg, preset: str):
    if preset == "full":
        return cfg
    ov = dict(PRESETS[preset])
    ov["dtype"] = "float32"
    if cfg.family == "moe":
        ov.update(moe_num_experts=8, moe_top_k=2, moe_group_size=256,
                  moe_shared_d_ff=512)
    if cfg.family == "hybrid":
        ov.update(num_layers=8, mamba_head_dim=32, mamba_d_state=8,
                  moe_num_experts=4, moe_top_k=2, moe_group_size=256)
    if cfg.family == "rwkv6":
        d = ov["d_model"]
        ov.update(rwkv_head_dim=32, num_heads=d // 32, num_kv_heads=d // 32,
                  rwkv_lora_rank=16, rwkv_decay_lora_rank=16)
    if cfg.family == "encdec":
        ov.update(encoder_layers=2, encoder_seq=96, rope_theta=0.0)
    if cfg.family == "vlm":
        ov.update(vision_tokens=16)
    return cfg.replace(**ov)
