"""Small configs of the four LM archs served last (h2o-danube-3-4b,
minicpm-2b, mistral-nemo-12b, qwen3-moe-235b-a22b), each keeping the
feature that sets its arch apart, for the CPU parity tests and the card
tests (this module imports no JAX):

* danube: a sliding window (16) shorter than the sequences the tests run
  (48 positions), 4 query heads over 1 kv head of 120, a head dim that is
  not a power of two, as the published 3840 / 32 (set as ``head_dim`` here,
  for the reason below);
* minicpm: MHA (H = KV), tied embeddings and a vocab of 300, which is no
  multiple of 128 (padded to 384), as the published 122753;
* nemo: an explicit head dim with H * hd = 256 != d_model = 96, as the
  published 32 x 128 != 5120;
* qwen3-moe: qk-norm, 16 experts top-8, 16 query heads over 1 kv head (G =
  16: one decode token is more (t, g) rows than the split kernel holds).

Everything else (rope theta, tie, qk-norm, capacity factor 1.25, group
size) stays the arch's own.

d_model is 64 to 128 beside the query width: the reference's init draws a
(D, H, hd) projection with std 1/sqrt(H), so the attention scores of a
random model have a std of about D / sqrt(H * KV) (qk-norm aside), and at
the published ratio (240 for danube, 64 for minicpm) fp32 round-off in a
score of several hundred moves the near one-hot softmax by more than the
1e-4 tolerance (both packages alike: measured 3.3e-4 to 1.2e-3 between
them on a few cache entries at d_model = H * hd).  The configs keep the
ratio at 32 or below, where both packages' fp32 round-off stays inside
it."""

ARCHS = ["h2o-danube-3-4b", "minicpm-2b", "mistral-nemo-12b",
         "qwen3-moe-235b-a22b"]
WINDOW = 16                 # danube's window at the small size
PROMPT, STEPS = 40, 8       # 48 positions: the window binds in both

SMALL = {
    "h2o-danube-3-4b": dict(num_layers=2, d_model=64, num_heads=4,
                            num_kv_heads=1, head_dim=120, d_ff=128,
                            vocab_size=256, sliding_window=WINDOW),
    "minicpm-2b": dict(num_layers=2, d_model=64, num_heads=4,
                       num_kv_heads=4, d_ff=128, vocab_size=300),
    "mistral-nemo-12b": dict(num_layers=2, d_model=96, num_heads=4,
                             num_kv_heads=2, head_dim=64, d_ff=192,
                             vocab_size=256),
    "qwen3-moe-235b-a22b": dict(num_layers=2, d_model=128, num_heads=16,
                                num_kv_heads=1, head_dim=64, d_ff=32,
                                vocab_size=256, moe_num_experts=16,
                                moe_top_k=8),
}


def small(model_cfg, arch, **kw):
    """``model_cfg`` (the arch's published ModelConfig, of either package)
    at its small size in fp32 with no remat, ``kw`` on top."""
    return model_cfg.replace(**{**SMALL[arch], "dtype": "float32",
                                "remat": "none", **kw})
