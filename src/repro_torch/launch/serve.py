"""Batched LM serving driver: prefill a prompt batch, decode N tokens, report
prefill latency and decode throughput (the twin of ``repro/launch/serve.py``,
with ``--device``; the CUDA device by default, and an error without it).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --preset full --batch 8 --prompt-len 512 --gen 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \\
      --preset full --batch 8 --prompt-len 512 --gen 64
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --preset smoke
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch jamba-1.5-large-398b --preset smoke

``--preset full`` of the hybrid and MoE families raises at once: their
parameters do not fit one card (jamba-1.5-large-398b 397.6 B,
qwen2-moe-a2.7b 14.3 B, qwen3-moe-235b-a22b 235.1 B, at 6 bytes each).  The
one-card cuts (``ONE_CARD_CUT`` in ``configs/jamba1p5_large_398b.py``,
``configs/qwen2_moe_a2p7b.py`` and ``configs/qwen3_moe_235b_a22b.py``) run
through ``chip_smoke.py`` and ``launch/lm_profile.py``.  whisper-small gets random frame
embeddings (B, encoder_seq, d_model) and internvl2-2b random patch
embeddings (B, vision_tokens, d_model), as the reference's CLI gives
them.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.launch import platform
from repro_torch.launch.train import reduced_config
from repro_torch.models import model_zoo
from repro_torch.serving import ServeEngine


def prefill_inputs(cfg, batch: int, rng: np.random.RandomState):
    """The prefill's inputs beside the tokens, random at scale 0.02 as the
    reference's CLI makes them: whisper's frame embeddings (batch,
    encoder_seq, d_model), InternVL's patch embeddings (batch,
    vision_tokens, d_model); none for the other families."""
    if cfg.family == "encdec":
        return {"enc_embeds": rng.randn(
            batch, cfg.encoder_seq, cfg.d_model).astype(np.float32) * .02}
    if cfg.family == "vlm":
        return {"patch_embeds": rng.randn(
            batch, cfg.vision_tokens, cfg.d_model).astype(np.float32) * .02}
    return {}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="llama3.2-1b")
    p.add_argument("--preset", default="smoke", choices=["smoke", "100m",
                                                         "full"])
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=64)
    p.add_argument("--gen", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    spec = get_arch(args.arch)
    cfg = reduced_config(spec.model, args.preset)
    if cfg.family in ("hybrid", "moe") and args.preset == "full":
        n = model_zoo.count_params(cfg)
        raise ValueError(
            f"{args.arch} --preset full: {n / 1e9:.1f} B parameters do not "
            f"fit one card (the engine keeps fp32 weights and a bf16 copy, "
            f"{6 * n / 1e9:.1f} GB); a one-card cut (ONE_CARD_CUT in the "
            f"arch's config, where it has one) runs through chip_smoke.py")
    dev = platform.resolve_device(args.device)
    max_seq = args.prompt_len + args.gen + (
        cfg.vision_tokens if cfg.family == "vlm" else 0)
    model = model_zoo.build_model(cfg, max_seq=max_seq)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed),
                        device=dev)

    rng = np.random.RandomState(args.seed)
    batch = {"tokens": rng.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)}
    batch.update(prefill_inputs(cfg, args.batch, rng))

    eng = ServeEngine(model, params, max_seq=max_seq, batch=args.batch,
                      temperature=args.temperature, seed=args.seed,
                      device=dev)
    res = eng.generate(batch, max_new_tokens=args.gen)
    info = platform.describe()
    print(json.dumps({
        "arch": args.arch, "preset": args.preset,
        "batch": args.batch, "prompt_len": args.prompt_len,
        "generated": int(res.tokens.shape[1] - args.prompt_len),
        "prefill_seconds": round(res.prefill_seconds, 4),
        "decode_seconds": round(res.decode_seconds, 4),
        "decode_tokens_per_s": round(res.decode_tokens_per_s, 1),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "nvidia_smi": info["nvidia_smi"],
    }))


if __name__ == "__main__":
    main()
