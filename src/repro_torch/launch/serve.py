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

``--preset full`` of jamba-1.5-large-398b raises at once: its 397.6 B
parameters do not fit one card.  Its one-card cut (``ONE_CARD_CUT`` in
``configs/jamba1p5_large_398b.py``) runs through ``launch/lm_profile.py``
and ``chip_smoke.py``.
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
    if cfg.family == "hybrid" and args.preset == "full":
        n = model_zoo.count_params(cfg)
        raise ValueError(
            f"{args.arch} --preset full: {n / 1e9:.1f} B parameters do not "
            f"fit one card (the engine keeps fp32 weights and a bf16 copy, "
            f"{6 * n / 1e9:.1f} GB); its one-card cut ONE_CARD_CUT runs "
            f"through launch/lm_profile.py and chip_smoke.py")
    dev = platform.resolve_device(args.device)
    max_seq = args.prompt_len + args.gen + (
        cfg.vision_tokens if cfg.family == "vlm" else 0)
    model = model_zoo.build_model(cfg, max_seq=max_seq)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed),
                        device=dev)

    rng = np.random.RandomState(args.seed)
    batch = {"tokens": rng.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)}

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
