"""Where one LM ``generate`` spends its time, on the CUDA card.

    PYTHONPATH=src python -m repro_torch.launch.lm_profile [--out F]
    PYTHONPATH=src python -m repro_torch.launch.lm_profile --arch rwkv6-7b
    PYTHONPATH=src python -m repro_torch.launch.lm_profile \\
        --arch jamba-1.5-large-398b
    PYTHONPATH=src python -m repro_torch.launch.lm_profile \\
        --arch whisper-small --prompt-len 64

Builds ``--arch`` (default llama3.2-1b; any of the ten) at full width,
with random weights from ``--seed``, behind ``ServeEngine``
(jamba-1.5-large-398b, qwen2-moe-a2.7b and qwen3-moe-235b-a22b as their
one-card cuts, ``ONE_CARD_CUT``, every width published; whisper-small and
internvl2-2b with ``launch/serve.py``'s random frame / patch embeddings),
and reports,
each line with the card's name and power limit:

* one ``generate`` of ``--batch`` prompts of ``--prompt-len`` tokens and
  ``--gen`` new tokens, after a first one that captured the engine's
  prefill and decode graphs: prefill seconds, decode seconds per step,
  decode tokens/s (host clock around synchronized work, the graphs
  replayed), peak device memory;
* a ``torch.profiler`` table of the device kernels of one prefill and of
  ``--profile-steps`` decode steps, run op by op (``model.prefill`` and
  ``model.decode_step``, the engine's eager form): device time of the hand-written
  kernels (``flash_attention``, ``wkv6``, ``ssd``), of the matrix
  products (cuBLAS's ``nvjet``/``gemm`` kernels) and of the rest, and
  each hand-written kernel's share of device time;
* the device's busy share: that device time over the host-clock wall of
  the same work run again without the profiler (the profiler's own host
  overhead would inflate the wall it sees).

Writes the numbers as JSON to ``--out`` (default
``results/torch_lm_profile.json``).  Needs CUDA.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.configs import (jamba1p5_large_398b, qwen2_moe_a2p7b,
                                 qwen3_moe_235b_a22b)
from repro_torch.launch import platform, serve
from repro_torch.models import model_zoo
from repro_torch.serving import ServeEngine

# every kernel symbol of each hand-written kernel: flash's tiled prefill
# kernel, its split-KV decode kernels (bf16 mma, fp32) and their merge, and
# its fp32 prefill kernel; wkv6's and ssd's bf16 (mma) and fp32 kernels
KERNEL_GROUPS = (("flash_attention", ("flash_tiled_kernel",
                                      "flash_split_mma_kernel",
                                      "flash_split_kernel",
                                      "flash_combine_kernel",
                                      "flash_attention_kernel")),
                 ("wkv6", ("wkv6_mma_kernel", "wkv6_fp32_kernel")),
                 ("ssd", ("ssd_mma_kernel", "ssd_fp32_kernel")))
# archs too large for one card, cut as their config files state
ONE_CARD_CUTS = {"jamba-1.5-large-398b": jamba1p5_large_398b.ONE_CARD_CUT,
                 "qwen2-moe-a2.7b": qwen2_moe_a2p7b.ONE_CARD_CUT,
                 "qwen3-moe-235b-a22b": qwen3_moe_235b_a22b.ONE_CARD_CUT}
GROUPS = KERNEL_GROUPS + (
    ("matmul", ("nvjet", "gemm", "cutlass", "xmma", "sm90_")),)


def _group(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def _wall_us(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6


def _profile(fn, what: str, card: str):
    """Run ``fn`` once under the profiler (device time by kernel group),
    then once without it (host-clock wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_us = _wall_us(fn)
    groups = {g: 0.0 for g, _ in GROUPS}
    groups["other"] = 0.0
    kernels, top = 0, []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        groups[_group(ev.key)] += dev_us
        kernels += ev.count
        top.append((dev_us, ev.count, ev.key[:100]))
    busy = sum(groups.values())
    top.sort(reverse=True)
    out = {"wall_us": wall_us, "device_us": busy, "kernels": kernels,
           "groups_us": groups,
           "kernel_shares": {g: groups[g] / busy if busy else None
                             for g, _ in KERNEL_GROUPS},
           "busy_share": busy / wall_us,
           "top": [{"device_us": u, "count": c, "name": k}
                   for u, c, k in top[:12]]}
    if busy == 0:
        print(f"{what}: the profiler recorded no device time (not "
              f"measured) [{card}]")
        return out
    print(f"{what}: {wall_us:.1f} us wall unprofiled, {busy:.1f} us of device "
          f"kernels ({kernels} kernels; busy {100 * busy / wall_us:.2f} %): "
          + ", ".join(f"{g} {u:.1f} us ({100 * u / busy:.2f} %)"
                      for g, u in groups.items()) + f" [{card}]")
    for u, c, k in top[:12]:
        print(f"  {u:11.1f} us  x{c:<5d} {k}")
    return out


def profile(arch: str, batch: int, prompt_len: int, gen: int,
            profile_steps: int, seed: int):
    info = platform.describe()
    card = info["nvidia_smi"]
    platform.set_reference_precision()
    cfg = get_arch(arch).model.replace(**ONE_CARD_CUTS.get(arch, {}))
    n_prefix = cfg.vision_tokens if cfg.family == "vlm" else 0
    max_seq = n_prefix + prompt_len + gen
    model = model_zoo.build_model(cfg, max_seq=max_seq)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed),
                        device="cuda")
    eng = ServeEngine(model, params, max_seq=max_seq, batch=batch,
                      device="cuda")
    rng = np.random.RandomState(seed)
    prompt = rng.randint(0, cfg.vocab_size, (batch, prompt_len)).astype(
        np.int32)
    extras = serve.prefill_inputs(cfg, batch, rng)
    inputs = dict(tokens=prompt, **extras)
    eng.generate(inputs, max_new_tokens=4)                      # warm-up
    torch.cuda.reset_peak_memory_stats()
    res = eng.generate(inputs, max_new_tokens=gen)
    out = {"device": info, "arch": arch, "cut": ONE_CARD_CUTS.get(arch),
           "batch": batch,
           "prompt_len": prompt_len, "gen": gen,
           "prefill_s": res.prefill_seconds,
           "decode_s_per_step": res.decode_seconds / max(gen - 1, 1),
           "decode_tokens_per_s": res.decode_tokens_per_s,
           "peak_bytes": torch.cuda.max_memory_allocated()}
    print(f"{arch} B={batch} prompt={prompt_len} gen={gen}: prefill "
          f"{res.prefill_seconds * 1e3:.4f} ms, decode "
          f"{out['decode_s_per_step'] * 1e3:.4f} ms per step "
          f"({res.decode_tokens_per_s:.1f} tokens/s), peak "
          f"{out['peak_bytes'] / 2**30:.3f} GiB [{card}]")

    tokens = torch.from_numpy(prompt).to("cuda")
    ex_t = {k: torch.from_numpy(v).to("cuda") for k, v in extras.items()}
    state = {}

    def prefill():
        cache = model.init_cache(batch, max_seq, device="cuda")
        state["logits"], state["cache"] = model.prefill(eng.params, tokens,
                                                        cache, **ex_t)

    def decode():
        cur = torch.argmax(state["logits"], -1).to(torch.int32)[:, None]
        for i in range(profile_steps):
            logits, _ = model.decode_step(eng.params, cur, state["cache"],
                                          n_prefix + prompt_len + i)
            cur = torch.argmax(logits, -1).to(torch.int32)[:, None]

    from torch.profiler import profile as tprofile
    with tprofile():                     # the profiler's one-time start-up
        prefill()
    out["prefill_profile"] = _profile(prefill, "prefill", card)
    out["decode_profile"] = _profile(
        decode, f"{profile_steps} decode steps", card)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--profile-steps", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="results/torch_lm_profile.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lm_profile: CUDA is not available", file=sys.stderr)
        return 1
    out = profile(args.arch, args.batch, args.prompt_len, args.gen,
                  args.profile_steps, args.seed)
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1, default=str))
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
