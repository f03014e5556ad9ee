"""End-to-end LM training: the reference's ``repro/launch/train.py``.

Runs real steps on the card (or, with ``--device cpu``, eagerly on the
CPU): the synthetic deterministic stream, AdamW and the arch's schedule,
periodic async checkpoints with resume, throughput logging.  ``--preset
smoke`` shrinks any arch to a CPU-runnable config; ``--preset 100m`` is the
~100M-param run; ``--preset full`` is the published config.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --preset full --steps 30 --batch 8 --seq 512

The step is ``training.CapturedTrainStep``: one CUDA graph per batch
shape, the state updated in place (the reference jits its step with the
state donated).  Batches go ``SyntheticTokenStream`` -> ``Prefetcher`` ->
a pinned copy -> the graph's static batch buffers (the caching host
allocator reuses a pinned block only once the copy out of it has
finished).
``--resume`` restores the latest checkpoint into the live state tensors
and starts the stream at its step.  The model runs the plain attention and
scans (``impl="plain"``), as the reference trains through its plain
``xla`` path: the hand kernels have no backward.  Each layer runs under
the arch's remat policy (``cfg.remat``: "dots" for every arch, the smoke
preset included, as the reference's ``reduced_config`` keeps it); the
step takes its gradients through ``torch.autograd.grad``
(``training/train_step.py``).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.utils._pytree as pytree

from repro_torch.checkpoint import AsyncCheckpointer
from repro_torch.configs import get_arch
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.data.prefetch import Prefetcher
from repro_torch.data.synthetic import SyntheticTokenStream
from repro_torch.launch.platform import DeviceLike, resolve_device
from repro_torch.models import model_zoo
from repro_torch.training.train_step import (
    CapturedTrainStep, TrainState, make_train_state,
)

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


def train_config(arch: str, steps: int, lr: float) -> TrainConfig:
    """The reference's rule (``launch/train.py``): warm-up ``min(50, steps // 10 + 1)``,
    decay over ``steps``, the arch's schedule and WSD plateau."""
    spec = get_arch(arch)
    return TrainConfig(
        learning_rate=lr, warmup_steps=min(50, steps // 10 + 1),
        decay_steps=steps, schedule=spec.train.schedule,
        stable_steps=spec.train.stable_steps)


def train(arch: str = "llama3.2-1b", preset: str = "smoke", *,
          steps: int = 50, batch: int = 8, seq: int = 256, lr: float = 3e-4,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 100,
          log_every: int = 10, seed: int = 0, resume: bool = False,
          device: DeviceLike = None, capture: bool = True,
          model_cfg: Optional[ModelConfig] = None,
          init_state: Optional[TrainState] = None) -> Dict[str, Any]:
    """The reference's training loop; returns what it ran.

    ``device``: default the CUDA device (raises without it).  ``capture``:
    ``False`` runs the step eagerly on the card.  ``model_cfg`` replaces
    the preset's config; ``init_state`` replaces the random init (copied
    to ``device``; the copy is written in place).  A checkpoint is saved
    every ``ckpt_every`` steps and after the last step.

    Returns ``metrics`` (one dict of host floats per step run),
    ``start_step``, ``steps``, ``final_loss``, ``tokens_per_second``,
    ``seconds``, ``step_ms`` (CUDA events around each step on the card,
    the batch's copy included; empty on the CPU), ``step_start_ms`` (each
    step's start after the first's, by the same events), ``busy_share``
    (the steps' sum over the events' span), ``n_params``, ``captures``,
    ``replays``,
    ``peak_bytes`` and the ``step`` object (its ``state`` the live
    state)."""
    dev = resolve_device(device)
    cfg = model_cfg if model_cfg is not None else reduced_config(
        get_arch(arch).model, preset)
    shape = ShapeConfig("cli", seq, batch, "train")
    train_cfg = train_config(arch, steps, lr)

    model = model_zoo.build_model(cfg, impl="plain", max_seq=seq)
    n_params = model_zoo.count_params(cfg, max_seq=seq)
    print(f"arch={arch} preset={preset} params={n_params/1e6:.1f}M")

    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    if init_state is None:
        params = model.init(torch.Generator(dev).manual_seed(seed),
                            device=dev)
        state = make_train_state(params, train_cfg)
    else:
        state = pytree.tree_map(lambda t: t.to(dev, copy=True), init_state)
    step_fn = CapturedTrainStep(model_zoo.make_loss_fn(model), train_cfg,
                                state, capture=capture)

    ckpt = None
    start_step = 0
    if ckpt_dir:
        ckpt = AsyncCheckpointer(ckpt_dir)
        if resume:
            snap = ckpt.restore_latest()
            if snap is not None:
                step_fn.load_state_(snap["tree"])
                start_step = snap["step"]
                print(f"resumed at step {start_step}")

    stream = SyntheticTokenStream(cfg, shape, seed=seed, step=start_step)
    it = Prefetcher(stream, depth=2)
    history: List[Dict[str, torch.Tensor]] = []
    marks: List[torch.cuda.Event] = []
    metrics: Optional[Dict[str, torch.Tensor]] = None
    t0 = time.time()
    tokens_seen = 0
    try:
        for i in range(start_step, steps):
            host = {k: torch.from_numpy(v) for k, v in next(it).items()}
            if cuda:
                host = {k: v.pin_memory() for k, v in host.items()}
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()
                metrics = step_fn(host)
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()
            else:
                metrics = step_fn(host)
            history.append({k: v.detach().clone()
                            for k, v in metrics.items()})
            tokens_seen += batch * seq
            if (i + 1) % log_every == 0 or i + 1 == steps:
                loss = float(metrics["loss"])
                dt = time.time() - t0
                print(f"step {i+1:5d} loss={loss:.4f} "
                      f"lr={float(metrics['lr']):.2e} "
                      f"gnorm={float(metrics['grad_norm']):.2f} "
                      f"tok/s={tokens_seen/dt:,.0f}", flush=True)
            if ckpt and ((i + 1) % ckpt_every == 0 or i + 1 == steps):
                ckpt.save(i + 1, step_fn.state)
        if ckpt:
            ckpt.wait()
    finally:
        it.close()
    if cuda:    # the step's stream joins the caller's after every step
        torch.cuda.current_stream(dev).synchronize()
    seconds = time.time() - t0
    step_ms = [a.elapsed_time(b) for a, b in zip(marks[::2], marks[1::2])]
    step_start_ms = [marks[0].elapsed_time(a) for a in marks[::2]]
    span = marks[0].elapsed_time(marks[-1]) if marks else 0.0
    per_step = [{k: float(v) for k, v in h.items()} for h in history]
    return {
        "metrics": per_step, "start_step": start_step, "steps": steps,
        "final_loss": per_step[-1]["loss"] if per_step else float("nan"),
        "tokens_per_second": tokens_seen / seconds if seconds else 0.0,
        "seconds": seconds, "step_ms": step_ms,
        "step_start_ms": step_start_ms,
        "busy_share": sum(step_ms) / span if span else 0.0,
        "n_params": n_params, "captures": step_fn.captures,
        "replays": step_fn.replays,
        "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else 0,
        "step": step_fn}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="llama3.2-1b")
    p.add_argument("--preset", default="smoke",
                   choices=["smoke", "100m", "full"])
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=100)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default=None,
                   help="default: the CUDA device (raises without it); "
                        "'cpu' runs the step eagerly on the CPU")
    args = p.parse_args(argv)
    out = train(args.arch, args.preset, steps=args.steps, batch=args.batch,
                seq=args.seq, lr=args.lr, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, log_every=args.log_every,
                seed=args.seed, resume=args.resume, device=args.device)
    print(json.dumps({"final_loss": out["final_loss"],
                      "steps": args.steps,
                      "tokens_per_second": out["tokens_per_second"]}))
    return out


if __name__ == "__main__":
    main()
