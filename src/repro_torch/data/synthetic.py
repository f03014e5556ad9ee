"""Deterministic synthetic token streams (training substrate): a copy of the
reference's ``repro/data/synthetic.py`` (numpy only; the same bits).

Tokens are a cheap stateless hash of (seed, step, batch row, position) so
any worker can materialize its own shard without coordination, restarts are
bit-exact (resume at `step`), and per-dp-rank sharding is a pure slice.
Frontend-stub inputs (whisper frames / internvl patches) come from the same
counter-hash path as uniform floats.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig

_M = np.uint64(0x9E3779B97F4A7C15)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + _M).astype(np.uint64)
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def _hash_grid(seed: int, step: int, rows: np.ndarray,
               cols: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):  # uint64 wraparound is the point
        base = np.uint64(seed) * np.uint64(0x2545F4914F6CDD1D) + \
            np.uint64(step) * np.uint64(0x100000001B3)
        grid = (rows[:, None].astype(np.uint64) << np.uint64(32)) \
            | cols[None, :].astype(np.uint64)
        return _splitmix64(grid + base)


def synthetic_tokens(seed: int, step: int, batch: int, seq: int,
                     vocab: int, row_offset: int = 0) -> np.ndarray:
    rows = np.arange(row_offset, row_offset + batch)
    cols = np.arange(seq + 1)
    h = _hash_grid(seed, step, rows, cols)
    return (h % np.uint64(vocab)).astype(np.int32)


def synthetic_floats(seed: int, step: int, shape: Tuple[int, ...],
                     scale: float = 1.0) -> np.ndarray:
    n = int(np.prod(shape))
    h = _hash_grid(seed ^ 0x5F0F, step, np.arange(1), np.arange(n))[0]
    u = (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)
    return ((u * 2.0 - 1.0) * scale).astype(np.float32).reshape(shape)


def synthetic_batch(cfg: ModelConfig, shape: ShapeConfig, step: int,
                    seed: int = 0, dp_rank: int = 0,
                    dp_size: int = 1) -> Dict[str, np.ndarray]:
    """One training batch shard for (arch, shape) at `step`.

    tokens/labels are the usual shifted pair; modality stubs are attached
    per family.  dp sharding slices the global batch.
    """
    gb = shape.global_batch
    assert gb % dp_size == 0, (gb, dp_size)
    b = gb // dp_size
    off = dp_rank * b
    seq = shape.seq_len
    if cfg.family == "vlm":
        t_text = seq - cfg.vision_tokens
        grid = synthetic_tokens(seed, step, b, t_text, cfg.vocab_size, off)
        batch = {"tokens": grid[:, :-1], "labels": grid[:, 1:]}
        batch["patch_embeds"] = synthetic_floats(
            seed, step, (b, cfg.vision_tokens, cfg.d_model), 0.02)
        return batch
    grid = synthetic_tokens(seed, step, b, seq, cfg.vocab_size, off)
    batch = {"tokens": grid[:, :-1], "labels": grid[:, 1:]}
    if cfg.family == "encdec":
        batch["enc_embeds"] = synthetic_floats(
            seed, step, (b, cfg.encoder_seq, cfg.d_model), 0.02)
    return batch


@dataclasses.dataclass
class SyntheticTokenStream:
    """Stateful iterator over synthetic_batch, resumable at any step."""

    cfg: ModelConfig
    shape: ShapeConfig
    seed: int = 0
    dp_rank: int = 0
    dp_size: int = 1
    step: int = 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = synthetic_batch(self.cfg, self.shape, self.step, self.seed,
                            self.dp_rank, self.dp_size)
        self.step += 1
        return b

    def state_dict(self):
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, s):
        self.step = int(s["step"])
        self.seed = int(s["seed"])
