"""PAL at LM scale on the port: uncertainty-driven data selection for LM
training, the twin of ``examples/lm_active_distill.py``.

The five kernels instantiated with transformers:
  generator  = prompt sampler proposing candidate sequences
  prediction = a committee of K small LMs; disagreement = std over members
               of sequence mean-NLL (``core/committee.lm_token_nll``)
  oracle     = a larger 'teacher' LM that labels sequences (next-token
               targets = teacher greedy continuations) — the stand-in for
               expensive ground truth, exactly the paper's oracle role
  training   = the shared fused committee trainer
               (``training/committee_trainer.py``): every student advances
               in one step program per step (one CUDA-graph replay on the
               card) on teacher-labeled sequences from the device replay
               ring
  controller = the same Exchange/Manager machinery as the MD example

Prediction runs on the unified acquisition engine: the student committee is
a ``CommitteeSpec`` (stacked params, ``torch.func.vmap``-ed seq-NLL
forward) and selection is a CUSTOM rule pipeline — threshold + top-fraction
cap on teacher traffic — inside the fused program, so each exchange
iteration is one replay of its bucket's captured graph on the card (the
committee forward, the ``committee_uq`` kernel and the rules).

The students run the plain attention (``impl="plain"``), as the
reference's students run its plain ``impl="xla"`` attention and no Pallas
kernel: their forward runs under ``torch.func.vmap`` over the committee
(in the engine's captured graph and in the trainer's), and the flash
kernel's ``ctypes`` launch has no vmap rule.  The teacher runs the normal
entry (``impl="auto"``): on the card every one of its attention calls is
the flash kernel (head dim 16).

  PYTHONPATH=src python -m repro_torch.examples.lm_active_distill
  PYTHONPATH=src python -m repro_torch.examples.lm_active_distill \\
      --device cpu --timeout 20

``--device`` defaults to the CUDA card (and fails without one).  The run
stops at 120 labelled sequences or at ``--timeout`` seconds, whichever
comes first, as the reference's does.
"""
from __future__ import annotations

import argparse
import tempfile
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.pal_potential import PALRunConfig
from repro_torch.core import (PAL, CommitteeSpec, ThresholdRule,
                              TopFractionRule, UserGene, UserOracle)
from repro_torch.core import committee as cmte
from repro_torch.kernels.graphs import PerShape
from repro_torch.launch.platform import DeviceLike, resolve_device
from repro_torch.models.model_zoo import build_model
from repro_torch.models.transformer import lm_loss

SEQ = 32
VOCAB = 512
TARGET_LABELS = 120
TEACHER_SEED = 42

STUDENT = ModelConfig(
    name="student", family="dense", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=128, vocab_size=VOCAB, dtype="float32",
    param_dtype="float32", remat="none")
TEACHER = ModelConfig(
    name="teacher", family="dense", num_layers=4, d_model=128, num_heads=8,
    num_kv_heads=4, d_ff=256, vocab_size=VOCAB, dtype="float32",
    param_dtype="float32", remat="none")


def run_config(result_dir: str) -> PALRunConfig:
    """The reference's configuration: 8 prompt generators, 2 teacher
    workers, 3 students, retrain blocks of 24, 30 fused steps a round at
    batch 16, a 512-row ring, weights handed over every round."""
    return PALRunConfig(
        result_dir=result_dir,
        gene_process=8, orcl_process=2, pred_process=3, ml_process=3,
        retrain_size=24, std_threshold=0.08, patience=1000,
        weight_sync_every=1,
        train_steps=30, train_batch=16, train_lr=1e-3,
        train_replay_capacity=512)


def rules(cfg: PALRunConfig):
    """Disagreement threshold, then cap teacher traffic at the 50 % most
    uncertain."""
    return (ThresholdRule(cfg.std_threshold), TopFractionRule(0.5))


class PromptGene(UserGene):
    def __init__(self, rank, rd):
        super().__init__(rank, rd)
        self.rng = np.random.RandomState(rank)

    def generate_new_data(self, data_to_gene):
        # structured prompts: arithmetic-ish token patterns in a band
        start = self.rng.randint(0, VOCAB - SEQ)
        stride = self.rng.randint(1, 5)
        seq = (start + stride * np.arange(SEQ)) % VOCAB
        return False, seq.astype(np.float32)   # transport is float 1-D


_STUDENT_MODEL = build_model(STUDENT, impl="plain")


def student_loss(p, batch):
    """ONE student's distillation loss for the fused committee trainer:
    next-token cross entropy on the teacher-labeled sequence (``batch["y"]``
    is the oracle output — prompt head + teacher continuation — shipped as
    float over the paper's 1-D transport and cast back here)."""
    toks = batch["y"].to(torch.int32)
    logits = _STUDENT_MODEL.forward(p, {"tokens": toks[:, :-1]})
    return lm_loss(logits, toks[:, 1:])[0], {}


def member_nll(p, x):                           # (n, SEQ) float -> (n, 1)
    """One student's per-sequence mean token NLL over a float token batch:
    the ``apply_fn`` of the committee spec."""
    toks = x.to(torch.int32)
    logits = _STUDENT_MODEL.forward(p, {"tokens": toks[:, :-1]})
    return torch.mean(cmte.lm_token_nll(logits, toks[:, 1:]), dim=-1,
                      keepdim=True)


class TeacherOracle(UserOracle):
    """The teacher LM on ``device`` (default: the CUDA device; raises
    without it): random weights drawn from a generator seeded
    ``TEACHER_SEED`` (every worker draws the same teacher), or the
    ``params`` given.  As the reference jits ``relabel``, each worker runs
    it as one program per input shape: on the card a CUDA graph captured
    on the worker's own stream (``kernels.graphs.PerShape``; its flash
    launches counted by replay) and replayed for every label; on the CPU
    eagerly.  ``captures`` counts the graphs."""

    def __init__(self, rank, rd, device: DeviceLike = None,
                 params: Optional[Any] = None):
        super().__init__(rank, rd)
        self.device = resolve_device(device)
        self.model = build_model(TEACHER)
        if params is None:
            params = self.model.init(
                torch.Generator(device=self.device).manual_seed(
                    TEACHER_SEED), device=self.device)
        self.params = params
        self._relabel = (PerShape(self.relabel, self.device)
                         if self.device.type == "cuda" else None)

    @property
    def captures(self) -> int:
        return self._relabel.captures if self._relabel is not None else 0

    def relabel(self, tokens: torch.Tensor) -> torch.Tensor:
        """The teacher's next-token map (B, T) -> (B, T)."""
        with torch.no_grad():
            logits = self.model.forward(self.params, {"tokens": tokens})
        return torch.argmax(logits, dim=-1)

    def _relabel_program(self, tokens: torch.Tensor) -> torch.Tensor:
        """``relabel`` of host ``tokens``: eagerly on the CPU, else a
        replay of the graph of their shape (captured at first use)."""
        if self._relabel is None:
            return self.relabel(tokens)
        return self._relabel(tokens)

    def run_calc(self, inp):
        toks = torch.from_numpy(inp.astype(np.int32))[None]
        teacher_next = self._relabel_program(toks)[0].numpy()
        # labeled sequence: prompt token followed by teacher continuation
        labeled = np.concatenate([inp[:1].astype(np.int32),
                                  teacher_next.astype(np.int32)])
        return inp, labeled.astype(np.float32)


def make_student_committee(n_members: int,
                           cparams: Optional[Any] = None) -> CommitteeSpec:
    """Stacked student committee for the fused engine (on the CPU; PAL
    copies it to its device): member i drawn from a generator seeded i, or
    the stacked ``cparams`` given."""
    if cparams is None:
        cparams = cmte.stack_members([
            _STUDENT_MODEL.init(torch.Generator().manual_seed(i),
                                device="cpu")
            for i in range(n_members)])
    return CommitteeSpec(member_nll, cparams)


def make_pal(result_dir: str, device: DeviceLike = None,
             oracle=None) -> PAL:
    """The reference's PAL at LM scale on ``device``; ``oracle``: the
    teacher's class (default ``TeacherOracle``)."""
    dev = resolve_device(device)
    cfg = run_config(result_dir)
    oracle = oracle or TeacherOracle
    return PAL(cfg, make_generator=PromptGene,
               make_oracle=lambda r, d: oracle(r, d, device=dev),
               committee=make_student_committee(cfg.pred_process),
               loss_fn=student_loss, rules=rules(cfg), device=dev)


def run_until(pal: PAL, timeout: float, target: int = TARGET_LABELS):
    """Start ``pal`` and stop it at ``target`` labelled sequences or after
    ``timeout`` seconds; returns (what stopped it, wall seconds)."""
    pal.start()
    t0 = time.perf_counter()
    while (pal.train_buffer.total_labeled < target
           and time.perf_counter() - t0 < timeout):
        time.sleep(0.25)
    wall = time.perf_counter() - t0
    stopped_by = ("labels" if pal.train_buffer.total_labeled >= target
                  else "timeout")
    pal.shutdown()
    return stopped_by, wall


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="run budget in seconds")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch path; default: the "
                         "CUDA card")
    args = ap.parse_args(argv)
    pal = make_pal(tempfile.mkdtemp(prefix="pal_lm_"), args.device)
    print(f"running PAL at LM scale on {pal.device} (8 prompt generators, "
          f"3 student LMs, 2 teacher oracles, fused engine and trainer)...")
    stopped_by, wall = run_until(pal, args.timeout)
    rep = pal.report()
    c = rep["counters"]
    print(f"stopped by          : {stopped_by} after {wall:.2f} s")
    print(f"labeled sequences   : {rep['labeled_total']}")
    print(f"exchange iterations : {c.get('exchange.iterations')}")
    print(f"retrains            : {c.get('train.retrains')}")
    print(f"fused train steps   : {rep['train_fused_steps']}")
    print(f"device weight hands : {rep['device_weight_refreshes']}")
    sel_frac = rep["labeled_total"] / max(
        c.get("exchange.iterations", 1) * pal.cfg.gene_process, 1)
    print(f"selection fraction  : {sel_frac:.3f} "
          f"(uncertainty filter at work — only disagreed-on sequences "
          f"hit the teacher)")
    if rep["labeled_total"] <= 0:
        raise RuntimeError("the distillation loop labelled nothing")
    print("OK")
    return rep


if __name__ == "__main__":
    main()
