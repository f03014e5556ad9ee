#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one CUDA card.

    PYTHONPATH=src python3 chip_smoke.py

Phases (each raises on a failed check; the script exits non-zero):

1. describe the card and build every CUDA kernel from ``src/repro_torch/
   kernels/csrc`` (one ``nvcc`` per source, all started together);
2. committee kernel phase: both entries of ``committee_uq`` (the five
   outputs; the engine's packed entry, which also masks rows past a
   device-resident ``n_valid``) against their plain PyTorch versions on
   the same CUDA tensors, over a sweep of shapes including non-finite
   members, in fp32 and (the kernel's own load path) bf16 and fp16, and
   timed beside their plain versions, their bound and the nearest one-call
   PyTorch yardstick at the serving shape and at (4, 65536, 24), and an
   empty one-thread kernel beside them (the launch floor);
3. committee serving phase at ``PotentialConfig()`` full width: a K=4
   committee behind ``make_engine`` -> ``CommitteeServer`` ->
   ``ServingQueue``, fed by 4 client threads, each shape bucket one
   captured CUDA graph, replayed; then the same microbatches replayed
   through a CPU engine with the same weights; the kernel's launch count
   (added at every replay) must equal the engine's dispatch count, and
   each bucket is captured once; each bucket's dispatch time; then new
   weights through ``refresh_from_device`` on both engines, and the card
   must equal the CPU again;
3b. committee training phase at ``PotentialConfig()`` full width, as
   ``examples/potential_md.py``'s random baseline runs it: 2048 random
   near-equilibrium lattice geometries labelled by the port's
   ``lj_energy_forces``, a ``CommitteeTrainer`` (K=4, batch 64, lr 1e-3,
   the force loss) whose step is one captured CUDA graph: captured ==
   eager bit for bit and == the CPU's losses (rtol 1e-4) over the first 20
   steps, one capture and one replay per step, then 400 captured steps
   after which the held-out force MAE must be lower; the trained weights
   handed device to device (``refresh_from_device(snapshot_cparams())``)
   to the phase's captured engine: 0 host bytes, no new capture, the card
   == a CPU engine with the same weights; a poisoned member rolled back
   and scored with K-1 finite members; ``committee_uq`` launches ==
   dispatches over the phase; the K x policy sweep (K 8/32/64 x fp32/
   bf16/int8 moments: ms per captured step, state bytes ==
   ``stacked_state_nbytes``, peak memory);
3c. the paper's whole loop through ``repro_torch.core.PAL`` at
   ``PotentialConfig()`` full width, as the quickstart twin
   (``repro_torch.examples.quickstart``) configures it: 8 host MD
   generators of 1000 steps, the captured engine scoring every exchange
   round through ``committee_uq``, 4 Lennard-Jones oracle workers on the
   card, the captured trainer (400-step rounds, batch 64, a 2048-row
   ring), weights handed back device to device every round, autosaves;
   the run must end on the generators' stop with no crash, escalation or
   unjoined thread, one capture per bucket and one for the trainer,
   launches == dispatches, 0 refresh host bytes, the engine holding the
   trainer's weights bit for bit and answering as a CPU engine with them;
   then a resume from its checkpoint (iteration, trainer and engine state
   bit for bit, training continuing identically) and a second run under
   ``FaultPlan.acceptance(member=1)`` (0 escalations, 2 restarts, 6
   events, K-1 finite members, one capture per bucket); prints the
   exchange and label rates, the rate with the trainer busy and idle,
   round wall, release-to-yield latency, handoff ms, oracle ms per label
   and the device's busy share over the run (CUDA events around every
   graph replay); the LJ oracle replays one captured graph per worker;
   a third run with the eager oracle (op by op, as before capture) gives the
   oracle's ms per label in the loop before and after, and both are
   timed alone;
3d. the exploration fleet (``repro_torch.exploration.WalkerFleet``, each
   step one replay of ``FusedEngine.score_after``'s captured graph) at
   ``PotentialConfig()`` full width on weights warm-started as
   ``examples/potential_md.py`` does: 16 and 64 walkers stepped alone (one
   capture per fleet bucket, committee_uq launches == steps + 2 warm-up
   launches, 0 bytes uploaded and 4 + the selected rows' bytes downloaded
   per step; host ms per step, device ms per replay, kernels per step,
   proposals/s) beside 64 host ``MDGenerator``s through ``Exchange.step``
   on the same engine; captured == ``capture=False`` bit for bit at noise
   0.01, the card == the CPU over 40 steps at noise 0, a ``nan_walker``
   reset once, a snapshot replaying 10 steps bit for bit; then
   ``PAL(fleet_walkers=16)`` configured as ``potential_md``'s ``run_al``
   until ``fleet_max_steps`` (no crash, escalation or unjoined thread, one
   capture per bucket, fleet and trainer, launches == fleet steps +
   dispatches + warm-ups, the engine holding the trainer's weights bit for
   bit; exchange it/s with the trainer busy and idle, labels/s, retrain
   rounds, handoff ms, oracle ms per label, busy share by CUDA events) and
   again under ``FaultPlan.acceptance(member=1, fleet=True)`` (7 events, 0
   escalations);
4. flash phase: ``flash_attention`` against its plain version on the same
   CUDA tensors over the reference's sweep, decode with ``kv_len`` (0, 1,
   on and either side of a split boundary), the sliding-window decode,
   multi-token decodes on both paths, ragged T and S, head dims 16 and 120
   and the llama3.2-1b and Jamba serving shapes, each call on the path the
   wrapper's rule gives it (by the per-path counts); repeated split-KV
   decode calls must give the same bits, and every bf16 instance of both
   paths must hold HMMA instructions (``cuobjdump -sass``); timed at the four
   serving shapes beside its plain version, its bound and
   ``scaled_dot_product_attention`` (K/V expanded, and with
   ``enable_gqa`` where the installed torch takes it);
5. LM serving phase: ``ServeEngine.generate`` on llama3.2-1b at full
   width (random weights from a seed), 8 prompts of 512 tokens, 64 new
   tokens; the kernel must launch once per layer per prefill (tiled path)
   and decode step (split path), and match the plain attention on every
   attention call of a
   teacher-forced run over the generated tokens, on the model's own
   activations.  The engine replays CUDA graphs (one prefill graph for
   (8, 512), one decode graph for B = 8, captured by a first 2-token
   generate, which is not counted), so every launch of the counted
   generate is counted by replay; the eager loop the engine ran before
   (``model_zoo.make_prefill_fn``/``make_decode_fn`` op by op, the
   position a host int) then runs on the same prompt and weights, and the
   phase prints both decode ms a step, prefill s, memory and the graphs,
   and gates the captured tokens on the eager loop's by the margin rule
   (phases 8, 11 and 13-15 do the same);
6. card against CPU: llama3.2-1b at full width cut to 2 layers, in fp32,
   prefill + 8 decode steps on the card (kernel) and on the CPU (plain
   path) with the same weights;
7. wkv6 phase: ``wkv6`` against its plain version on the same CUDA tensors
   over the reference's sweep, N = 32 and 64, chunks below 64 (and T not
   a multiple of the kernel's 8-row sub-chunks), strong decay, w = 1e-12
   (the log's clip), w = 1, both mixed per key channel, no incoming
   state, |r|, |k|, |v| ~ 100 in bf16 (products that cancel) and the
   rwkv6-7b serving shape; repeated calls must give the same bits, and
   every bf16 instance must hold HMMA instructions (``cuobjdump -sass``);
   timed at the serving shape beside its plain version, its bound and the
   fp32 instance (no single PyTorch call computes WKV6, so there is no
   library yardstick);
8. RWKV6 serving phase: ``ServeEngine.generate`` on rwkv6-7b at full width
   (random weights from a seed), 8 prompts of 512 tokens, 64 new tokens;
   the kernel must launch once per layer in the prefill and never in
   decode, and match the plain version (output and state) on every
   prefill call of a teacher-forced run over the generated tokens, on the
   model's own activations; the end-to-end logit drift from the plain path
   is printed beside a sequential-scan control, not gated;
9. card against CPU: rwkv6-7b at full width cut to 2 layers, in fp32, as
   phase 6;
10. ssd phase: ``ssd`` against its plain version on the same CUDA tensors
   over the reference's sweep, P = 128, chunks below 64, strong decay,
   decay near 1, a = 1, no incoming state, B and C broadcast across the
   heads, |x|, |B|, |C| ~ 100 in bf16 (products that cancel) and the
   jamba-1.5-large serving shape; repeated calls must give the same bits,
   and every bf16 instance must hold HMMA instructions (``cuobjdump
   -sass``); timed at the serving shape beside its plain version, its
   bound and the fp32 instance (no single PyTorch call computes SSD);
11. Jamba serving phase: ``ServeEngine.generate`` on the one-card cut of
   jamba-1.5-large (8 layers, 2 experts, every width published; random
   weights from a seed), 8 prompts of 512 tokens, 64 new tokens; ``ssd``
   must launch once per Mamba layer in the prefill and never in decode,
   ``flash_attention`` once per attention layer per prefill and decode
   step, and both must match their plain versions on every call of a
   teacher-forced run over the generated tokens, on the model's own
   activations;
12. card against CPU: one Jamba group in fp32 at d_model 1024 and d_ff
   3072 with the published head shapes and 4 experts in groups of 256 (so
   that the decode steps drop tokens), as phase 6;
13. MoE serving phase: ``ServeEngine.generate`` on the one-card cut of
   qwen2-moe-a2.7b (16 layers, every width published: 60 routed experts
   top-4 + 4 shared; random weights from a seed), 8 prompts of 512 tokens,
   64 new tokens; ``flash_attention`` must launch exactly 16 tiled + 63 x 16
   split times and match its plain version on every attention call of a
   teacher-forced run; then its fp32 2-layer cut on the card against the
   CPU, held where the routing agrees (the flipped expert choices counted
   and printed);
14. Whisper serving phase: whisper-small uncut, frame embeddings (8, 1500,
   768) from numpy and the seed, 64 prompt tokens, 64 new ones, max_seq 448
   (the published text context): 12 encoder + 24 decoder prefill calls
   tiled and 63 x 24 split, each held against the plain version; the
   encoder's time alone; then 2 fp32 layers (encoder and decoder) against
   the CPU;
15. InternVL serving phase: internvl2-2b uncut, patch embeddings (8, 256,
   2048) + 512 prompt tokens, 64 new ones, max_seq 832: 24 tiled + 63 x 24
   split, each held against the plain version; then 2 fp32 layers against
   the CPU;
15b. the four archs served last, each through the same ``serve_family``
   gates (exact launches by path, every attention call held against the
   plain version on the model's own activations, captured against eager):
   h2o-danube-3-4b uncut (head dim 120, sliding window 4096) on prompts of
   4608 tokens, so the window cuts keys in the prefill and in every decode
   step (24 tiled + 63 x 24 split; the per-call gate's plain version taken
   by query rows of 512, ``attention_ref_rows``); minicpm-2b uncut (36 MHA
   heads, tied embeddings, vocab 122753 padded to 122880; 40 + 63 x 40);
   mistral-nemo-12b uncut (32 heads of 128 over d_model 5120; 40 + 63 x
   40); the one-card cut of qwen3-moe-235b-a22b (4 of 94 layers, qk-norm,
   128 experts top-8, 64 heads over 4 kv heads: G = 16 is past the split
   kernel's 8 rows, so every decode launch is tiled through the
   device-offset entry: 4 + 63 x 4 tiled, 0 split), each on 8 prompts of
   512 tokens; 64 new tokens each; then each arch's fp32 2-layer cut at
   full width on the card against the CPU;
16. PAL at LM scale: the ``repro_torch.examples.lm_active_distill`` twin,
   as the reference configures it, stopped at 120 labelled sequences or
   after 60 s (it prints which): committee_uq launches == student-engine
   dispatches + 2 per in-run capture, flash_attention launches == (teacher
   forwards + 2 warm-up runs per teacher capture) x 4 layers (each
   worker's relabel one captured graph, its forwards counted by replay),
   no crash or unjoined thread, the engine holding the trainer's weights
   bit for bit; exchange it/s, labels/s, retrains, fused steps, weight
   refreshes, selection fraction and the busy share by CUDA events; the
   same loop again with the eager teacher (op by op) gives the
   teacher's ms per label in the loop before and after, and both are
   timed alone;
17. LM training through ``repro_torch.launch.train`` (``phase_lm_train``),
   under each arch's remat policy (``"dots"``, the reference's default):
   every arch at ``--preset smoke`` with its step one captured CUDA graph
   == the eager step bit for bit == the CPU; llama3.2-1b uncut for 30
   captured steps through ``main(argv)`` with checkpoints and a resume
   from step 20 bit for bit (ms a step captured and eager, tokens/s, MFU,
   kernels a step, busy share, peak memory, the top kernels), beside
   eager steps of the same model under ``remat="none"`` in the same
   process (ms and peak; the "dots" peak must be the lower) and through
   the ``torch.func`` gradient path (ms and peak); 2 fp32
   layers at full width against the CPU; every kernel wrapper refuses a
   gradient-tracked input.  Training runs the plain attention and scans
   and launches no kernel;
18. multi-device (``phase_mesh``): (a) NCCL at world size 1, the
   1x1 mesh engine and trainer against the unsharded ones bit for bit and
   ``PAL(uq_mesh='host')`` to its stop; (b) two gloo ranks sharing the
   card (``launch/distributed.launch_local``) on 2x1 and 1x2 meshes: the
   engine, the trainer, the fleet (2x1) and ``attention(kv_seq_shard=
   True)`` (the ``flash_attention`` partials and combine entries) against
   the unsharded paths, launch counts per rank, then ``PAL`` through the
   quickstart loop on each of the two meshes (the leader runs the loop,
   the follower makes its mesh calls in its order: one stop token, per
   rank ``committee_uq`` launches == dispatches + 2 x captures, 0 handoff
   host bytes; labels/s, exchange it/s with the trainer busy and idle,
   retrains, control-send ms a lane call and collective host bytes beside
   (a)'s one-rank run); one more 2x1 loop recapturing every round under
   the capture recorder; the graph churn in a process of its own (one
   thread capturing, one dropping what it captured, one replaying: no
   crash, no failed capture); the CLI's ``DIST_OK 2 2 28.0``; dispatch
   and kernel timings;
19. the planners (``phase_planner``, last): (a) ``python -m
   repro_torch.launch.dryrun`` on llama3.2-1b ``decode_32k`` under the
   16 x 16 production mesh (a trace on fake CUDA tensors) and
   ``roofline_cell``'s rows for llama3.2-1b ``train_4k`` and
   qwen3-moe-235b-a22b ``decode_32k``; (b) the plan of phase 17's llama
   step (under "dots") against that step: resident bytes == the live
   state's, traced FLOPs == the eager step's (rel 1e-9), the roofline
   bound <= the captured step's ms, the planned peak beside the measured
   one; the same beside the "none" eager step (printed, not gated), and
   each policy's peak from the depth-2/3 probe line beside its full-depth
   trace.

The flash phase (4) also sweeps and times the new families' shapes (the
Whisper encoder and cross-attention, InternVL's and qwen2-moe's prefill and
decode; the four archs of 15b: danube's windowed d120 prefill and decode,
minicpm's 36-head MHA, nemo's, and qwen3-moe's G = 16 decode on the tiled
path).  Each phase prints its wall time.

The last lines are one ``{"kernels": [...]}`` object, the card's name and
power limit from ``nvidia-smi``, and ``{"ok": true, "device": {...}}``.
Without CUDA it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import ctypes
import gc
import io
import json
import re
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.jamba1p5_large_398b import ONE_CARD_CUT  # noqa: E402
from repro_torch.configs.pal_potential import PALRunConfig, PotentialConfig  # noqa: E402
from repro_torch.core import acquisition as acq  # noqa: E402
from repro_torch.core import committee as cmte  # noqa: E402
from repro_torch.core.buffers import OracleInputBuffer  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import committee_uq as cuq_kernel  # noqa: E402
from repro_torch.kernels import flash_attention as fa_kernel  # noqa: E402
from repro_torch.kernels import ssd as ssd_kernel  # noqa: E402
from repro_torch.kernels import wkv6 as wkv_kernel  # noqa: E402
from repro_torch.examples import lm_active_distill as distill_ex  # noqa: E402
from repro_torch.examples import quickstart  # noqa: E402
from repro_torch.launch import platform  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train_profile  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import potential as pot  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    CommitteeServer, QueueConfig, ServeEngine, ServingQueue,
)

SEED = 0
# the reference's own committee_uq tolerances (tests/test_committee_uq.py)
MEAN_RTOL, MEAN_ATOL = 1e-5, 1e-6
STD_RTOL, STD_ATOL = 1e-4, 1e-6
# forces and engine results, kernel path (card) vs plain path (CPU)
ENGINE_RTOL, ENGINE_ATOL = 1e-4, 1e-5
SERVE_SHAPE = (4, 64, 24)         # K, rows per microbatch, 3 * n_atoms
# flash_attention: the reference's TOL (tests/test_kernels.py)
FA_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# the LM serving phase: llama3.2-1b, 8 prompts of 512 tokens, 64 new ones
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "llama3.2-1b", 8, 512, 64
CPU_RTOL, CPU_ATOL = 1e-3, 1e-3   # fp32 card (kernel) vs CPU (plain)
# wkv6: the reference's atol (tests/test_kernels.py), with an rtol for
# outputs of magnitude above 1, where one bf16 ulp exceeds the atol
WKV_TOL = {torch.float32: (1e-4, 5e-3), torch.bfloat16: (2e-2, 1e-1)}
# the RWKV6 serving phase: rwkv6-7b, 8 prompts of 512 tokens, 64 new ones
RWKV_ARCH = "rwkv6-7b"
WKV_SERVE = (8, 512, 64, 64)      # (B, T, H, N) of each prefill call
# ssd: the reference's atol (tests/test_kernels.py), rtols as wkv6's
SSD_TOL = WKV_TOL
# the Jamba serving phase: the one-card cut of jamba-1.5-large, same traffic
JAMBA_ARCH = "jamba-1.5-large-398b"
SSD_SERVE = (8, 512, 128, 128, 16)  # (B, T, H, P, N) of each prefill call
# the card-vs-CPU Jamba cut: one group in fp32, narrow, the published head
# shapes (SSD P 128, N 16, d_conv 4; attention hd 128, 8 q heads per kv
# head), 4 experts top-2 in groups of 256
JAMBA_NARROW = dict(num_layers=8, d_model=1024, d_ff=3072, num_heads=8,
                    num_kv_heads=1, moe_num_experts=4, moe_group_size=256,
                    dtype="float32")


def _max_err(got, want, rtol, atol, what):
    """Worst |got - want| over entries finite in ``want``; raises when an
    entry is outside ``atol + rtol * |want|`` or finiteness differs."""
    got, want = got.double(), want.double()
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)):
        raise AssertionError(f"{what}: non-finite entries differ")
    err = (got - want).abs()[fin]
    bound = (atol + rtol * want.abs())[fin]
    bad = err > bound
    if bool(bad.any()):
        raise AssertionError(
            f"{what}: {int(bad.sum())} entries outside rtol={rtol} "
            f"atol={atol}, worst |err| {float(err.max()):.3e}")
    return float(err.max()) if err.numel() else 0.0


def time_ms(fn, iters=200, warmup=20) -> float:
    """Mean milliseconds per call over ``iters`` back-to-back eager calls,
    by CUDA events: what a caller pays, host-side overhead (Python, launch)
    included wherever it exceeds the device work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls=50, replays=20) -> float:
    """Mean device milliseconds per call: ``calls`` calls captured in one
    CUDA graph, replayed ``replays`` times and timed by CUDA events, so no
    host-side overhead enters the figure."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                # warm up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * calls)


# ---------------------------------------------------------------------------
# 1. the card and the build
# ---------------------------------------------------------------------------


def phase_describe():
    info = platform.describe()
    print(f"device: {info['device']} (count {info['count']}); torch "
          f"{info['torch']}, CUDA {info['cuda']}")
    print(f"nvidia-smi name, power.limit: {info['nvidia_smi']}")
    platform.set_reference_precision()
    t0 = time.perf_counter()
    seconds = _build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s wall: "
          + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items()))
    for name, log in _build.ptxas_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    return info


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------


def _uq_inputs(K, n, d, gen, poison):
    preds = torch.randn((K, n, d), generator=gen, device="cuda")
    preds = preds * (0.5 + torch.rand((1, n, 1), generator=gen,
                                      device="cuda"))
    if poison:
        r = torch.arange(n, device="cuda")
        k_of = r % K
        one = (r % 7 == 0)                       # one member NaN, one comp
        preds[k_of[one], r[one], 0] = float("nan")
        two = (r % 11 == 0) & (K > 1)            # another member +inf
        preds[((k_of + 1) % K)[two], r[two], d - 1] = float("inf")
        preds[:, r[r % 13 == 0]] = float("nan")  # no finite member
        if K > 1:                                # exactly one finite member
            preds[1:, r[r % 17 == 0]] = float("-inf")
    return preds


def _check_uq(preds):
    """Kernel vs plain version on one input; returns the worst abs error.
    The threshold is the median finite scalar_std, so masks are mixed;
    the mask must match exactly on rows whose std is further than the std
    tolerance from the threshold."""
    want = ref.committee_uq_ref(preds, 0.0)
    s = want[1][want[4] > 0]
    thr = float(s.median()) if s.numel() else 0.0
    want = ref.committee_uq_ref(preds, thr)
    got = ops.committee_uq(preds, thr)
    torch.cuda.synchronize()
    tag = f"K={preds.shape[0]} n={preds.shape[1]} d={preds.shape[2]}"
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{tag}: output {tuple(g.shape)} {g.dtype} "
                                 f"vs {tuple(w.shape)} {w.dtype}")
    err = max(_max_err(got[0], want[0], MEAN_RTOL, MEAN_ATOL, f"{tag} mean"),
              _max_err(got[1], want[1], STD_RTOL, STD_ATOL, f"{tag} sstd"),
              _max_err(got[2], want[2], STD_RTOL, STD_ATOL, f"{tag} cstd"))
    if not torch.equal(got[4], want[4]):
        raise AssertionError(f"{tag}: finite counts differ")
    away = (want[1] - thr).abs() > STD_ATOL + STD_RTOL * abs(thr)
    if not torch.equal(got[3][away], want[3][away]):
        raise AssertionError(f"{tag}: mask differs away from the threshold")
    return err


def _check_uq_packed(preds, n_valid):
    """The packed entry vs its plain version on one input, rows at or past
    ``n_valid`` masked; returns the worst abs error.  Threshold and mask
    rule as ``_check_uq``; the kernel writes into a given buffer."""
    K, n, d = preds.shape
    want = ref.committee_uq_ref(preds, 0.0)
    s = want[1][want[4] > 0]
    thr = float(s.median()) if s.numel() else 0.0
    nv = torch.tensor(n_valid, dtype=torch.int32, device="cuda")
    out = torch.empty(ref.packed_uq_nbytes(n, d), dtype=torch.uint8,
                      device="cuda")
    if ops.committee_uq_packed(preds, thr, nv, out=out) is not out:
        raise AssertionError("committee_uq_packed did not write its out")
    torch.cuda.synchronize()
    got = ref.packed_uq_views(out, n, d)
    want = ref.packed_uq_views(ref.committee_uq_packed_ref(preds, thr, nv),
                               n, d)
    tag = f"packed K={K} n={n} d={d} n_valid={n_valid}"
    err = max(_max_err(got[0], want[0], MEAN_RTOL, MEAN_ATOL, f"{tag} mean"),
              _max_err(got[1], want[1], STD_RTOL, STD_ATOL, f"{tag} sstd"),
              _max_err(got[2], want[2], STD_RTOL, STD_ATOL, f"{tag} cstd"))
    if not torch.equal(got[3], want[3]):
        raise AssertionError(f"{tag}: finite counts differ")
    away = (want[1] - thr).abs() > STD_ATOL + STD_RTOL * abs(thr)
    if not torch.equal(got[4][away], want[4][away]) \
            or bool(got[4][n_valid:].any()):
        raise AssertionError(f"{tag}: mask differs away from the threshold")
    return err


def uq_bound(K, n, d, packed=False):
    """Least time for the work: each input byte read once (the packed
    entry also reads n_valid), each output written once; ~6 fp32
    operations per element folded plus the finalization, at the published
    peaks."""
    nbytes = K * n * d * 4 + n * d * 4 + 3 * n * 4 + n + (4 if packed else 0)
    flops = 6 * K * n * d + 4 * n * d
    t_bytes = nbytes / roofline.HBM_BW
    t_ops = flops / roofline.PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst, cases = 0.0, 0
    for K in (1, 2, 4, 8, 64):
        for n in (1, 33, 64, 4096, 65536):
            for d in (1, 3, 24, 200):
                poisons = (False, True) if n in (33, 4096) else (False,)
                for poison in poisons:
                    worst = max(worst, _check_uq(
                        _uq_inputs(K, n, d, gen, poison)))
                    cases += 1
        torch.cuda.empty_cache()
    print(f"committee_uq: kernel == plain version on {cases} cases "
          f"(incl. NaN/inf members, 0 and 1 finite members); worst "
          f"|err| {worst:.3e} (mean rtol {MEAN_RTOL} atol {MEAN_ATOL}, "
          f"std rtol {STD_RTOL} atol {STD_ATOL})")
    # bf16 and fp16 members: the kernel converts each element to fp32 as it
    # loads it; the plain version casts the same tensor
    low, low_cases = 0.0, 0
    for dtype in (torch.bfloat16, torch.float16):
        for K, n, d in (SERVE_SHAPE, (1, 33, 3), (8, 4096, 200),
                        (64, 65536, 24)):
            for poison in (False, True):
                low = max(low, _check_uq(
                    _uq_inputs(K, n, d, gen, poison).to(dtype)))
                low_cases += 1
    worst = max(worst, low)
    print(f"committee_uq: kernel == plain version on {low_cases} bf16 and "
          f"fp16 cases (the same tensor, NaN/inf members included); worst "
          f"|err| {low:.3e} (same tolerances)")
    # the engine's packed entry, n_valid below n (0 for n = 1)
    packed, packed_cases = 0.0, 0
    for K in (1, 4, 8, 64):
        for n in (1, 33, 64, 4096, 65536):
            for d in (3, 24, 200):
                poison = n in (33, 4096)
                packed = max(packed, _check_uq_packed(
                    _uq_inputs(K, n, d, gen, poison), (2 * n) // 3))
                packed_cases += 1
    for dtype in (torch.bfloat16, torch.float16):
        for K, n, d in (SERVE_SHAPE, (8, 4096, 200)):
            packed = max(packed, _check_uq_packed(
                _uq_inputs(K, n, d, gen, True).to(dtype), n - 5))
            packed_cases += 1
    worst = max(worst, packed)
    print(f"committee_uq packed entry: kernel == plain version on "
          f"{packed_cases} cases (fp32, bf16, fp16; n_valid < n; NaN/inf "
          f"members); worst |err| {packed:.3e} (same tolerances)")

    timings = {}
    for shape in (SERVE_SHAPE, (4, 65536, 24), (8, 65536, 24),
                  (64, 65536, 24)):
        K, n, d = shape
        preds = _uq_inputs(K, n, d, gen, False)
        nv = torch.tensor(n - 1, dtype=torch.int32, device="cuda")
        out = torch.empty(ref.packed_uq_nbytes(n, d), dtype=torch.uint8,
                          device="cuda")
        fns = {"ms": lambda: ops.committee_uq_packed(preds, 1.0, nv,
                                                     out=out),
               "plain_ms": lambda: ref.committee_uq_packed_ref(
                   preds, 1.0, nv, out=out),
               "five_output_ms": lambda: ops.committee_uq(preds, 1.0),
               "five_output_plain_ms": lambda: ref.committee_uq_ref(
                   preds, 1.0),
               "library_ms": lambda: torch.std_mean(preds, 0, correction=1)}
        t = {k: graph_ms(f) for k, f in fns.items()}
        t.update({k.replace("ms", "eager_ms"): time_ms(f)
                  for k, f in fns.items()})
        t["bound_ms"], t["bound_by"] = uq_bound(K, n, d, packed=True)
        t["five_output_bound_ms"], _ = uq_bound(K, n, d)
        if shape == SERVE_SHAPE:
            half = preds.to(torch.bfloat16)
            t["bf16_ms"] = graph_ms(lambda: ops.committee_uq_packed(
                half, 1.0, nv, out=out))
        timings[shape] = t
        print(f"committee_uq K={K} n={n} d={d}: device time per call "
              f"(CUDA graph) packed entry {t['ms']:.6f} ms (plain "
              f"{t['plain_ms']:.6f}), five-output entry "
              f"{t['five_output_ms']:.6f} ms (plain "
              f"{t['five_output_plain_ms']:.6f}), torch.std_mean "
              f"{t['library_ms']:.6f} ms; eager per call packed "
              f"{t['eager_ms']:.6f} ms, five-output "
              f"{t['five_output_eager_ms']:.6f} ms, torch.std_mean "
              f"{t['library_eager_ms']:.6f} ms; bound packed "
              f"{t['bound_ms']:.6f} ms ({t['bound_by']}; share "
              f"{t['bound_ms'] / t['ms']:.3f}), five-output "
              f"{t['five_output_bound_ms']:.6f} ms (share "
              f"{t['five_output_bound_ms'] / t['five_output_ms']:.3f})"
              + (f"; bf16 members: packed {t['bf16_ms']:.6f} ms"
                 if "bf16_ms" in t else ""))
    # the launch floor: an empty one-thread kernel from the same library,
    # launched without the wrapper (so not counted), under the same graph
    t = timings[SERVE_SHAPE]
    lib = _build.load("committee_uq")
    lib.committee_uq_noop.argtypes = [ctypes.c_void_p]
    lib.committee_uq_noop.restype = ctypes.c_int

    def noop():
        err = lib.committee_uq_noop(torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"committee_uq_noop: CUDA error {err}")

    t["launch_floor_ms"] = graph_ms(noop)
    print(f"launch floor: an empty one-thread kernel (committee_uq_noop) "
          f"{t['launch_floor_ms']:.6f} ms per call (CUDA graph), beside "
          f"committee_uq's packed entry {t['ms']:.6f} ms and five-output "
          f"entry {t['five_output_ms']:.6f} ms at K={SERVE_SHAPE[0]} "
          f"n={SERVE_SHAPE[1]} d={SERVE_SHAPE[2]}")
    big = timings[(4, 65536, 24)]
    t.update({f"large_{k}": big[k] for k in (
        "ms", "five_output_ms", "bound_ms", "five_output_bound_ms")})
    return worst, t


# ---------------------------------------------------------------------------
# 3. the serving path at PotentialConfig() full width
# ---------------------------------------------------------------------------

PCFG = PotentialConfig()
# ONE committee member's force field over flat coords: the CommitteeSpec's
# apply_fn, (n, 3A) -> (n, 3A)
member_forces = train_profile.member_forces


class _Recorder:
    """Front of a CommitteeServer that keeps every microbatch the queue
    dispatched, and its result, in order (the queue's one dispatcher
    thread is the only caller)."""

    def __init__(self, server):
        self.server = server
        self.batches, self.results = [], []
        self.seconds = 0.0              # host time inside predict

    def predict(self, rows):
        t0 = time.perf_counter()
        out = self.server.predict(rows)
        self.seconds += time.perf_counter() - t0
        self.batches.append(np.stack(rows))
        self.results.append(out)
        return out

    def weights_generation(self):
        return self.server.weights_generation()


def _requests(n, seed):
    """Jittered lattice configurations, as the quickstart's MDGenerator
    starts them: a 2x2x2 lattice at 1.3 spacing plus 0.05 Gaussian
    jitter."""
    rng = np.random.RandomState(seed)
    lattice = np.stack(np.meshgrid([0, 1.3], [0, 1.3], [0, 1.3]),
                       -1).reshape(-1, 3)[:PCFG.n_atoms]
    x = lattice[None] + rng.randn(n, PCFG.n_atoms, 3) * 0.05
    return list(x.reshape(n, -1).astype(np.float32))


def phase_serving(smi):
    run_cfg = PALRunConfig(std_threshold=1.0, oracle_budget=0.2,
                           reweight_buckets=64)
    gen = torch.Generator().manual_seed(SEED)
    cparams = pot.init_committee(PCFG, gen, device="cuda")
    engine = acq.make_engine(
        run_cfg, committee=acq.CommitteeSpec(member_forces, cparams),
        device="cuda")
    obuf = OracleInputBuffer()
    server = CommitteeServer(engine, obuf, device="cuda")
    rec = _Recorder(server)
    rows = _requests(1024, SEED)
    buckets = (8, 16, 32, 64)
    for nb in buckets:                           # first use: the capture
        engine.score(rows[:nb], advance=False)
    torch.cuda.synchronize()
    if engine.trace_counts != {nb: 1 for nb in buckets} or any(
            b.graph is None or b.launches != 1
            for b in engine._buckets.values()):
        raise AssertionError(f"expected one captured graph with one "
                             f"committee_uq launch per bucket, got "
                             f"{engine.trace_counts}")

    n_clients, per_client = 4, 256
    t_sub = np.zeros(len(rows))
    t_done = np.zeros(len(rows))
    futs = [None] * len(rows)
    dispatch0 = engine.dispatches
    cuq_kernel.launches = 0                      # main path starts here
    with ServingQueue(rec, QueueConfig(max_batch=64)) as queue:
        def client(c):
            for i in range(c * per_client, (c + 1) * per_client):
                t_sub[i] = time.perf_counter()
                f = queue.submit([rows[i]], client=f"client-{c}")
                f.add_done_callback(
                    lambda _f, i=i: t_done.__setitem__(i, time.perf_counter()))
                futs[i] = f

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        outs = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
    launches = cuq_kernel.launches
    dispatches = engine.dispatches - dispatch0
    if launches != dispatches or launches == 0:
        raise AssertionError(f"committee_uq launches {launches} != engine "
                             f"dispatches {dispatches}")
    for (mean, uq), row in zip(outs, rows):
        if mean.shape != (1, row.size) or not np.isfinite(mean).all() \
                or not np.isfinite(uq.scalar_std).all():
            raise AssertionError("served answer not finite or misshapen")
    if engine.trace_counts != {nb: 1 for nb in buckets}:
        raise AssertionError(f"a bucket was captured again: "
                             f"{engine.trace_counts}")
    lat = (t_done - t_sub) * 1e3
    print(f"serving PotentialConfig() K={PCFG.committee_size} "
          f"in_dim={3 * PCFG.n_atoms}: {len(rows)} requests from "
          f"{n_clients} clients in {wall:.4f} s = {len(rows) / wall:.1f} "
          f"req/s, p50 {np.percentile(lat, 50):.3f} ms, p99 "
          f"{np.percentile(lat, 99):.3f} ms, {queue.dispatches} dispatches, "
          f"{server.routed} rows routed to the oracle buffer; one captured "
          f"graph per bucket {engine.trace_counts} [{smi}]")
    print(f"serving burst wall split: {rec.seconds:.4f} s inside "
          f"CommitteeServer.predict ({len(rec.batches)} dispatches, "
          f"{1e3 * rec.seconds / max(len(rec.batches), 1):.4f} ms each), "
          f"{wall - rec.seconds:.4f} s in the queue, the clients and "
          f"waiting ({100 * rec.seconds / wall:.1f} % in predict) [{smi}]")
    per_bucket = {}
    for nb in buckets:                           # steady-state dispatch
        batch = rows[:nb]
        for _ in range(3):
            engine.score(batch, advance=False)
        t0 = time.perf_counter()
        for _ in range(50):
            engine.score(batch, advance=False)
        per_bucket[nb] = (time.perf_counter() - t0) * 1e3 / 50
    print("captured dispatch, host ms per FusedEngine.score (advance=False, "
          "50 calls): " + ", ".join(f"{nb} rows {ms:.4f}"
                                    for nb, ms in per_bucket.items())
          + f" [{smi}]")

    # the same microbatches, in the same order, through the plain path
    cpu_engine = acq.make_engine(
        run_cfg, committee=acq.CommitteeSpec(
            member_forces, cmte.tree_map(lambda t: t.cpu(), cparams)),
        device="cpu")
    cpu_server = CommitteeServer(cpu_engine, OracleInputBuffer(),
                                 device="cpu")
    worst = 0.0
    for b, (batch, (_, uq_g)) in enumerate(zip(rec.batches, rec.results)):
        _, uq_c = cpu_server.predict(list(batch))
        tag = f"microbatch {b}"
        worst = max(
            worst,
            _max_err(torch.from_numpy(uq_g.mean), torch.from_numpy(uq_c.mean),
                     ENGINE_RTOL, ENGINE_ATOL, f"{tag} mean"),
            _max_err(torch.from_numpy(uq_g.scalar_std),
                     torch.from_numpy(uq_c.scalar_std), ENGINE_RTOL,
                     ENGINE_ATOL, f"{tag} sstd"),
            _max_err(torch.from_numpy(uq_g.component_std),
                     torch.from_numpy(uq_c.component_std), ENGINE_RTOL,
                     ENGINE_ATOL, f"{tag} cstd"))
        if not np.array_equal(uq_g.mask, uq_c.mask):
            raise AssertionError(f"{tag}: selection masks differ")
        if not np.array_equal(uq_g.finite_members, uq_c.finite_members):
            raise AssertionError(f"{tag}: finite counts differ")
    st_g, st_c = engine.state_dict(), cpu_engine.state_dict()
    if int(st_g[1]["rounds"]) != int(st_c[1]["rounds"]):
        raise AssertionError("budget rounds differ")
    for a, b in zip(cmte.tree_leaves(st_g), cmte.tree_leaves(st_c)):
        _max_err(torch.from_numpy(np.asarray(a, np.float64)),
                 torch.from_numpy(np.asarray(b, np.float64)),
                 ENGINE_RTOL, ENGINE_ATOL, "rule state")
    print(f"serving replay: {len(rec.batches)} microbatches, card == CPU "
          f"plain path (masks identical, worst |err| {worst:.3e} at rtol "
          f"{ENGINE_RTOL} atol {ENGINE_ATOL}); committee_uq launches "
          f"{launches} == engine dispatches {dispatches}, counted over "
          f"graph replays")

    # new weights into the buffers the captured graphs read
    gen = torch.Generator().manual_seed(SEED + 1)
    fresh = pot.init_committee(PCFG, gen, device="cpu")
    ptrs = [t.data_ptr() for t in cmte.tree_leaves(engine.cparams)]
    engine.refresh_from_device(cmte.tree_map(lambda t: t.cuda(), fresh))
    cpu_engine.refresh_from_device(fresh)
    if [t.data_ptr() for t in cmte.tree_leaves(engine.cparams)] != ptrs:
        raise AssertionError("refresh_from_device moved a param buffer")
    ref_worst = 0.0
    for nb in (5, 16, 33, 64):
        batch = _requests(nb, SEED + nb)
        uq_g, uq_c = engine.score(batch), cpu_engine.score(batch)
        ref_worst = max(
            ref_worst,
            _max_err(torch.from_numpy(uq_g.mean), torch.from_numpy(uq_c.mean),
                     ENGINE_RTOL, ENGINE_ATOL, f"refreshed {nb} mean"),
            _max_err(torch.from_numpy(uq_g.scalar_std),
                     torch.from_numpy(uq_c.scalar_std), ENGINE_RTOL,
                     ENGINE_ATOL, f"refreshed {nb} sstd"))
        if not np.array_equal(uq_g.mask, uq_c.mask):
            raise AssertionError(f"refreshed {nb}: selection masks differ")
    if engine.trace_counts != {nb: 1 for nb in buckets}:
        raise AssertionError("a refresh caused a capture")
    print(f"refresh check: new weights by refresh_from_device on both "
          f"engines, card == CPU on 4 batches (masks identical, worst "
          f"|err| {ref_worst:.3e}); no buffer moved, no new capture")
    return launches, per_bucket


# ---------------------------------------------------------------------------
# 3b. the training slice at PotentialConfig() full width
# ---------------------------------------------------------------------------

TRAIN_LOSS_RTOL = 1e-4            # card vs CPU per-step losses, fp32
TRAIN_THRESHOLD = 0.3             # examples/potential_md.py's std_threshold


def force_mae(cparams, coords, forces):
    """Committee-mean force MAE on flat held-out geometries."""
    c = torch.from_numpy(coords).cuda().reshape(len(coords), PCFG.n_atoms, 3)
    _, f = pot.batched_committee_energy_forces(cparams, c, PCFG)
    f_mean = f.mean(dim=1).reshape(len(coords), -1)
    return float((f_mean - torch.from_numpy(forces).cuda()).abs().mean())


def _state_leaves(tr):
    return [t.cpu() for t in torch.utils._pytree.tree_leaves(tr.cstate)]


def phase_training(smi):
    """The paper's retrain step and the handoff back to scoring, as
    ``examples/potential_md.py``'s random baseline runs it: random
    near-equilibrium lattice geometries labelled by the port's
    ``lj_energy_forces``, a ``CommitteeTrainer`` at ``PotentialConfig()``
    (K=4, batch 64, lr 1e-3, a 2048-row ring), its step one captured CUDA
    graph; card == eager card (bits) == CPU (losses) over the first 20
    steps, then 400 captured steps; the force MAE on a held-out set must
    fall; the trained weights handed device to device to the phase's
    captured engine, which must then answer as a CPU engine with the same
    weights; a poisoned member rolled back and scored with K-1 finite
    members; the K x policy sweep."""
    cp = train_profile.committee()
    run_cfg = PALRunConfig(std_threshold=TRAIN_THRESHOLD)
    engine = acq.make_engine(run_cfg, committee=acq.CommitteeSpec(
        train_profile.member_forces, cp), device="cuda")
    batches = [train_profile.geometries(n, 30 + n) for n in (8, 13, 40, 64)]
    for b in batches:                            # the engine's captures
        engine.score(b, advance=False)
    counts, dispatch0 = dict(engine.trace_counts), engine.dispatches
    cuq_kernel.launches = 0                      # this path starts here
    t0 = time.perf_counter()
    data = train_profile.dataset()
    held = train_profile.geometries(256, seed=2)
    held_f = train_profile.lj_labels(held)
    card = train_profile.make_trainer(cp)
    eager = train_profile.make_trainer(cp, capture=False)
    cpu = train_profile.make_trainer(cp, device="cpu")
    for tr in (card, eager, cpu):
        tr.add_blocks(data)
    print(f"training data: {len(data)} geometries labelled by "
          f"lj_energy_forces on the card, {time.perf_counter() - t0:.2f} s")
    mae0 = force_mae(card.snapshot_cparams(), held, held_f)
    worst = 0.0
    for t in range(20):
        lg = card.train(steps=1)["loss"]
        if not np.array_equal(lg, eager.train(steps=1)["loss"]):
            raise AssertionError(f"step {t}: captured != eager losses")
        worst = max(worst, _max_err(
            torch.from_numpy(lg), torch.from_numpy(cpu.train(steps=1)["loss"]),
            TRAIN_LOSS_RTOL, 0.0, f"step {t} card vs CPU loss"))
    for a, b in zip(_state_leaves(card), _state_leaves(eager)):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError("captured state != eager state after 20 "
                                 "steps")
    if card.captures != 1 or card.graph_replays != 20:
        raise AssertionError(f"expected one capture and 20 replays, got "
                             f"{card.captures} and {card.graph_replays}")
    print(f"training card vs CPU: 20 steps, captured == eager bit for bit "
          f"(losses and the whole state), losses == CPU within rtol "
          f"{TRAIN_LOSS_RTOL} (worst |err| {worst:.3e}); one capture")
    cap_ms = train_profile.step_ms(card, 50)
    eager_ms = train_profile.step_ms(eager, 50)
    t0 = time.perf_counter()
    out = card.train(steps=400)
    round_s = time.perf_counter() - t0
    if card.captures != 1 or card.graph_replays != card.steps_done:
        raise AssertionError(f"{card.graph_replays} replays for "
                             f"{card.steps_done} steps, {card.captures} "
                             f"captures")
    mae1 = force_mae(card.snapshot_cparams(), held, held_f)
    if not (np.isfinite(out["loss"]).all() and mae1 < mae0):
        raise AssertionError(f"force MAE did not fall: {mae0} -> {mae1}")
    print(f"training step PotentialConfig() K={PCFG.committee_size} batch "
          f"{train_profile.BATCH} fp32: captured {cap_ms:.4f} ms, eager "
          f"{eager_ms:.4f} ms ({eager_ms / cap_ms:.2f}x); 400-step round "
          f"{round_s:.4f} s wall; held-out force MAE {mae0:.4f} -> "
          f"{mae1:.4f} after {card.steps_done} steps [{smi}]")

    # the handoff into the phase's captured engine
    t0 = time.perf_counter()
    engine.refresh_from_device(card.snapshot_cparams())
    first = engine.score(batches[-1])
    handoff_ms = (time.perf_counter() - t0) * 1e3
    if engine.refresh_host_bytes != 0 or engine.device_refreshes != 1:
        raise AssertionError("the handoff moved host bytes")
    cpu_engine = acq.make_engine(run_cfg, committee=acq.CommitteeSpec(
        train_profile.member_forces,
        cmte.tree_map(lambda t: t.cpu(), card.snapshot_cparams())),
        device="cpu")
    ref_worst, picked = 0.0, 0
    for i, b in enumerate(batches):
        uq_g = first if i == len(batches) - 1 else engine.score(b)
        uq_c = cpu_engine.score(b)
        for key in ("mean", "scalar_std", "component_std"):
            ref_worst = max(ref_worst, _max_err(
                torch.from_numpy(getattr(uq_g, key)),
                torch.from_numpy(getattr(uq_c, key)), ENGINE_RTOL,
                ENGINE_ATOL, f"trained {len(b)} {key}"))
        away = np.abs(uq_c.scalar_std - TRAIN_THRESHOLD) > (
            ENGINE_ATOL + ENGINE_RTOL * TRAIN_THRESHOLD)
        if not np.array_equal(uq_g.mask[away], uq_c.mask[away]):
            raise AssertionError(f"trained {len(b)}: masks differ")
        if not np.array_equal(uq_g.finite_members, uq_c.finite_members):
            raise AssertionError(f"trained {len(b)}: finite counts differ")
        picked += int(uq_g.mask.sum())
    warm_ms = train_profile.refresh_then_score_ms(card, engine,
                                                  batches[-1])
    if engine.trace_counts != counts or engine.refresh_host_bytes != 0:
        raise AssertionError(f"a handoff caused a capture or moved host "
                             f"bytes: {engine.trace_counts}")
    print(f"handoff: refresh_from_device(snapshot_cparams()) + the first "
          f"64-row captured score {handoff_ms:.4f} ms the first time, "
          f"{warm_ms:.4f} ms warm (mean of 20); 0 host bytes, no new "
          f"capture {engine.trace_counts}; card == CPU engine on the trained "
          f"weights (worst |err| {ref_worst:.3e}, masks equal off the "
          f"threshold, {picked} rows selected) [{smi}]")

    card.poison_member(1)
    out = card.train(steps=5)
    if out["member_ok"][1] or not out["member_ok"][[0, 2, 3]].all():
        raise AssertionError(f"quarantine verdict {out['member_ok']}")
    engine.refresh_from_device(card.snapshot_cparams())
    uq = engine.score(batches[-1])
    if not (uq.finite_members == PCFG.committee_size - 1).all() or not \
            np.isfinite(uq.scalar_std).all():
        raise AssertionError("the poisoned member was not quarantined in "
                             "scoring")
    launches = cuq_kernel.launches
    dispatches = engine.dispatches - dispatch0
    if launches != dispatches or launches == 0:
        raise AssertionError(f"committee_uq launches {launches} != engine "
                             f"dispatches {dispatches}")
    print(f"poisoned member 1: rolled back on every step (member_ok "
          f"{out['member_ok'].tolist()}), scored with "
          f"{PCFG.committee_size - 1} finite members on every row; "
          f"committee_uq launches {launches} == engine dispatches "
          f"{dispatches}")

    del card, eager, cpu
    gc.collect()
    sweep = train_profile.sweep(data)
    for name, r in sweep.items():
        if r["state_bytes"] != r["stacked_state_nbytes"] or \
                r["captures"] != 1 or not r["finite"]:
            raise AssertionError(f"sweep {name}: {r}")
        print(f"sweep {name}: {r['ms_per_step']:.4f} ms per captured step, "
              f"state {r['state_bytes']} B == stacked_state_nbytes, peak "
              f"{r['peak_bytes'] / 2**20:.1f} MiB [{smi}]")
    return launches, {"step_ms": cap_ms, "eager_step_ms": eager_ms,
                      "round_400_s": round_s, "handoff_ms": handoff_ms,
                      "handoff_warm_ms": warm_ms,
                      "mae": (mae0, mae1)}


# ---------------------------------------------------------------------------
# 3c. the paper's whole loop: PAL on the card
# ---------------------------------------------------------------------------

RUNTIME_STEPS = 1000              # proposals per MD generator, then it stops
RUNTIME_THRESHOLD = 0.25          # the quickstart's std_threshold


def _runtime_cfg(tmp):
    """The quickstart's PAL configuration at ``PotentialConfig()``: 8 MD
    generators, 4 LJ oracle workers, retrain blocks of 16, the fused
    trainer (400 steps a round, batch 64, lr 1e-3, a 2048-row ring), weights
    handed over every round, an autosave every 300 exchange rounds."""
    return PALRunConfig(
        result_dir=tmp, gene_process=8, orcl_process=4, pred_process=4,
        ml_process=4, retrain_size=16, std_threshold=RUNTIME_THRESHOLD,
        patience=5, weight_sync_every=1, train_steps=400, train_batch=64,
        train_lr=1e-3, train_replay_capacity=2048,
        checkpoint_every_iters=300)


def _runtime_pal(tmp, chaos=None, resume=False, steps=RUNTIME_STEPS,
                 oracle=None, **cfg):
    """``_runtime_cfg``'s PAL (``cfg`` overrides its fields) with
    generators that stop after ``steps`` proposals; ``oracle``: the
    oracle class (default the quickstart's captured ``LJOracle``)."""
    import dataclasses

    from repro_torch.core import PAL
    from repro_torch.examples import quickstart

    oracle = oracle or quickstart.LJOracle
    return PAL(
        dataclasses.replace(_runtime_cfg(tmp), **cfg),
        make_generator=lambda r, d: quickstart.MDGenerator(
            r, d, n_atoms=PCFG.n_atoms, max_steps=steps),
        make_oracle=lambda r, d: oracle(r, d, device="cuda"),
        committee=acq.CommitteeSpec(member_forces, train_profile.committee()),
        loss_fn=train_profile.member_force_loss, chaos=chaos,
        resume=resume, device="cuda")


class _LoopClock:
    """Host timestamps of one PAL run, taken by wrapping its objects'
    methods (the runtime itself is not instrumented): each exchange
    round's end, each trainer round's start, end and steps, each block
    release by the Manager and each weight handoff's duration."""

    def __init__(self, pal):
        self.rounds, self.releases, self.exchange, self.handoffs = \
            [], [], [], []
        tr, ex, mgr = pal.committee_trainer, pal.exchange, pal.manager
        train, step, release = tr.train, ex.step, mgr._release_training_data
        publish = pal._publish_committee

        def timed_train(*a, **kw):
            t0, s0 = time.perf_counter(), tr.steps_done
            out = train(*a, **kw)
            self.rounds.append((t0, time.perf_counter(),
                                tr.steps_done - s0))
            return out

        def timed_step():
            out = step()
            self.exchange.append(time.perf_counter())
            return out

        def timed_release():
            n = mgr.releases
            release()
            if mgr.releases > n:
                self.releases.append(time.perf_counter())

        def timed_publish():
            t0 = time.perf_counter()
            publish()
            self.handoffs.append(time.perf_counter() - t0)

        tr.train, ex.step = timed_train, timed_step
        mgr._release_training_data = timed_release
        pal._publish_committee = timed_publish

    def split(self, t0, t1):
        """Exchange rounds a second with the trainer busy and idle, and the
        release-to-yield latencies (a release during a trainer round to
        that round's end)."""
        busy = sum(min(e, t1) - max(s, t0) for s, e, _ in self.rounds
                   if e > t0 and s < t1)
        n_busy = sum(any(s <= t <= e for s, e, _ in self.rounds)
                     for t in self.exchange)
        n_idle = len(self.exchange) - n_busy
        idle = (t1 - t0) - busy
        yields = []
        for s, e, _ in self.rounds:
            inside = [r for r in self.releases if s < r < e]
            if inside:
                yields.append((e - inside[0]) * 1e3)
        return (n_busy / busy if busy > 0 else float("nan"),
                n_idle / idle if idle > 0 else float("nan"), busy, idle,
                yields)


class _ReplaySpans:
    """CUDA events around every CUDA-graph replay while the context is
    open: the engine's bucket graphs on its stream, the trainer's step
    graph on its own.  ``torch.profiler`` is not used here: stopping it
    (a device-wide synchronize) while two other threads replay graphs
    hung the process on the card."""

    def __enter__(self):
        self.spans = []
        self._orig = orig = torch.cuda.CUDAGraph.replay
        spans = self.spans

        def replay(graph):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            orig(graph)
            e.record()
            spans.append((s, e))

        torch.cuda.CUDAGraph.replay = replay
        return self

    def __exit__(self, *exc):
        torch.cuda.CUDAGraph.replay = self._orig

    def busy_share(self):
        """(union of the replays' device intervals over the span from the
        first replay's start to the last one's end, replays, span ms)."""
        if not self.spans:
            return None, 0, 0.0
        torch.cuda.synchronize()
        ref = self.spans[0][0]
        iv = sorted((ref.elapsed_time(s), ref.elapsed_time(e))
                    for s, e in self.spans)
        busy, end = 0.0, -np.inf
        for s0, e0 in iv:
            if e0 > end:
                busy += e0 - max(s0, end)
                end = e0
        window = max(e0 for _, e0 in iv) - iv[0][0]
        return busy / window, len(iv), window


def _run_until_stop(pal, what):
    """Start ``pal`` and wait for its stop token (a generator's step
    limit), then shut it down; returns the report, its counters, the
    counters that must be 0, and the host times of start and stop."""
    t0 = time.perf_counter()
    pal.start()
    if not pal.stop_event.wait(120):
        raise AssertionError(f"{what}: no stop token within 120 s")
    t1 = time.perf_counter()
    pal.shutdown()
    if pal.lane_error is not None:
        raise AssertionError(f"{what}: {pal.lane_error}")
    rep = pal.report()
    c = rep["counters"]
    bad = {k: c.get(k, 0) for k in ("runtime.thread_crashes",
                                    "supervisor.escalations",
                                    "runtime.unjoined_threads")}
    return rep, c, bad, t0, t1


class EagerLJOracle(quickstart.LJOracle):
    """The LJ oracle without capture: ``lj_energy_forces`` op by op on
    the caller's stream (the card's default stream in an oracle worker),
    the labels read back with ``.cpu()``: the "before" of the captured
    oracle."""

    def run_calc(self, input_for_orcl):
        coords = torch.from_numpy(np.asarray(
            input_for_orcl, np.float32).reshape(-1, 3)).to(self.device)
        _, f = pot.lj_energy_forces(coords)
        return input_for_orcl, f.reshape(-1).cpu().numpy()


def _oracle_alone_and_queued(tr, rows, oracle_cls, n=20):
    """Host ms per LJ label of an ``oracle_cls`` worker: alone, and while
    another thread runs a 400-step round on the trainer's own stream (the
    eager oracle reads back on the default stream, the captured one on its
    own, so neither should wait for the round); and that round's wall
    ms."""
    oracle = oracle_cls(0, "", device="cuda")
    oracle.run_calc(rows[0])
    t0 = time.perf_counter()
    for x in rows[:n]:
        oracle.run_calc(x)
    lone = (time.perf_counter() - t0) * 1e3 / n
    done = []
    th = threading.Thread(target=lambda: done.append(
        (time.perf_counter(), tr.train(steps=400), time.perf_counter())))
    th.start()
    time.sleep(0.02)                     # the round's replays are queued
    t0 = time.perf_counter()
    for x in rows[:n]:
        oracle.run_calc(x)
    queued = (time.perf_counter() - t0) * 1e3 / n
    th.join(timeout=60)
    if th.is_alive() or not done:
        raise AssertionError("the 400-step round did not finish")
    return lone, queued, (done[0][2] - done[0][0]) * 1e3


def phase_runtime(smi):
    """The paper's loop on the card through ``repro_torch.core.PAL``:
    host MD generators, the captured ``FusedEngine`` scoring through the
    ``committee_uq`` kernel, LJ oracle workers on the card, the captured
    ``CommitteeTrainer`` retraining all K members, the weights handed back
    device to device; then the same under the acceptance fault plan; then
    a resume from run 1's checkpoint."""
    import tempfile

    from repro_torch.core import FaultPlan

    held = train_profile.geometries(256, seed=2)
    held_f = train_profile.lj_labels(held)
    mae0 = force_mae(cmte.tree_map(lambda t: t.cuda(),
                                   train_profile.committee()), held, held_f)
    with tempfile.TemporaryDirectory() as tmp1, \
            tempfile.TemporaryDirectory() as tmp2:
        # --- run 1: the loop ------------------------------------------------
        pal = _runtime_pal(tmp1)
        clock = _LoopClock(pal)
        cuq_kernel.launches = 0                  # this path starts here
        with _ReplaySpans() as spans:
            rep, c, bad, t0, t1 = _run_until_stop(pal, "run 1")
        launches, dispatches = cuq_kernel.launches, pal.engine.dispatches
        busy = spans.busy_share()
        eng, tr = pal.engine, pal.committee_trainer
        tok = pal.stop_token
        if tok is None or not tok.origin.startswith("generator"):
            raise AssertionError(f"run 1 stopped by {tok}")
        if any(bad.values()):
            raise AssertionError(f"run 1: {bad}")
        if not (rep["labeled_total"] > 0 and c.get("train.retrains", 0) >= 2
                and rep["device_weight_refreshes"] >= 1):
            raise AssertionError(
                f"run 1 did not label, retrain twice and hand weights "
                f"over: {rep['labeled_total']} labels, "
                f"{c.get('train.retrains')} rounds, "
                f"{rep['device_weight_refreshes']} refreshes")
        if eng.refresh_host_bytes != 0:
            raise AssertionError("run 1: a handoff moved host bytes")
        if pal.checkpointer.saves < 1:
            raise AssertionError("run 1: no autosave")
        if not eng.trace_counts or any(v != 1 for v in
                                       eng.trace_counts.values()):
            raise AssertionError(f"run 1: a bucket was captured twice: "
                                 f"{eng.trace_counts}")
        if tr.captures != 1 or tr.graph_replays != tr.steps_done:
            raise AssertionError(f"run 1 trainer: {tr.captures} captures, "
                                 f"{tr.graph_replays} replays for "
                                 f"{tr.steps_done} steps")
        # each bucket is captured inside the run: its two warm-up runs
        # launch the kernel once each, then every dispatch is one replay
        warm = 2 * len(eng.trace_counts)
        if launches != dispatches + warm or dispatches == 0:
            raise AssertionError(f"run 1: committee_uq launches {launches} "
                                 f"!= engine dispatches {dispatches} + "
                                 f"{warm} warm-up launches")
        snap = tr.snapshot_cparams()
        for k, v in snap.items():
            if not torch.equal(eng.cparams[k], v):
                raise AssertionError(f"run 1: engine param {k} != the "
                                     f"trainer's")
        probe = train_profile.geometries(64, seed=91)
        uq_g = eng.score(probe, advance=False)
        cpu_engine = acq.make_engine(
            _runtime_cfg(tmp1), committee=acq.CommitteeSpec(
                member_forces, cmte.tree_map(lambda t: t.cpu(), snap)),
            device="cpu")
        uq_c = cpu_engine.score(probe, advance=False)
        worst = 0.0
        for key in ("mean", "scalar_std", "component_std"):
            worst = max(worst, _max_err(
                torch.from_numpy(getattr(uq_g, key)),
                torch.from_numpy(getattr(uq_c, key)), ENGINE_RTOL,
                ENGINE_ATOL, f"run 1 trained {key}"))
        away = np.abs(uq_c.scalar_std - RUNTIME_THRESHOLD) > (
            ENGINE_ATOL + ENGINE_RTOL * RUNTIME_THRESHOLD)
        if not np.array_equal(uq_g.mask[away], uq_c.mask[away]):
            raise AssertionError("run 1: card and CPU masks differ")
        mae1 = force_mae(snap, held, held_f)
        wall = t1 - t0
        it = c.get("exchange.iterations", 0)
        rate_busy, rate_idle, s_busy, s_idle, yields = clock.split(t0, t1)
        rounds = [e - s for s, e, _ in clock.rounds]
        oracle = pal.monitor.timer("oracle.run_calc")
        warm_ms = train_profile.refresh_then_score_ms(tr, eng, probe)
        saves = pal.checkpointer.saves
        pal.checkpoint()                         # the state to resume from
        print(f"runtime run 1 PotentialConfig() K={PCFG.committee_size}, 8 "
              f"MD generators x {RUNTIME_STEPS} steps, 4 LJ oracles: stopped "
              f"by {tok.origin}; {it} exchange rounds in {wall:.4f} s = "
              f"{it / wall:.2f} it/s, {rep['labeled_total']} labels = "
              f"{rep['labeled_total'] / wall:.2f} labels/s; {saves} "
              f"autosaves [{smi}]")
        print(f"runtime exchange rate: trainer busy {rate_busy:.2f} it/s "
              f"over {s_busy:.3f} s, trainer idle {rate_idle:.2f} it/s over "
              f"{s_idle:.3f} s [{smi}]")
        print(f"runtime retraining: {c['train.retrains']} rounds, "
              f"{tr.steps_done} captured steps, round wall mean "
              f"{1e3 * np.mean(rounds):.4f} ms (max "
              f"{1e3 * np.max(rounds):.4f}); release-to-yield "
              + (f"mean {np.mean(yields):.4f} ms, max {np.max(yields):.4f} "
                 f"ms over {len(yields)} interrupted rounds"
                 if yields else "not measured (no release inside a round)")
              + f" [{smi}]")
        print(f"runtime handoff: refresh_from_device(snapshot_cparams()) in "
              f"the loop mean {1e3 * np.mean(clock.handoffs):.4f} ms over "
              f"{len(clock.handoffs)}; refresh + first 64-row score after "
              f"the run {warm_ms:.4f} ms (mean of 20); oracle "
              f"{1e3 * oracle.mean:.4f} ms per label over {oracle.count} in "
              f"the run [{smi}]")
        share, n_replays, window_ms = busy
        print(f"runtime device busy share (the union of the engine's, the "
              f"trainer's and the oracles' graph replays by CUDA events; "
              f"the copies not counted) over run 1's "
              f"{window_ms:.1f} ms from its first replay to its last: "
              + (f"{100 * share:.2f} % ({n_replays} replays)"
                 if share is not None else "not measured (no replay)")
              + f" [{smi}]")
        print(f"runtime run 1 checks: generator stop, 0 crashes, 0 "
              f"escalations, 0 unjoined threads; one capture per bucket "
              f"{eng.trace_counts} and one for the trainer ({tr.graph_replays}"
              f" replays == steps); committee_uq launches {launches} == "
              f"engine dispatches {dispatches} + {warm} warm-up launches of "
              f"the in-run captures; 0 refresh host bytes; engine "
              f"params == trainer snapshot bit for bit; card == CPU engine on "
              f"64 fresh geometries (worst |err| {worst:.3e}); held-out "
              f"force MAE {mae0:.4f} -> {mae1:.4f}")

        # --- resume from run 1's checkpoint ---------------------------------
        want = pal.committee_trainer.state_dict()
        res = _runtime_pal(tmp1, resume=True)
        if res.exchange.iteration != pal.exchange.iteration:
            raise AssertionError(f"resume: iteration "
                                 f"{res.exchange.iteration} != "
                                 f"{pal.exchange.iteration}")
        got = res.committee_trainer.state_dict()
        for k in ("steps_done", "step_seq", "rounds"):
            if got[k] != want[k]:
                raise AssertionError(f"resume: trainer {k} {got[k]} != "
                                     f"{want[k]}")
        for a, b in zip(_state_leaves(res.committee_trainer),
                        _state_leaves(tr)):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError("resume: trainer state differs")
        for a, b in zip(cmte.tree_leaves(res.engine.state_dict()),
                        cmte.tree_leaves(eng.state_dict())):
            if not np.array_equal(a, b):
                raise AssertionError("resume: engine rule state differs")
        for k, v in snap.items():
            if not torch.equal(res.engine.cparams[k], v):
                raise AssertionError(f"resume: engine param {k} differs")
        uq_r = res.engine.score(probe, advance=False)
        res.engine.score(probe[:8], advance=False)
        res.engine.score(probe[:8], advance=False)
        if res.engine.trace_counts != {8: 1, 64: 1}:
            raise AssertionError(f"resume: {res.engine.trace_counts}")
        for key in ("mean", "scalar_std", "component_std"):
            _max_err(torch.from_numpy(getattr(uq_r, key)),
                     torch.from_numpy(getattr(uq_g, key)), ENGINE_RTOL,
                     ENGINE_ATOL, f"resumed {key}")
        if not np.array_equal(uq_r.mask[away], uq_g.mask[away]):
            raise AssertionError("resume: masks differ from run 1's")
        la = tr.train(steps=3)["loss"]
        lb = res.committee_trainer.train(steps=3)["loss"]
        res.committee_trainer.train(steps=2)
        if not np.array_equal(la, lb) or res.committee_trainer.captures != 1:
            raise AssertionError("resume: training did not continue bit "
                                 "for bit with one capture")
        print(f"runtime resume: iteration {res.exchange.iteration}, trainer "
              f"state ({got['steps_done']} steps) and engine rule state bit "
              f"for bit, the engine's params == run 1's trainer's bit for "
              f"bit and its scores == run 1's, one capture per bucket "
              f"{res.engine.trace_counts}, 3 more steps equal run 1's")
        del res, cpu_engine
        alone = {}
        for name, cls in (("eager", EagerLJOracle),
                          ("captured", quickstart.LJOracle)):
            alone[name] = _oracle_alone_and_queued(tr, probe, cls)
            lone_ms, queued_ms, round_ms = alone[name]
            print(f"runtime LJ oracle {name} "
                  + ("(op by op on the default stream)" if name == "eager"
                     else "(one graph replay on the worker's stream)")
                  + f": {lone_ms:.4f} ms per label alone, {queued_ms:.4f} "
                  f"ms while a 400-step round ({round_ms:.4f} ms wall) runs "
                  f"on the trainer's stream [{smi}]")
        lone_ms, queued_ms, round_ms = alone["captured"]
        caps = [o.captures for o in pal._oracle_instances.values()]
        if not caps or any(c != 1 for c in caps):
            raise AssertionError(f"run 1: LJ oracle captures per worker "
                                 f"{caps}, not one each")

        # --- run 2: the acceptance fault plan --------------------------------
        pal2 = _runtime_pal(tmp2, chaos=FaultPlan.acceptance(member=1))
        t2 = time.perf_counter()
        rep2, c2, bad2, _, _ = _run_until_stop(pal2, "run 2")
        fired = rep2["chaos_fired"]
        if (c2.get("supervisor.escalations", 0) != 0
                or rep2["thread_restarts"] != 2 or len(fired) != 6
                or rep2["uq_finite_members_min"] != PCFG.committee_size - 1
                or any(v != 1 for v in pal2.engine.trace_counts.values())
                or bad2["runtime.unjoined_threads"]):
            raise AssertionError(
                f"run 2: escalations {c2.get('supervisor.escalations', 0)}, "
                f"restarts {rep2['thread_restarts']}, fired {fired}, "
                f"finite min {rep2['uq_finite_members_min']}, captures "
                f"{pal2.engine.trace_counts}, {bad2}")
        print(f"runtime run 2 under FaultPlan.acceptance(member=1): stopped "
              f"by {pal2.stop_token.origin} in "
              f"{time.perf_counter() - t2:.2f} s; 6 events fired {fired}; "
              f"{rep2['thread_restarts']} restarts, 0 escalations; finite "
              f"members min {rep2['uq_finite_members_min']}; one capture per "
              f"bucket {pal2.engine.trace_counts}; {rep2['labeled_total']} "
              f"labels, {c2.get('train.retrains')} rounds [{smi}]")
        del pal2

        # --- run 3: the eager oracle, the "before" in the loop -------------
        with tempfile.TemporaryDirectory() as tmp3:
            pal3 = _runtime_pal(tmp3, oracle=EagerLJOracle)
            rep3, c3, bad3, t30, t31 = _run_until_stop(pal3, "run 3")
            if any(bad3.values()) or rep3["labeled_total"] <= 0:
                raise AssertionError(f"run 3: {bad3}, "
                                     f"{rep3['labeled_total']} labels")
            o3 = pal3.monitor.timer("oracle.run_calc")
            wall3 = t31 - t30
            eager_loop_ms = 1e3 * o3.mean
            print(f"runtime oracle in the loop, before and after: eager "
                  f"(run 3, otherwise as run 1) {eager_loop_ms:.4f} ms per "
                  f"label over {o3.count}, {rep3['labeled_total'] / wall3:.2f}"
                  f" labels/s, {c3.get('exchange.iterations', 0) / wall3:.2f}"
                  f" it/s; captured (run 1) {1e3 * oracle.mean:.4f} ms per "
                  f"label over {oracle.count} (the 4 workers' captures "
                  f"included), {rep['labeled_total'] / wall:.2f} labels/s, "
                  f"{it / wall:.2f} it/s; alone: eager "
                  f"{alone['eager'][0]:.4f} ms, captured "
                  f"{alone['captured'][0]:.4f} ms per label [{smi}]")
            del pal3
    return launches, dispatches, {
        "iterations_per_s": it / wall,
        "labels_per_s": rep["labeled_total"] / wall,
        "retrains": c["train.retrains"], "round_ms": 1e3 * np.mean(rounds),
        "release_to_yield_ms": float(np.mean(yields)) if yields else None,
        "handoff_ms": 1e3 * float(np.mean(clock.handoffs)),
        "refresh_score_ms": warm_ms, "oracle_ms": 1e3 * oracle.mean,
        "oracle_alone_ms": lone_ms, "oracle_queued_ms": queued_ms,
        "oracle_eager_ms": eager_loop_ms,
        "oracle_eager_alone_ms": alone["eager"][0],
        "busy_share": share, "mae": (mae0, mae1)}


# ---------------------------------------------------------------------------
# 3d. the exploration fleet: WalkerFleet through FusedEngine.score_after
# ---------------------------------------------------------------------------

FLEET_THRESHOLD = 0.3             # examples/potential_md.py's std_threshold
FLEET_PATIENCE = 5                # ... and its patience
FLEET_STEPS = 1000                # fleet_max_steps: the PAL runs' stop
FLEET_TIMED = 200                 # fleet steps timed alone, per N
FLEET_POS_ATOL = 5e-5             # card vs CPU walker positions
SEED_N, WARM_STEPS = 48, 600      # potential_md's warm start


def _seed_blocks():
    """potential_md's foundational set at ``PotentialConfig()``: 48
    near-equilibrium geometries labelled by the LJ oracle on the card."""
    xs = train_profile.geometries(SEED_N, seed=7)
    return list(zip(xs, train_profile.lj_labels(xs)))


def _walkers(n):
    """The trusted states of ``n`` walkers: each quickstart MD generator's
    first proposal (a jittered lattice), as ``PAL`` derives them."""
    from repro_torch.examples import quickstart

    return np.stack([quickstart.MDGenerator(r, "", n_atoms=PCFG.n_atoms)
                     .generate_new_data(None)[1] for r in range(n)])


def _fleet(cparams, x0, noise, device="cuda", capture=True, chaos=None):
    from repro_torch.exploration import FleetConfig, WalkerFleet

    eng = acq.FusedEngine(member_forces, cparams, FLEET_THRESHOLD,
                          device=device, capture=capture)
    return WalkerFleet(eng, x0, FleetConfig(noise=noise,
                                            patience=FLEET_PATIENCE),
                       chaos=chaos)


def _device_profile(fn, calls):
    """Device operations of ``calls`` calls of ``fn`` by ``torch.profiler``
    (one thread, nothing else on the card): (kernels, copies and device us
    per call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = copies = busy = 0.0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        busy += us
        if ev.key.startswith(("Memcpy", "Memset")):
            copies += ev.count
        else:
            kernels += ev.count
    return kernels / calls, copies / calls, busy / calls


def _graph_replay_ms(eng, graph, launches, iters=100):
    """Device ms of one replay of an engine ``graph`` by CUDA events on the
    engine's stream; the replays' launches are counted."""
    with eng._enqueue_lock, torch.cuda.stream(eng._stream):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(eng._stream)
        for _ in range(iters):
            graph.replay()
        end.record(eng._stream)
    cuq_kernel.count_replays(iters * launches)
    end.synchronize()
    return start.elapsed_time(end) / iters


def _fleet_alone(cparams, n, smi):
    """N walkers stepped alone (no throttle): the gates on launches, bytes
    and captures, then host ms per step, device ms per replay and the
    device operations per step."""
    fl = _fleet(cparams, _walkers(n), 0.01)
    eng = fl.engine
    key = (fl._cache_key, fl.nb)
    launches0, up0, down0 = cuq_kernel.launches, eng.bytes_to_device, \
        eng.bytes_to_host
    sel_bytes = fl.step().selected.nbytes           # the capture
    selected = 0
    t0 = time.perf_counter()
    for _ in range(FLEET_TIMED):
        out = fl.step()
        sel_bytes += out.selected.nbytes
        selected += out.n_selected
    host_ms = (time.perf_counter() - t0) * 1e3 / FLEET_TIMED
    steps = FLEET_TIMED + 1
    launches = cuq_kernel.launches - launches0
    sb = eng._step_buckets[key]
    if eng.step_trace_counts != {key: 1} or eng.trace_counts:
        raise AssertionError(f"fleet N={n}: captures {eng.step_trace_counts}"
                             f", score's {eng.trace_counts}")
    if launches != steps + 2 or sb.launches != 1:
        raise AssertionError(f"fleet N={n}: committee_uq launches {launches}"
                             f" != {steps} steps + 2 warm-up launches")
    if eng.bytes_to_device != up0:
        raise AssertionError(f"fleet N={n}: {eng.bytes_to_device - up0} "
                             f"bytes uploaded by the steps")
    got = eng.bytes_to_host - down0
    if got != 4 * steps + sel_bytes:
        raise AssertionError(f"fleet N={n}: {got} bytes downloaded, want 4 "
                             f"per step + the selected rows, "
                             f"{4 * steps + sel_bytes}")
    dev_ms = _graph_replay_ms(eng, sb.graph, sb.launches)
    kernels, copies, busy_us = _device_profile(fl.step, 20)
    print(f"fleet N={n} alone (PotentialConfig() K={PCFG.committee_size}, "
          f"d={3 * PCFG.n_atoms}, threshold {FLEET_THRESHOLD}, no throttle):"
          f" host {host_ms:.4f} ms per step = {1e3 / host_ms:.2f} steps/s = "
          f"{n * 1e3 / host_ms:.2f} proposals/s; device {dev_ms:.4f} ms per "
          f"replay (CUDA events); per step {kernels:.1f} kernels + "
          f"{copies:.1f} copies, {busy_us:.2f} us device (torch.profiler); "
          f"{selected} selected over {FLEET_TIMED} steps [{smi}]")
    return fl, {"host_ms": host_ms, "device_ms": dev_ms, "kernels": kernels,
                "copies": copies, "steps_per_s": 1e3 / host_ms,
                "proposals_per_s": n * 1e3 / host_ms, "launches": launches}


def _host_generators(eng, n, smi):
    """The other exploration path on the same engine: ``n`` host
    ``MDGenerator``s through ``Exchange.step`` (numpy MD steps, then one
    ``score`` dispatch a round), timed as the fleet is."""
    from repro_torch.core.controller import (
        Exchange, ExchangeConfig, PredictionPool,
    )
    from repro_torch.examples import quickstart

    gens = [quickstart.MDGenerator(r, "", n_atoms=PCFG.n_atoms)
            for r in range(n)]
    ex = Exchange(gens, PredictionPool([], None, engine=eng),
                  OracleInputBuffer(),
                  ExchangeConfig(std_threshold=FLEET_THRESHOLD,
                                 patience=FLEET_PATIENCE, min_interval=0.0))
    ex.step()                                       # the bucket's capture
    t0 = time.perf_counter()
    for _ in range(FLEET_TIMED):
        ex.step()
    host_ms = (time.perf_counter() - t0) * 1e3 / FLEET_TIMED
    b = eng._buckets[cmte.shape_bucket(n)]
    dev_ms = _graph_replay_ms(eng, b.graph, b.launches)
    kernels, copies, busy_us = _device_profile(ex.step, 20)
    print(f"host generators N={n} on the same engine (Exchange.step: {n} "
          f"numpy MD steps + one score dispatch a round, no throttle): host "
          f"{host_ms:.4f} ms per round = {1e3 / host_ms:.2f} rounds/s = "
          f"{n * 1e3 / host_ms:.2f} proposals/s; device {dev_ms:.4f} ms per "
          f"replay; per round {kernels:.1f} kernels + {copies:.1f} copies, "
          f"{busy_us:.2f} us device [{smi}]")
    return {"host_ms": host_ms, "device_ms": dev_ms, "kernels": kernels,
            "copies": copies, "proposals_per_s": n * 1e3 / host_ms}


def _fleet_parity(cparams, smi):
    """Captured == eager on the card bit for bit at noise 0.01; the card
    == the CPU at noise 0 over 40 steps; a poisoned walker reset once; a
    snapshot replaying 10 steps bit for bit."""
    from repro_torch.core.chaos import ChaosInjector, FaultEvent, FaultPlan

    x0 = _walkers(16)
    n = len(x0)
    graph, eager = _fleet(cparams, x0, 0.01), \
        _fleet(cparams, x0, 0.01, capture=False)
    for i in range(20):
        a, b = graph.step(), eager.step()
        sa, sb = graph.state_dict(), eager.state_dict()
        if a.n_selected != b.n_selected or not np.array_equal(
                a.selected, b.selected) or any(
                not np.array_equal(sa[k], sb[k]) for k in sa) or any(
                not torch.equal(getattr(a, k), getattr(b, k))
                for k in ("mask", "mean", "scalar_std", "component_std")):
            raise AssertionError(f"fleet: captured != eager at step {i}")
    cpu_params = cmte.tree_map(lambda t: t.cpu(), cparams)
    g0, c0 = _fleet(cparams, x0, 0.0), _fleet(cpu_params, x0, 0.0, "cpu")
    worst, flips = 0.0, 0
    for i in range(40):
        a, c = g0.step(), c0.step()
        err = float(np.abs(g0.positions() - c0.positions()).max())
        worst = max(worst, err)
        if err > FLEET_POS_ATOL:
            raise AssertionError(f"fleet card vs CPU: positions differ by "
                                 f"{err:.3e} at step {i}")
        std = c.scalar_std.numpy()[:n]
        away = np.abs(std - np.float32(FLEET_THRESHOLD)) > \
            1e-4 * FLEET_THRESHOLD
        flips += int((~away).sum())
        if not np.array_equal(a.mask.cpu().numpy()[:n][away],
                              c.mask.numpy()[:n][away]):
            raise AssertionError(f"fleet card vs CPU: masks differ at step "
                                 f"{i}")
    chaos = ChaosInjector(FaultPlan(events=(
        FaultEvent("fleet.step", 3, "nan_walker", arg=3.0),)))
    graph.chaos = chaos
    r0 = graph.stats()["nan_resets"]
    for _ in range(6):
        graph.step()
    if len(chaos.fired) != 1 or graph.stats()["nan_resets"] != r0 + 1 or \
            not np.isfinite(graph.positions()).all():
        raise AssertionError(f"fleet: nan_walker fired {chaos.fired}, "
                             f"nan_resets {graph.stats()['nan_resets']}")
    snap = graph.state_dict()
    for _ in range(10):
        graph.step()
    want = graph.state_dict()
    graph.load_state_dict(snap)
    for _ in range(10):
        graph.step()
    got = graph.state_dict()
    if any(not np.array_equal(got[k], want[k]) for k in want):
        raise AssertionError("fleet: a restored snapshot did not replay "
                             "10 steps bit for bit")
    print(f"fleet parity N=16: captured == capture=False bit for bit over 20 "
          f"steps at noise 0.01; card == CPU over 40 steps at noise 0 "
          f"(positions worst |err| {worst:.3e}, masks equal, {flips} "
          f"row-steps within 1e-4 of the threshold); nan_walker reset once; "
          f"state_dict/load_state_dict replayed 10 steps bit for bit; one "
          f"capture {list(graph.engine.step_trace_counts.values())} [{smi}]")
    return worst


def _fleet_pal(tmp, chaos=None):
    """examples/potential_md.py's ``run_al`` at ``PotentialConfig()``: 16
    walkers, 4 LJ oracles on the card, retrain blocks of 16, threshold 0.3,
    patience 5, 400-step rounds of batch 64 at lr 1e-3, weights handed over
    every round, the default 5 ms exchange throttle; stopped by
    ``fleet_max_steps``; warm-started as the example does."""
    from repro_torch.core import PAL
    from repro_torch.examples import quickstart

    cfg = PALRunConfig(
        result_dir=tmp, gene_process=8, orcl_process=4, pred_process=4,
        ml_process=4, retrain_size=16, std_threshold=FLEET_THRESHOLD,
        patience=FLEET_PATIENCE, weight_sync_every=1, train_steps=400,
        train_batch=64, train_lr=1e-3, fleet_walkers=16,
        fleet_max_steps=FLEET_STEPS)
    pal = PAL(cfg,
              make_generator=lambda r, d: quickstart.MDGenerator(
                  r, d, n_atoms=PCFG.n_atoms),
              make_oracle=lambda r, d: quickstart.LJOracle(r, d,
                                                           device="cuda"),
              committee=acq.CommitteeSpec(member_forces,
                                          train_profile.committee()),
              loss_fn=train_profile.member_force_loss, chaos=chaos,
              device="cuda")
    tr = pal.committee_trainer
    tr.add_blocks(_seed_blocks())
    tr.train(steps=WARM_STEPS)
    pal.engine.refresh_from_device(tr.snapshot_cparams())
    return pal


def phase_fleet(smi):
    """The device-resident exploration fleet on the card: fleet steps
    alone at N=16 and N=64 beside the host-generator path at N=64 on the
    same engine, the parity gates, then ``PAL`` with the fleet as
    ``potential_md`` runs it, and again under the acceptance fault plan
    with the fleet's event."""
    import tempfile

    from repro_torch.core import FaultPlan

    warm = train_profile.make_trainer(train_profile.committee())
    warm.add_blocks(_seed_blocks())
    warm.train(steps=WARM_STEPS)               # potential_md's warm start
    cparams = warm.snapshot_cparams()
    del warm
    _, alone16 = _fleet_alone(cparams, 16, smi)
    fl64, alone64 = _fleet_alone(cparams, 64, smi)
    host64 = _host_generators(fl64.engine, 64, smi)
    worst = _fleet_parity(cparams, smi)

    with tempfile.TemporaryDirectory() as tmp1, \
            tempfile.TemporaryDirectory() as tmp2:
        pal = _fleet_pal(tmp1)
        clock = _LoopClock(pal)
        cuq_kernel.launches = 0                  # this path starts here
        with _ReplaySpans() as spans:
            rep, c, bad, t0, t1 = _run_until_stop(pal, "fleet run 1")
        launches = cuq_kernel.launches
        busy = spans.busy_share()
        eng, tr, fl = pal.engine, pal.committee_trainer, pal.fleet
        tok = pal.stop_token
        if tok is None or tok.origin != "fleet":
            raise AssertionError(f"fleet run 1 stopped by {tok}")
        if any(bad.values()):
            raise AssertionError(f"fleet run 1: {bad}")
        if rep["fleet"]["steps"] != FLEET_STEPS or not (
                rep["labeled_total"] > 0 and c.get("train.retrains", 0) >= 1):
            raise AssertionError(f"fleet run 1: {rep['fleet']}, "
                                 f"{rep['labeled_total']} labels, "
                                 f"{c.get('train.retrains')} rounds")
        if any(v != 1 for v in eng.trace_counts.values()) or list(
                eng.step_trace_counts.values()) != [1]:
            raise AssertionError(f"fleet run 1: captures {eng.trace_counts}"
                                 f" {eng.step_trace_counts}")
        if tr.captures != 1 or tr.graph_replays != tr.steps_done:
            raise AssertionError(f"fleet run 1 trainer: {tr.captures} "
                                 f"captures, {tr.graph_replays} replays for "
                                 f"{tr.steps_done} steps")
        warm = 2 * (len(eng.trace_counts) + len(eng.step_trace_counts))
        if launches == 0 or launches != (eng.dispatches + eng.step_dispatches
                                         + warm):
            raise AssertionError(
                f"fleet run 1: committee_uq launches {launches} != "
                f"{eng.step_dispatches} fleet steps + {eng.dispatches} "
                f"dispatches + {warm} warm-up launches")
        for k, v in tr.snapshot_cparams().items():
            if not torch.equal(eng.cparams[k], v):
                raise AssertionError(f"fleet run 1: engine param {k} != the "
                                     f"trainer's")
        if eng.refresh_host_bytes != 0:
            raise AssertionError("fleet run 1: a handoff moved host bytes")
        wall = t1 - t0
        it = c.get("exchange.iterations", 0)
        rate_busy, rate_idle, s_busy, s_idle, _ = clock.split(t0, t1)
        oracle = pal.monitor.timer("oracle.run_calc")
        share, n_replays, window_ms = busy
        handoff_ms = 1e3 * float(np.mean(clock.handoffs)) \
            if clock.handoffs else float("nan")
        print(f"fleet run 1 (potential_md's run_al, PotentialConfig(), 16 "
              f"walkers, fleet_max_steps {FLEET_STEPS}, 5 ms throttle): "
              f"{it} exchange rounds in {wall:.4f} s = {it / wall:.2f} it/s "
              f"(trainer busy {rate_busy:.2f} it/s over {s_busy:.3f} s, idle "
              f"{rate_idle:.2f} it/s over {s_idle:.3f} s); "
              f"{rep['labeled_total']} labels = "
              f"{rep['labeled_total'] / wall:.2f} labels/s; "
              f"{c['train.retrains']} retrain rounds; handoff mean "
              f"{handoff_ms:.4f} ms over {len(clock.handoffs)}; oracle "
              f"{1e3 * oracle.mean:.4f} ms per label over {oracle.count}; "
              f"fleet {rep['fleet']} [{smi}]")
        print(f"fleet run 1 device busy share (union of the fleet's, the "
              f"engine's and the trainer's graph replays by CUDA events) "
              f"over {window_ms:.1f} ms: "
              + (f"{100 * share:.2f} % ({n_replays} replays)"
                 if share is not None else "not measured (no replay)")
              + f"; checks: fleet stop, 0 crashes/escalations/unjoined, one "
              f"capture per bucket {eng.trace_counts} and fleet "
              f"{list(eng.step_trace_counts.values())} and trainer, "
              f"committee_uq launches {launches} == {eng.step_dispatches} "
              f"fleet steps + {eng.dispatches} dispatches + {warm} warm-up, "
              f"engine params == trainer's bit for bit [{smi}]")
        del pal

        pal2 = _fleet_pal(tmp2, chaos=FaultPlan.acceptance(member=1,
                                                           fleet=True))
        t2 = time.perf_counter()
        rep2, c2, bad2, _, _ = _run_until_stop(pal2, "fleet run 2")
        fired = rep2["chaos_fired"]
        if (c2.get("supervisor.escalations", 0) != 0 or len(fired) != 7
                or rep2["fleet"]["nan_resets"] < 1
                or any(v != 1 for v in pal2.engine.trace_counts.values())
                or list(pal2.engine.step_trace_counts.values()) != [1]
                or bad2["runtime.unjoined_threads"]
                or pal2.stop_token.origin != "fleet"):
            raise AssertionError(
                f"fleet run 2: escalations "
                f"{c2.get('supervisor.escalations', 0)}, fired {fired}, "
                f"fleet {rep2['fleet']}, captures {pal2.engine.trace_counts} "
                f"{pal2.engine.step_trace_counts}, {bad2}, stop "
                f"{pal2.stop_token}")
        print(f"fleet run 2 under FaultPlan.acceptance(member=1, fleet=True):"
              f" stopped by {pal2.stop_token.origin} in "
              f"{time.perf_counter() - t2:.2f} s; 7 events fired {fired}; "
              f"{rep2['thread_restarts']} restarts, 0 escalations; fleet "
              f"{rep2['fleet']}; {rep2['labeled_total']} labels [{smi}]")
        del pal2
    return launches, {
        "alone16": alone16, "alone64": alone64, "host64": host64,
        "card_vs_cpu_err": worst, "iterations_per_s": it / wall,
        "iterations_per_s_busy": rate_busy,
        "iterations_per_s_idle": rate_idle,
        "labels_per_s": rep["labeled_total"] / wall,
        "retrains": c["train.retrains"], "handoff_ms": handoff_ms,
        "oracle_ms": 1e3 * oracle.mean, "busy_share": share}


# ---------------------------------------------------------------------------
# 3e. multi-device: meshes over torch.distributed
# ---------------------------------------------------------------------------

MESH_THRESHOLD = 1.0              # phase_serving's budget pipeline
MESH_ROWS = 64                    # rows of one dispatch (bucket 64)
MESH_ROUNDS = 4                   # advancing rounds held against unsharded
MESH_TRAIN_STEPS = 20             # captured steps held against unsharded
MESH_PAL_STEPS = 300              # proposals per MD generator (cut: 1000)
MESH_DISPATCHES = 200             # dispatches timed per engine
MESH_FLEET = (16, 4)              # walkers, steps at noise 0 on 2x1
MESH_ATTN = (8, 1, 576, 32, 8, 64)    # llama3.2-1b decode (B,T,S,H,KV,D)
MESH_KV_LEN = [512, 521, 530, 539, 548, 557, 566, 575]
MESH_MEAN_TOL = (1e-5, 1e-6)      # rtol, atol: committee_uq's mean
MESH_STD_TOL = (1e-4, 1e-6)       # ... and both stds
MESH_TRAIN_TOL = (1e-5, 1e-6)     # the committee axis (test_mesh_parity)


def _mesh_kv_rules():
    """The cache's sequence axis over every mesh axis, the batch whole."""
    from repro_torch.configs import base as ax

    return {ax.BATCH: (), ax.CACHE_SEQ: ("data", "model")}


def _mesh_engine(mesh, cparams, capture=True):
    from repro_torch.core import budget

    rules = budget.rules_from_config(PALRunConfig(
        std_threshold=MESH_THRESHOLD, oracle_budget=0.2,
        reweight_buckets=64))
    return acq.FusedEngine(member_forces, cparams, MESH_THRESHOLD,
                           rules=rules, mesh=mesh, device="cuda",
                           capture=capture)


def _uq_fields(r):
    return [torch.from_numpy(np.asarray(getattr(r, f))) for f in
            ("mean", "scalar_std", "component_std", "mask")]


def _hold_uq(got, want, what, exact):
    """The mesh engine's round against the unsharded one's: bit for bit
    (``exact``), else mean and stds within the kernel's tolerances and the
    masks equal on every row whose statistics are equal (with the
    re-weighting rule a row's threshold is its own, so a mask may differ
    only where the statistics do).  Returns the worst error."""
    g, w = _uq_fields(got), _uq_fields(want)
    if exact:
        for name, a, b in zip(("mean", "sstd", "cstd", "mask"), g, w):
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: {name} differs")
        return 0.0
    worst = max(_max_err(g[0], w[0], *MESH_MEAN_TOL, f"{what} mean"),
                _max_err(g[1], w[1], *MESH_STD_TOL, f"{what} sstd"),
                _max_err(g[2], w[2], *MESH_STD_TOL, f"{what} cstd"))
    same = (g[0] == w[0]).all(dim=1) & (g[1] == w[1]) & (g[2] == w[2])
    if not torch.equal(g[3][same], w[3][same]):
        raise AssertionError(f"{what}: masks differ on rows with equal "
                             f"statistics")
    return worst


def _same_rule_state(a, b, what):
    for x, y in zip(cmte.tree_leaves(a), cmte.tree_leaves(b)):
        if not np.array_equal(np.asarray(x), np.asarray(y)):
            raise AssertionError(f"{what}: rule state differs")


def _dispatch_ms(eng, rows, calls=MESH_DISPATCHES):
    """Host ms per non-advancing dispatch of ``rows`` (warm)."""
    for _ in range(5):
        eng.score(rows, advance=False)
    t0 = time.perf_counter()
    for _ in range(calls):
        eng.score(rows, advance=False)
    return (time.perf_counter() - t0) * 1e3 / calls


def _mesh_engine_check(mesh, exact, what):
    """4 advancing rounds, the mesh engine against the unsharded one on
    this card with the same weights; one capture per bucket, launches ==
    dispatches + 2 warm-up launches; then a 64-row dispatch's host ms on
    both (the mesh's collectives timed apart)."""
    cparams = train_profile.committee()
    em, e0 = _mesh_engine(mesh, cparams), _mesh_engine(None, cparams)
    rounds = [_requests(MESH_ROWS, SEED + 40 + r) for r in range(MESH_ROUNDS)]
    before = cuq_kernel.launches
    got = [em.score(r) for r in rounds]
    launches = cuq_kernel.launches - before
    want = [e0.score(r) for r in rounds]
    worst = max(_hold_uq(g, w, f"{what} round {i}", exact)
                for i, (g, w) in enumerate(zip(got, want)))
    _same_rule_state(em.state_dict(), e0.state_dict(), what)
    dispatches = em.dispatches
    if em.trace_counts != {MESH_ROWS: 1} or launches != dispatches + 2:
        raise AssertionError(f"{what}: captures {em.trace_counts}, "
                             f"{launches} launches for {dispatches} "
                             f"dispatches")
    if (em.bytes_to_device, em.bytes_to_host) != \
            (e0.bytes_to_device, e0.bytes_to_host):
        raise AssertionError(f"{what}: host bytes differ")
    spent = [0.0]
    gather = mesh.all_gather

    def timed_gather(*a, **kw):
        t0 = time.perf_counter()
        try:
            return gather(*a, **kw)
        finally:
            spent[0] += time.perf_counter() - t0

    rows = rounds[0]
    mesh.all_gather = timed_gather
    try:
        mesh_ms = _dispatch_ms(em, rows)
    finally:
        del mesh.all_gather
    return {"worst": worst, "launches": launches,
            "dispatches": dispatches, "mesh_ms": mesh_ms,
            "unsharded_ms": _dispatch_ms(e0, rows),
            "collective_ms": spent[0] * 1e3 / (MESH_DISPATCHES + 5),
            "collective_host_bytes": em.collective_host_bytes,
            "members": int(next(iter(em.cparams.values())).shape[0]),
            "rows": em.rows_of(MESH_ROWS), "engine": em}


def _mesh_trainers(mesh, what, exact):
    """``MESH_TRAIN_STEPS`` captured steps on the mesh trainer and the
    unsharded one from the same committee and ring."""
    from repro_torch.training.committee_trainer import CommitteeTrainer

    blocks = train_profile.dataset(512, seed=1)
    trs = []
    for m in (mesh, None):
        tr = CommitteeTrainer(train_profile.member_force_loss,
                              train_profile.committee(), batch=64, lr=1e-3,
                              replay_capacity=512, mesh=m, seed=0,
                              device="cuda")
        tr.add_blocks(blocks)
        trs.append((tr, tr.train(steps=MESH_TRAIN_STEPS)))
    (tm, mm), (t0, m0) = trs
    whole = tm.snapshot_cparams(whole=True)
    worst = 0.0
    for k, v in t0.cparams.items():
        if exact:
            if not torch.equal(whole[k], v):
                raise AssertionError(f"{what}: trainer param {k} differs")
        else:
            worst = max(worst, _max_err(whole[k], v, *MESH_TRAIN_TOL,
                                        f"{what}: trainer param {k}"))
    if exact and not np.array_equal(mm["loss"], m0["loss"]):
        raise AssertionError(f"{what}: trainer losses differ")
    if not exact:
        worst = max(worst, _max_err(torch.from_numpy(mm["loss"]),
                                    torch.from_numpy(m0["loss"]),
                                    *MESH_TRAIN_TOL, f"{what}: losses"))
    if tm.captures != 1 or tm.graph_replays != MESH_TRAIN_STEPS:
        raise AssertionError(f"{what}: trainer captures {tm.captures}, "
                             f"replays {tm.graph_replays}")
    return tm, worst


def _mesh_attention(mesh):
    """``attention(kv_seq_shard=True)`` at the llama3.2-1b decode shape,
    the cache split over the mesh: held against the one-rank flash kernel
    on the whole cache and the plain version.  Returns the worst errors
    and the partials/combine launches."""
    from repro_torch.sharding.rules import MeshRules

    B, T, S, H, KV, D = MESH_ATTN
    rules = MeshRules(mesh, _mesh_kv_rules())
    s0, s1 = ops.kv_seq_range(rules, B, S)
    worst = {}
    before = (fa_kernel.launches_partials, fa_kernel.launches_combine)
    calls = 0
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        q, k, v, kvl = _fa_inputs(B, T, S, H, KV, D, dtype, gen,
                                  MESH_KV_LEN)
        kw = dict(causal=True, q_offset=max(MESH_KV_LEN) - 1, kv_len=kvl)
        got = ops.attention(q, k[:, s0:s1].contiguous(),
                            v[:, s0:s1].contiguous(), kv_seq_shard=True,
                            rules=rules, **kw)
        calls += 1
        one = ops.attention(q, k, v, **kw)
        plain = ref.attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        tol = FA_TOL[dtype]
        name = str(dtype).split(".")[-1]
        worst[name] = max(
            _max_err(got.float(), plain.float(), tol, tol,
                     f"kv_seq_shard {name} vs plain"),
            _max_err(got.float(), one.float(), tol, tol,
                     f"kv_seq_shard {name} vs the one-rank kernel"))
    launches = (fa_kernel.launches_partials - before[0],
                fa_kernel.launches_combine - before[1])
    if launches != (calls, calls):
        raise AssertionError(f"kv_seq_shard: (partials, combine) launches "
                             f"{launches} for {calls} calls")
    return worst, launches, (s0, s1)


def _mesh_fleet(mesh):
    """The fleet on the mesh against the unsharded fleet, at noise 0."""
    from repro_torch.exploration import FleetConfig, WalkerFleet

    n, steps = MESH_FLEET
    x0 = _walkers(n)
    cparams = train_profile.committee()
    fleets = [WalkerFleet(_mesh_engine(m, cparams), x0,
                          FleetConfig(noise=0.0, patience=FLEET_PATIENCE))
              for m in (mesh, None)]
    worst = 0.0
    for i in range(steps):
        a, b = (fl.step() for fl in fleets)
        if a.n_selected != b.n_selected:
            raise AssertionError(f"fleet step {i}: {a.n_selected} vs "
                                 f"{b.n_selected} selected")
        worst = max(worst,
                    _max_err(torch.from_numpy(a.selected),
                             torch.from_numpy(b.selected), *MESH_MEAN_TOL,
                             f"fleet step {i} selected"),
                    _max_err(a.mean.cpu(), b.mean.cpu(), *MESH_MEAN_TOL,
                             f"fleet step {i} mean"))
    sa, sb = (fl.state_dict() for fl in fleets)
    for k in sb:
        worst = max(worst, _max_err(torch.from_numpy(np.asarray(
            sa[k], np.float64)), torch.from_numpy(np.asarray(
                sb[k], np.float64)), *MESH_MEAN_TOL, f"fleet state {k}"))
    e = fleets[0].engine
    return worst, e.step_dispatches, dict(e.step_trace_counts)


def _mesh_pal(shape, tmp, on_pal=None):
    """``PAL`` through the quickstart loop (cut as in (a):
    ``MESH_PAL_STEPS`` proposals a generator) on the (data, model) mesh
    ``shape``: the leader runs the loop, the follower makes its mesh calls
    in its order (``core/dispatch.py``); ``tmp`` is their shared result
    dir; ``on_pal(pal)``, when given, is called once the PAL is built.
    Gates on every rank: the generators' stop token, one capture per
    bucket, ``committee_uq`` launches == dispatches + 2 x captures, 0
    handoff host bytes, no crash.  Returns the numbers phase_mesh
    prints."""
    from repro_torch.core import dispatch

    rank = int(torch.distributed.get_rank())
    what = f"PAL on {shape} rank {rank}"
    pal = _runtime_pal(tmp, uq_mesh=f"{shape[0]}x{shape[1]}",
                       steps=MESH_PAL_STEPS)
    if on_pal is not None:
        on_pal(pal)
    clock = _LoopClock(pal) if pal.leader else None
    before = cuq_kernel.launches
    rep, c, bad, t0, t1 = _run_until_stop(pal, what)
    launches = cuq_kernel.launches - before
    eng, tok = dispatch.local(pal.engine), pal.stop_token
    if tok is None or not tok.origin.startswith("generator") or \
            any(bad.values()):
        raise AssertionError(f"{what}: stop {tok}, {bad}")
    if any(v != 1 for v in eng.trace_counts.values()) or \
            launches != eng.dispatches + 2 * len(eng.trace_counts) or \
            eng.refresh_host_bytes != 0 or eng.device_refreshes == 0:
        raise AssertionError(
            f"{what}: captures {eng.trace_counts}, {launches} launches for "
            f"{eng.dispatches} dispatches, {eng.device_refreshes} handoffs "
            f"with {eng.refresh_host_bytes} host bytes")
    lanes = rep["lanes"]
    out = {"rank": rank, "leader": pal.leader,
           "token": (tok.origin, tok.reason), "launches": launches,
           "dispatches": eng.dispatches, "captures": len(eng.trace_counts),
           "handoffs": eng.device_refreshes,
           "collective_host_bytes": eng.collective_host_bytes,
           "wall_s": t1 - t0,
           "calls": {k: v["calls"] for k, v in lanes.items()},
           "send_ms": {k: v["send_s"] * 1e3 / max(v["calls"], 1)
                       for k, v in lanes.items()},
           "first_send_ms": {k: v["first_send_s"] * 1e3
                             for k, v in lanes.items()},
           "later_send_ms": {k: (v["send_s"] - v["first_send_s"]) * 1e3
                             / max(v["calls"] - 1, 1)
                             for k, v in lanes.items()},
           "decides": lanes["trainer"]["decides"],
           "decide_ms": lanes["trainer"]["decide_s"] * 1e3
           / max(lanes["trainer"]["decides"], 1),
           "trainer_captures": dispatch.local(pal.committee_trainer).captures,
           "unjoined_threads": bad["runtime.unjoined_threads"]}
    if pal.leader:
        busy, idle, *_ = clock.split(t0, t1)
        out.update(labels=rep["labeled_total"],
                   labels_per_s=rep["labeled_total"] / (t1 - t0),
                   retrains=c.get("train.retrains", 0),
                   it_busy=busy, it_idle=idle)
    del pal
    out["live"] = _live_counts()
    return out


def _live_counts():
    """What this process holds after a loop: its live process groups, its
    Python threads, its OS threads (gloo's included) and the releases of
    graphs and pinned buffers that wait in ``kernels.graphs`` to be
    freed."""
    import os

    from torch.distributed import distributed_c10d as c10d

    from repro_torch.kernels import graphs

    return {"groups": len(c10d._world.pg_map),
            "threads": threading.active_count(),
            "os_threads": len(os.listdir("/proc/self/task")),
            "graphs_pending": graphs.pending()}


def _mesh_rank(shape, tmp, on_pal=None):
    """One gloo rank of phase_mesh (b): every check on the (data, model)
    mesh ``shape``, all ranks sharing this card, then ``PAL`` on it
    (``_mesh_pal``, result dir ``tmp``, ``on_pal``).  Returns numbers
    only."""
    from repro_torch.launch.mesh import make_scaleout_mesh

    platform.set_reference_precision()
    mesh = make_scaleout_mesh(*shape)
    out = {"rank": int(torch.distributed.get_rank()),
           "shape": dict(mesh.shape)}
    eng = _mesh_engine_check(mesh, exact=False, what=f"{shape} engine")
    del eng["engine"]
    out["engine"] = eng
    tm, out["train_worst"] = _mesh_trainers(mesh, f"{shape}",
                                            exact=shape[1] == 1)
    out["train_local"] = int(next(iter(tm.cparams.values())).shape[0])
    if shape == (2, 1):
        out["fleet"] = _mesh_fleet(mesh)
    out["attn_worst"], out["attn_launches"], out["kv_range"] = \
        _mesh_attention(mesh)
    out["pal"] = _mesh_pal(shape, tmp, on_pal)
    return out


# ---------------------------------------------------------------------------
# 3g. the capture soak: fresh 2-rank loops, every capture window recorded
# ---------------------------------------------------------------------------

SOAK_SPAWNS = 30                  # fresh 2x1 spawns: checks, then the loop
SOAK_RECAPTURE_SPAWNS = 6         # 2x1 spawns recapturing every round ...
SOAK_RECAPTURE_LOOPS = 10         # ... over this many loops each
SOAK_ONE_BY_TWO = 4               # 1x2 spawns: checks, then the loop

# capture sites by the file that calls graphs.capture
_CAPTURE_SITES = (("committee_trainer", "trainer"), ("train_step", "lm_step"),
                  ("acquisition", "engine"), ("serving/engine", "serve"),
                  ("quickstart", "oracle"), ("lm_active_distill", "oracle"))


def _outer_frame(depth):
    """The first caller frame, ``depth`` frames up, outside torch, the
    recorder and ``kernels/graphs.py``."""
    f = sys._getframe(depth)
    while f is not None:
        name = f.f_code.co_filename.replace("\\", "/")
        if not ("/torch/" in name or name.endswith("kernels/graphs.py")
                or f.f_code.co_name.startswith("rec_")):
            return f
        f = f.f_back
    return None


class CaptureRecorder:
    """Every CUDA-graph capture window of this process, and in every thread
    the calls that could reach a capture from outside it, each logged with
    the thread's name and a monotonic time: the cyclic collector's runs
    (generation, objects collected, whether a window is open),
    ``torch.cuda.synchronize``, ``empty_cache``, the pinned cache's
    emptying, ``Stream``/``Event`` ``synchronize``/``query``, pinned
    allocations, the mesh's staged gathers, oracle calls, and CUDA graph
    and event destructions.  It wraps those functions from outside (the
    package is not instrumented).  ``captures``/``failed`` count windows by
    site; a failed capture prints (and keeps) the log of its window from
    50 ms before it opened.  Every ``torch.cuda.Stream`` taken from the
    pool is recorded with its handle and maker, and a finalizer wrapped on
    ``Stream`` marks it dead (no weak reference: torch 2.11's CUDA stream
    leaves its weak references pointing at freed memory, and dereferencing
    one increments whatever object reuses it); at each trainer capture the
    live ones are read, and ``shared`` lists the live streams made since
    ``mark_pal`` (a loop's, in a process that ran loops before it) that
    share one CUDA stream handle.
    ``in_window`` counts the logged calls made by another thread while a
    window was open."""

    def __init__(self):
        import collections

        self.log = collections.deque(maxlen=200_000)
        self.captures = collections.Counter()
        self.failed = collections.Counter()
        self.in_window = collections.Counter()
        self.failures = []
        self.shared = {}
        self.live_at_capture = {}
        self._streams = []          # [handle, maker, alive]
        self._alive = {}            # id of a live recorded stream -> entry
        self._pal_from = 0          # the PAL run's first stream
        self._open = {}             # thread ident -> (start, site)
        self._lock = threading.Lock()
        self._undo = []

    def note(self, what, detail=""):
        me = threading.get_ident()
        if any(k != me for k in tuple(self._open)):
            self.in_window[what] += 1
        self.log.append((time.monotonic(), threading.current_thread().name,
                         what, detail))

    # ------------------------------------------------------------ install
    def _patch(self, owner, name, wrapper):
        had = name in vars(owner)
        self._undo.append((owner, name, vars(owner).get(name), had))
        setattr(owner, name, wrapper)

    def _logged(self, owner, name, label, pinned_only=False):
        orig = getattr(owner, name, None)
        if orig is None:                # not in this build of torch
            return
        rec = self

        def rec_call(*a, **kw):
            if not pinned_only or kw.get("pin_memory"):
                rec.note(label)
            return orig(*a, **kw)

        self._patch(owner, name, rec_call)

    def install(self, skip=()):
        """Wrap what the class docstring lists; ``skip`` leaves out
        families of wrappers: ``"calls"`` (the logged calls), ``"del"``
        (graph and event destructors), ``"streams"`` (``Stream.__new__``
        and ``Stream.__del__``: no shared-stream check then), ``"gc"`` (the
        collector's callbacks).  Capture windows are always recorded."""
        from repro_torch.kernels import graphs
        from repro_torch.launch.mesh import Mesh

        rec, G = self, torch.cuda.CUDAGraph
        begin, end = G.capture_begin, G.capture_end

        def rec_begin(graph, *a, **kw):
            f = _outer_frame(1)
            path = f.f_code.co_filename.replace("\\", "/") if f else "?"
            site = next((s for k, s in _CAPTURE_SITES if k in path),
                        Path(path).name)
            t0 = time.monotonic()
            rec._open[threading.get_ident()] = (t0, site)
            rec.note("capture_begin", site)
            if site == "trainer":
                rec._read_streams()
            try:
                return begin(graph, *a, **kw)
            except BaseException as e:
                rec._open.pop(threading.get_ident(), None)
                rec._failed(site, e, t0)
                raise

        def rec_end(graph, *a, **kw):
            t0, site = rec._open.get(threading.get_ident(),
                                     (time.monotonic(), "?"))
            try:
                out = end(graph, *a, **kw)
            except BaseException as e:
                rec.note("capture_failed", f"{site}: {e!r}"[:300])
                rec._failed(site, e, t0)
                raise
            finally:
                rec._open.pop(threading.get_ident(), None)
            rec.note("capture_end", site)
            with rec._lock:
                rec.captures[site] += 1
            return out

        self._patch(G, "capture_begin", rec_begin)
        self._patch(G, "capture_end", rec_end)
        if "calls" not in skip:
            self._log_calls(graphs, Mesh)
        if "del" not in skip:
            for cls in (G, torch.cuda.Event):
                self._patch(cls, "__del__", self._destructor(cls))
        if "streams" not in skip:
            self._record_streams()
        if "gc" not in skip:
            def rec_gc(phase, info):
                rec.note(f"gc {phase}", f"generation {info['generation']} "
                         f"collected {info.get('collected', '-')} window "
                         f"{bool(rec._open)}")

            gc.callbacks.append(rec_gc)
            self._undo.append((gc.callbacks, rec_gc, None, None))
        return self

    def _log_calls(self, graphs, Mesh):
        for owner, name in ((torch.cuda, "synchronize"),
                            (torch.cuda, "empty_cache"),
                            (torch._C, "_host_emptyCache")):
            self._logged(owner, name, name)
        for cls in (torch.cuda.Stream, torch.cuda.Event):
            for name in ("synchronize", "query"):
                self._logged(cls, name, f"{cls.__name__}.{name}")
        for name in ("empty", "zeros"):
            self._logged(torch, name, f"pinned {name}", pinned_only=True)
        self._logged(torch.Tensor, "pin_memory", "pin_memory")
        self._logged(Mesh, "_gather_axis", "staged_gather")
        self._logged(graphs.PerShape, "__call__", "oracle_call")

    def _record_streams(self):
        rec, new = self, torch.cuda.Stream.__new__
        old_del = getattr(torch.cuda.Stream, "__del__", None)

        def rec_new(cls, *a, **kw):
            s = new(cls, *a, **kw)
            if "stream_id" in kw:       # a wrapper of a stream made before
                return s
            f = _outer_frame(1)
            maker = (f"{Path(f.f_code.co_filename).name}:{f.f_lineno} "
                     f"{f.f_code.co_name}" if f else "?")
            entry = [s.cuda_stream, maker, True]
            rec._streams.append(entry)
            rec._alive[id(s)] = entry
            return s

        def rec_stream_del(s):
            entry = rec._alive.pop(id(s), None)
            if entry is not None:
                entry[2] = False
            if old_del is not None:
                old_del(s)

        self._patch(torch.cuda.Stream, "__new__", staticmethod(rec_new))
        self._patch(torch.cuda.Stream, "__del__", rec_stream_del)

    def _destructor(self, cls):
        orig, rec = getattr(cls, "__del__", None), self
        label = f"{cls.__name__}.__del__"

        def rec_del(obj):
            rec.note(label)
            if orig is not None:
                orig(obj)

        return rec_del

    def remove(self):
        for owner, name, prev, had in reversed(self._undo):
            if owner is gc.callbacks:
                gc.callbacks.remove(name)
            elif had:
                setattr(owner, name, prev)
            else:
                delattr(owner, name)
        self._undo.clear()

    # ------------------------------------------------------------ reading
    def mark_pal(self):
        """The streams made from now on are the PAL run's."""
        self._pal_from = len(self._streams)

    def pal_streams(self):
        """The pool streams made since ``mark_pal``: handle -> makers."""
        made = {}
        for handle, maker, _ in self._streams[self._pal_from:]:
            made.setdefault(hex(handle), []).append(maker)
        return made

    def _read_streams(self):
        live, run = {}, {}
        for i, (handle, maker, alive) in enumerate(self._streams):
            if alive:
                live.setdefault(handle, []).append(maker)
                if i >= self._pal_from:
                    run.setdefault(handle, []).append(maker)
        self.live_at_capture = {hex(h): m for h, m in live.items()}
        for h, makers in run.items():
            if len(makers) > 1:
                self.shared[hex(h)] = makers

    def _failed(self, site, err, t0):
        with self._lock:
            self.failed[site] += 1
        lines = [f"{t - t0:+.6f} s {thread}: {what} {detail}"
                 for t, thread, what, detail in list(self.log)
                 if t >= t0 - 0.05]
        text = (f"FAILED CAPTURE ({site}) in thread "
                f"{threading.current_thread().name}: {err!r}\n  "
                + "\n  ".join(lines[-400:]))
        self.failures.append(text)
        print(text, file=sys.stderr, flush=True)

    def summary(self):
        gcs = [d for _, _, w, d in self.log
               if w == "gc start" and d.endswith("True")]
        return {"captures": dict(self.captures),
                "failed": dict(self.failed), "failures": self.failures,
                "in_window": dict(self.in_window), "gc_in_window": len(gcs),
                "streams_at_trainer_capture": self.live_at_capture,
                "shared_streams": self.shared}


def _recapture_every_round(pal, forced):
    """Wrap the leader's trainer's ``train`` (from outside) so that every
    round drops the step graph first and recaptures it; ``forced[0]``
    counts the graphs dropped.  The graph is freed under the capture lock,
    so never while another thread captures."""
    from repro_torch.core import dispatch

    tr = dispatch.local(pal.committee_trainer)
    train = tr.train

    def train_recapturing(*a, **kw):
        with platform.capture_lock:
            if tr._graph is not None:
                tr._graph = None
                forced[0] += 1
        return train(*a, **kw)

    tr.train = train_recapturing


# The native crash trace: a signal handler in C, built with the host C
# compiler into build/ at first use and loaded with ctypes (the harness's
# own; no module of the port loads it).  It writes with write(2) only, then
# puts the previous action back and returns (a fault re-runs its
# instruction, a sent signal is raised again), so faulthandler still
# prints every Python thread and the process still dies by its signal.
_CRASH_TRACE_C = r"""
#define _GNU_SOURCE
#include <dlfcn.h>
#include <errno.h>
#include <execinfo.h>
#include <fcntl.h>
#include <pthread.h>
#include <signal.h>
#include <stdint.h>
#include <string.h>
#include <ucontext.h>
#include <unistd.h>

static const int SIGNALS[] = {SIGSEGV, SIGBUS, SIGILL, SIGFPE, SIGABRT};
static const char *NAMES[] = {"SIGSEGV", "SIGBUS", "SIGILL", "SIGFPE",
                              "SIGABRT"};
#define N_SIGNALS 5
static struct sigaction previous[N_SIGNALS];
static volatile sig_atomic_t out_fd = 2, installed = 0, writing = 0;

static void put(const char *s) {
  ssize_t r = write(out_fd, s, strlen(s));
  (void)r;
}

static void put_hex(uintptr_t v, int width) {
  char digits[2 * sizeof(uintptr_t)], text[2 * sizeof(uintptr_t) + 3];
  int n = 0, i = 2;
  do {
    digits[n++] = "0123456789abcdef"[v & 15];
    v >>= 4;
  } while (v);
  while (n < width) digits[n++] = '0';
  text[0] = '0';
  text[1] = 'x';
  while (n) text[i++] = digits[--n];
  text[i] = 0;
  put(text);
}

static void put_dec(long v) {
  char digits[24], text[26];
  unsigned long u = v < 0 ? -(unsigned long)v : (unsigned long)v;
  int n = 0, i = 0;
  do {
    digits[n++] = '0' + u % 10;
    u /= 10;
  } while (u);
  if (v < 0) text[i++] = '-';
  while (n) text[i++] = digits[--n];
  text[i] = 0;
  put(text);
}

static uintptr_t parse_hex(const char **p) {
  uintptr_t v = 0;
  for (;; (*p)++) {
    char c = **p;
    if (c >= '0' && c <= '9') v = v * 16 + (c - '0');
    else if (c >= 'a' && c <= 'f') v = v * 16 + (c - 'a' + 10);
    else return v;
  }
}

/* the lines of /proc/self/maps whose range holds a or b */
static void put_maps(uintptr_t a, uintptr_t b) {
  char buf[4096], line[1024];
  size_t len = 0;
  ssize_t got;
  int fd = open("/proc/self/maps", O_RDONLY | O_CLOEXEC);
  if (fd < 0) return;
  while ((got = read(fd, buf, sizeof buf)) > 0) {
    for (ssize_t i = 0; i < got; i++) {
      if (buf[i] != '\n') {
        if (len < sizeof line - 1) line[len++] = buf[i];
        continue;
      }
      line[len] = 0;
      len = 0;
      const char *p = line;
      uintptr_t lo = parse_hex(&p), hi;
      if (*p++ != '-') continue;
      hi = parse_hex(&p);
      if ((a >= lo && a < hi) || (b >= lo && b < hi)) {
        put("  maps ");
        put(line);
        put("\n");
      }
    }
  }
  close(fd);
}

static uintptr_t fault_pc(void *context) {
  ucontext_t *uc = context;
#if defined(__x86_64__)
  return (uintptr_t)uc->uc_mcontext.gregs[REG_RIP];
#elif defined(__aarch64__)
  return (uintptr_t)uc->uc_mcontext.pc;
#else
  (void)uc;
  return 0;
#endif
}

/* "  #<i> <pc> <library>+<offset> [<symbol>+<offset>]" */
static void put_frame(const char *tag, long i, uintptr_t pc) {
  Dl_info info;
  put("  #");
  if (tag) put(tag);
  else put_dec(i);
  put(" ");
  put_hex(pc, 0);
  if (dladdr((void *)pc, &info) && info.dli_fname) {
    put(" ");
    put(info.dli_fname[0] ? info.dli_fname : "?");
    put("+");
    put_hex(pc - (uintptr_t)info.dli_fbase, 0);
    if (info.dli_sname) {
      put(" ");
      put(info.dli_sname);
      put("+");
      put_hex(pc - (uintptr_t)info.dli_saddr, 0);
    }
  } else {
    put(" ?+0x0");
  }
  put("\n");
}

/* Memory read through a pipe: a bad address fails with EFAULT there
   instead of faulting in the handler. */
static int probe[2] = {-1, -1};

static ssize_t safe_read(uintptr_t at, void *into, size_t n) {
  char drain[512];
  while (read(probe[0], drain, sizeof drain) > 0) {}
  if (probe[0] < 0 || write(probe[1], (const void *)at, n) != (ssize_t)n)
    return -1;
  return read(probe[0], into, n);
}

/* the type name of a Python object at v, if v looks like one */
static void put_type_name(uintptr_t v) {
  uintptr_t head[2], type, name_at;
  char name[48];
  if (safe_read(v, head, sizeof head) != sizeof head) return;
  type = head[1];
  if (safe_read(type + 24, &name_at, sizeof name_at) != sizeof name_at)
    return;
  if (safe_read(name_at, name, sizeof name) != sizeof name) return;
  for (int i = 0; i < (int)sizeof name; i++) {
    if (name[i] == 0) {
      if (i == 0) return;
      put(" (a Python object? type ");
      put(name);
      put(", refcount ");
      put_dec((long)head[0]);
      put(")");
      return;
    }
    if (name[i] < 32 || name[i] > 126) return;
  }
}

/* the general registers, and 32 words around each that points into
   readable memory */
static void put_registers(void *context) {
#if defined(__x86_64__)
  static const char *names[] = {"r8", "r9", "r10", "r11", "r12", "r13",
                                "r14", "r15", "rdi", "rsi", "rbp", "rbx",
                                "rdx", "rax", "rcx", "rsp", "rip"};
  ucontext_t *uc = context;
  put("  registers:");
  for (int r = 0; r < 17; r++) {
    put(" ");
    put(names[r]);
    put("=");
    put_hex((uintptr_t)uc->uc_mcontext.gregs[r], 0);
  }
  put("\n");
  for (int r = 0; r < 16; r++) {
    uintptr_t v = (uintptr_t)uc->uc_mcontext.gregs[r], words[32];
    uintptr_t at = (v & ~(uintptr_t)7) - 64;
    if (v < 0x10000 || safe_read(at, words, sizeof words) != sizeof words)
      continue;
    put("  memory at ");
    put(names[r]);
    put(" ");
    put_hex(v, 0);
    put_type_name(v);
    for (int i = 0; i < 32; i++) {
      if (i % 4 == 0) {
        put("\n    ");
        put_hex(at + 8 * i, 0);
        put(":");
      }
      put(" ");
      put_hex(words[i], 16);
    }
    put("\n");
  }
#else
  (void)context;
#endif
}

static void on_fatal(int sig, siginfo_t *si, void *context) {
  int saved = errno, k = 0;
  while (k < N_SIGNALS && SIGNALS[k] != sig) k++;
  if (k < N_SIGNALS && !__sync_lock_test_and_set(&writing, 1)) {
    void *frames[64];
    uintptr_t pc = fault_pc(context);
    put("Native crash: ");
    put(NAMES[k]);
    put(" (signal ");
    put_dec(sig);
    put(") si_code ");
    put_dec(si->si_code);
    put(" si_addr ");
    put_hex((uintptr_t)si->si_addr, 0);
    put(" pc ");
    put_hex(pc, 0);
    put("\nThread ");
    put_hex((uintptr_t)pthread_self(), 2 * sizeof(void *));
    put(" (native frames, most recent call first):\n");
    put_frame("pc", 0, pc);
    int n = backtrace(frames, 64);
    for (int i = 0; i < n; i++) put_frame(0, i, (uintptr_t)frames[i]);
    put("  backtrace_symbols_fd:\n");
    backtrace_symbols_fd(frames, n, out_fd);
    put_maps((uintptr_t)si->si_addr, pc);
    put_registers(context);
    put("End of native frames\n");
  }
  if (k < N_SIGNALS) sigaction(sig, &previous[k], 0);
  errno = saved;
  if (si->si_code <= 0) raise(sig);  /* sent (kill, abort): send it on */
}

/* Install over the current actions (faulthandler's): write to fd. */
int crash_trace_install(int fd) {
  struct sigaction sa;
  void *frames[2];
  out_fd = fd;
  if (installed) return 0;
  backtrace(frames, 2);  /* libgcc is loaded now, not in the handler */
  if (pipe2(probe, O_NONBLOCK | O_CLOEXEC) != 0) probe[0] = probe[1] = -1;
  memset(&sa, 0, sizeof sa);
  sa.sa_sigaction = on_fatal;
  sigemptyset(&sa.sa_mask);
  sa.sa_flags = SA_SIGINFO | SA_NODEFER | SA_ONSTACK;
  for (int k = 0; k < N_SIGNALS; k++)
    if (sigaction(SIGNALS[k], &sa, &previous[k]) != 0) return -1;
  installed = 1;
  return 0;
}
"""


def crash_trace_library():
    """The crash trace's shared library, built from ``_CRASH_TRACE_C``
    with the host C compiler into ``build/`` at first use (its name holds
    the source's hash) and loaded with ``ctypes``.  Raises
    ``RuntimeError`` where no C compiler exists."""
    import hashlib
    import os
    import shutil
    import subprocess

    tag = hashlib.sha256(_CRASH_TRACE_C.encode()).hexdigest()[:12]
    out = Path(__file__).resolve().parent / "build"
    so = out / f"crash_trace_{tag}.so"
    if not so.exists():
        cc = shutil.which("cc") or shutil.which("gcc")
        if cc is None:
            raise RuntimeError("crash trace: no C compiler (cc, gcc)")
        out.mkdir(parents=True, exist_ok=True)
        src = out / f"crash_trace_{tag}.{os.getpid()}.c"
        tmp = src.with_suffix(".so")
        src.write_text(_CRASH_TRACE_C)
        got = subprocess.run([cc, "-O1", "-g", "-fPIC", "-shared", "-o",
                              str(tmp), str(src), "-ldl"],
                             capture_output=True, text=True)
        src.unlink()
        if got.returncode:
            raise RuntimeError(f"crash trace: {cc} failed:\n{got.stderr}")
        os.replace(tmp, so)     # ranks that build at once each rename
    return ctypes.CDLL(str(so))


def install_crash_trace(fd):
    """Write a native crash record (signal, ``si_code``, ``si_addr``, the
    faulting thread's id in faulthandler's form, its native frames with
    library and offset, the ``/proc/self/maps`` lines of the address and
    the PC) to file descriptor ``fd`` on SIGSEGV, SIGBUS, SIGILL, SIGFPE
    and SIGABRT.  Install it after ``faulthandler.enable``: the previous
    action runs after the record."""
    if crash_trace_library().crash_trace_install(int(fd)) != 0:
        raise OSError(ctypes.get_errno(), "crash trace: sigaction failed")


_NATIVE_FRAME = re.compile(r"^  #(pc|\d+) (0x[0-9a-f]+) (\S+)\+(0x[0-9a-f]+)"
                           r"(?: (\S+)\+0x[0-9a-f]+)?$")


def native_frames(text, top=8):
    """The last native crash record in ``text`` (a faults file): its
    first line and its ``top`` frames from the faulting PC outward, each
    ``library+offset function file:line`` (``addr2line -f -C``; where the
    library carries no line table, the exported symbol ``dladdr`` named,
    else ``addr2line``'s nearest symbol)."""
    import shutil
    import subprocess

    start = text.rfind("Native crash: ")
    if start < 0:
        return None
    lines = text[start:].splitlines()
    frames = [m.groups() for m in map(_NATIVE_FRAME.match, lines) if m]
    pc = frames[0][1] if frames and frames[0][0] == "pc" else None
    rest = frames[1:]
    hit = next((i for i, f in enumerate(rest) if f[1] == pc), None)
    # from the faulting PC on; each later one a return address (less 1)
    chain = [(frames[0], 0)] if pc else []
    chain += [(f, 1) for f in rest[hit + 1 if hit is not None else 0:]]
    out, tool = [], shutil.which("addr2line")
    demangle = shutil.which("c++filt")
    for (_, _, lib, off, sym), back in chain[:top]:
        if sym and sym.startswith("_Z") and demangle:
            sym = subprocess.run([demangle, sym], capture_output=True,
                                 text=True).stdout.strip() or sym
        where = sym or "?"
        if tool and lib != "?":
            got = subprocess.run(
                [tool, "-f", "-C", "-e", lib, hex(int(off, 16) - back)],
                capture_output=True, text=True)
            fn, line = (got.stdout.splitlines() + ["", ""])[:2]
            if got.returncode == 0 and line and not line.startswith("??"):
                where = f"{fn} {line}"
            elif not sym and fn and fn != "??":
                where = f"{fn} (nearest symbol)"
        out.append(f"{Path(lib).name}+{off} {where}")
    return {"crash": lines[0], "frames": out}


class _SoakLog:
    """A soak rank's files under ``log_dir``: ``rank{r}.faults`` holds
    faulthandler's stacks of every thread, written when this rank crashes
    and, by a watchdog thread, when the other rank's process has ended
    without writing its ``rank{r}.done`` (a crash there), after the native
    crash trace's record of the crash (``install_crash_trace``); a line of
    ``rank{r}.loops.jsonl`` follows every finished loop (its ``live`` and
    the pool streams made in it, by handle)."""

    def __init__(self, log_dir, rank):
        import faulthandler
        import os

        self.dir, self.rank = Path(log_dir), rank
        self.dir.mkdir(parents=True, exist_ok=True)
        self.faults = open(self.dir / f"rank{rank}.faults", "w")
        faulthandler.enable(file=self.faults)
        install_crash_trace(self.faults.fileno())
        (self.dir / f"rank{rank}.pid").write_text(str(os.getpid()))
        threading.Thread(target=self._watch, name="soak-watchdog",
                         daemon=True).start()

    def _peer_ended(self, peer):
        pid = self.dir / f"rank{peer}.pid"
        if not pid.exists() or (self.dir / f"rank{peer}.done").exists():
            return False
        try:
            stat = Path(f"/proc/{int(pid.read_text())}/stat").read_text()
        except (OSError, ValueError):
            return True
        return stat.rsplit(")", 1)[1].split()[0] in ("Z", "X")

    def _watch(self):
        import faulthandler

        while not self._peer_ended(1 - self.rank):
            time.sleep(0.2)
        self.faults.write(f"rank {1 - self.rank} ended without a result; "
                          f"rank {self.rank}'s threads:\n")
        self.faults.flush()
        faulthandler.dump_traceback(file=self.faults, all_threads=True)
        self.faults.flush()

    def loop(self, i, pal_out, freed=None, streams=None):
        with open(self.dir / f"rank{self.rank}.loops.jsonl", "a") as f:
            f.write(json.dumps({"loop": i, "live": pal_out.get("live"),
                                "freed": freed, "streams": streams,
                                "t": time.time()}) + "\n")

    def done(self, error=None):
        """The rank's end: its error (if any) in ``rank{r}.done``, which
        a crashed rank's result never carries."""
        (self.dir / f"rank{self.rank}.done").write_text(error or "")


def _collect_between(collector):
    """With ``collector="between"``: collect now, and return the 25 most
    common types of what the collection freed (None otherwise)."""
    if collector != "between":
        return None
    import collections

    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        gc.collect()
        freed = collections.Counter(type(o).__qualname__ for o in gc.garbage)
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
    gc.collect()
    return freed.most_common(25)


def _soak_progress(log_dir):
    """What a spawn's ``_SoakLog`` files hold: per rank the loops it
    finished (each one's ``live`` and pool streams), its native crash
    frames (``native_frames``) and its stacks, if any."""
    d, got = Path(log_dir), {}
    for r in range(2):
        lines = []
        f = d / f"rank{r}.loops.jsonl"
        if f.exists():
            lines = [json.loads(x) for x in f.read_text().splitlines() if x]
        faults, done = d / f"rank{r}.faults", d / f"rank{r}.done"
        text = faults.read_text() if faults.exists() else ""
        got[f"rank{r}"] = {
            "loops_done": len(lines),
            "live": [x["live"] for x in lines],
            "streams": [x.get("streams") for x in lines],
            "native": native_frames(text),
            "faults": text[-30000:],
            "error": done.read_text()[-4000:] if done.exists() else None}
    return got


def _soak_rank(shape, tmp, recapture, checks, loops=1, recorder=True,
               log_dir=None, collector="auto"):
    """One gloo rank of a soak spawn: the checks of phase_mesh (b) then
    ``PAL`` (``_mesh_rank``), or the loop alone (``checks`` False), then
    ``loops - 1`` more loops in the same process; with ``recapture`` the
    leader's trainer recaptures every round; with ``recorder`` under a
    ``CaptureRecorder`` (without it, captures are counted by their owners
    and a failed one is known by its error); with ``log_dir`` it keeps a
    ``_SoakLog`` there.  ``collector="between"`` keeps the cyclic
    collector off inside each loop and collects after it, in this thread
    with the loop's lanes closed (each loop's line then holds the types
    that collection freed).  A failure is returned, not raised, so both
    ranks report their windows."""
    import faulthandler
    import os

    rank = int(torch.distributed.get_rank())
    log = _SoakLog(log_dir, rank) if log_dir else None
    if log is None:
        faulthandler.enable()       # a crash prints every thread's stack
        install_crash_trace(2)      # ... after its native frames
    rec = CaptureRecorder().install(
        recorder if isinstance(recorder, (tuple, list)) else ()) \
        if recorder else None
    forced, before = [0], []

    def on_pal(pal):
        if not before:
            before.append(dict(rec.captures) if rec else {})
        if recapture and pal.leader:
            _recapture_every_round(pal, forced)

    out = {"rank": int(torch.distributed.get_rank()), "shape": shape,
           "recapture": recapture, "checks": checks, "loops": loops,
           "recorder": recorder}
    dirs = [os.path.join(tmp, f"loop{i}") for i in range(loops)]
    try:
        for d in dirs:
            os.makedirs(d, exist_ok=True)
        if collector == "between":
            gc.disable()
        if checks:
            out["pal"] = _mesh_rank(shape, dirs[0], on_pal)["pal"]
        else:
            platform.set_reference_precision()
            out["pal"] = _mesh_pal(shape, dirs[0], on_pal)
        if log:
            log.loop(0, out["pal"], _collect_between(collector),
                     rec and rec.pal_streams())
        out["more"] = []
        for i, d in enumerate(dirs[1:], 1):
            if rec:
                rec.mark_pal()
            out["more"].append(_mesh_pal(shape, d, on_pal))
            if log:
                log.loop(i, out["more"][-1], _collect_between(collector),
                         rec and rec.pal_streams())
    except Exception as e:      # noqa: BLE001 — returned with the windows
        out["error"] = f"{e!r}"[:4000]
    if log:
        log.done(out.get("error"))
    if rec:
        out.update(rec.summary())
        base = before[0] if before else {}
        out["pal_captures"] = {k: v - base.get(k, 0)
                               for k, v in rec.captures.items()}
    else:
        done = ([out["pal"]] if "pal" in out else []) + out.get("more", [])
        bad = "StreamCapture" in out.get("error", "")
        out.update(_NO_RECORDER, failed={"site unknown": 1} if bad else {},
                   pal_captures={"trainer": sum(p["trainer_captures"]
                                                for p in done),
                                 "engine": sum(p["captures"] for p in done)})
    out["forced"] = forced[0]
    return out


_NO_RECORDER = {"captures": {}, "failed": {}, "failures": [],
                "in_window": {}, "gc_in_window": 0,
                "streams_at_trainer_capture": {}, "shared_streams": {}}


def _soak_spawn(shape, recapture, checks, loops=1, recorder=True,
                log_dir=None, collector="auto"):
    """One fresh 2-rank spawn of ``_soak_rank``; returns both ranks'
    results (the leader's first) and the spawn's wall seconds."""
    import tempfile

    from repro_torch.launch import distributed

    crash_trace_library()           # built once, before the ranks load it
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        try:
            outs = distributed.launch_local(2, _soak_rank, shape, tmp,
                                            recapture, checks, loops,
                                            recorder, log_dir, collector,
                                            device="cuda:0", timeout=900)
        except RuntimeError as e:
            outs = [dict(_NO_RECORDER, rank=r, shape=shape,
                         recapture=recapture, checks=checks, loops=loops,
                         recorder=recorder, error=f"spawn: {e!r}"[:4000],
                         forced=0, pal_captures={})
                    for r in range(2)]
    return sorted(outs, key=lambda o: o["rank"]), time.perf_counter() - t0


def _soak_line(i, outs, wall, smi):
    lead = outs[0]
    shape, p = lead["shape"], lead.get("pal") or {}
    errors = " | ".join(o["error"][:300] for o in outs if "error" in o)
    failed = sum(sum(o["failed"].values()) for o in outs)
    pc = lead.get("pal_captures", {})
    tc = pc.get("trainer", 0)
    send = p.get("send_ms", {})
    loops = lead.get("loops", 1)
    live = (lead.get("more") or [p])[-1].get("live")
    return (f"soak {i} {shape[0]}x{shape[1]} "
            f"{'recapture' if lead['recapture'] else 'natural'}"
            f"{'' if lead['checks'] else ' (loop only)'}"
            f"{f' x{loops} loops' if loops > 1 else ''}, recorder "
            f"{_recorder_text(lead['recorder'])}: leader trainer "
            f"captures {tc} ({tc - lead['forced']} natural, "
            f"{lead['forced']} forced) in the loop, engine graphs "
            f"{pc.get('engine', 0)}, oracle graphs {pc.get('oracle', 0)} "
            f"(the process: {lead['captures']}); failed captures {failed}; "
            f"labels/s {p.get('labels_per_s', float('nan')):.4f}, send ms "
            f"engine {send.get('engine', float('nan')):.4f} trainer "
            f"{send.get('trainer', float('nan')):.4f}; collector runs in a "
            f"window {sum(o['gc_in_window'] for o in outs)}; calls in "
            f"another thread's window {lead['in_window']}; shared streams "
            f"{sum(len(o['shared_streams']) for o in outs)}; after the "
            f"last loop {live}; "
            f"{'ERROR ' + errors if errors else 'ok'}; {wall:.2f} s [{smi}]")


SOAK_SHORT_LOOPS = 3              # loops in phase_mesh (b)'s soak spawn
LIVE_THREAD_MARGIN = 2            # OS threads a later loop may add (as the
                                  # CPU test's THREAD_MARGIN)


def _recorder_text(recorder):
    """``_soak_rank``'s ``recorder``: False, True, or the families it
    leaves out."""
    if isinstance(recorder, (tuple, list)):
        return "on without " + "+".join(recorder)
    return "on" if recorder else "off"


def _soak_short(smi):
    """The soak's short form in phase_mesh (b): a 2x1 spawn of
    ``SOAK_SHORT_LOOPS`` loops (no checks) in which the leader's trainer
    recaptures every round, under a ``CaptureRecorder``.  Fails on any
    failed capture, a failed rank, two live streams on one CUDA stream, no
    recapture at all, or a rank whose process groups after a later loop
    differ from those after the first, or whose OS threads exceed them by
    more than ``LIVE_THREAD_MARGIN`` (a finished loop leaves nothing
    behind)."""
    outs, wall = _soak_spawn((2, 1), True, False, SOAK_SHORT_LOOPS)
    print(_soak_line("short", outs, wall, smi))
    lives = [[p.get("live") for p in [o.get("pal", {})] + o.get("more", [])]
             for o in outs]
    print(f"soak short: live after each loop, by rank {lives}")
    def flat(live):
        return len(live) == SOAK_SHORT_LOOPS and None not in live and all(
            x["groups"] == live[0]["groups"] and 0 <= x["os_threads"]
            - live[0]["os_threads"] <= LIVE_THREAD_MARGIN for x in live)

    grown = [r for r, live in enumerate(lives) if not flat(live)]
    if any("error" in o or o["failed"] or o["shared_streams"]
           for o in outs) or outs[0]["forced"] == 0 or grown:
        raise AssertionError(
            "mesh (b) recapture loop: "
            + " | ".join(o.get("error", "")[:2000] + "".join(o["failures"])
                         for o in outs)
            + f" forced {outs[0]['forced']}, shared "
            f"{[o['shared_streams'] for o in outs]}, live {lives}")
    lead = outs[0]
    return {"trainer_captures": lead["pal_captures"].get("trainer", 0),
            "forced": lead["forced"], "failed": 0, "wall_s": wall,
            "labels_per_s": lead["pal"]["labels_per_s"]}


CHURN_S = 25.0          # seconds of the graph churn (phase_mesh (b))


def graph_churn(seconds=CHURN_S):
    """Four threads on the port's capture path for ``seconds``, as a
    process that runs loop after loop has them: one captures a small
    program through ``graphs.capture`` again and again on stream S (a live
    loop's trainer recapturing); one drops the last reference to what the
    first captured; one builds a committee engine on S between those
    captures, scores one batch through it (its bucket graph captured, its
    pinned twins copied through on S), then drops it and collects (a
    finished loop's engine, freed by the collector while a live owner
    captures on its stream: torch's pool hands out 32 streams per device
    in turn); one replays four graphs captured before on another stream.
    torch 2.11 keeps every CUDA graph in one set with no lock
    (``CUDAGeneratorState::registered_graphs_``), which ``capture_begin``
    fills without the GIL and a graph's destructor empties, and its pinned
    host allocator records an event on S for each freed block that was
    copied on S; a port that frees either in the dropping thread beside
    the capture dies within seconds (a failed torch check in
    ``unregister_graph``, a CUDA error or a segfault).  Returns the
    counts; the replays' sums are checked, and an error in a thread is
    returned in ``errors``.  Run it in a process of its own
    (``_graph_churn_step``)."""
    from repro_torch.kernels import graphs

    _build.build_all()
    dev = torch.device("cuda")
    x, y = (torch.zeros(1024, device=dev) for _ in range(2))
    cap_s, rep_s = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    for s in (cap_s, rep_s):
        s.wait_stream(torch.cuda.current_stream(dev))
    kept = graphs.capture([lambda: y.add_(1.0)] * 4, rep_s,
                          warmup=lambda: None).graphs
    cparams, rows = train_profile.committee(), train_profile.geometries(64, 3)
    made, errors = [], []
    n = {"captures": 0, "drops": 0, "engines": 0, "replays": 0}
    stop, gate = threading.Event(), threading.Lock()

    def guarded(fn):
        def run():
            try:
                fn()
            except BaseException as e:      # noqa: BLE001 — returned
                errors.append(f"{threading.current_thread().name}: {e!r}")
                stop.set()
        return run

    def capturer():
        while not stop.is_set():
            with gate:
                made.append(graphs.capture([lambda: x.add_(1.0)], cap_s,
                                           warmup=lambda: None))
            n["captures"] += 1

    def dropper():
        while not stop.is_set():
            try:
                got = made.pop(0)
            except IndexError:
                time.sleep(0)
                continue
            del got
            n["drops"] += 1

    def owner():
        while not stop.is_set():
            with gate:      # its work on S never falls in a capture on S
                eng = acq.FusedEngine(train_profile.member_forces, cparams,
                                      0.5, device=dev)
                eng._stream = cap_s         # the pool's stream, handed on
                cap_s.wait_stream(torch.cuda.current_stream(dev))
                eng.score(rows)
            del eng
            gc.collect()
            n["engines"] += 1

    def replayer():
        with torch.cuda.stream(rep_s):
            while not stop.is_set():
                for g in kept:
                    g.replay()
                n["replays"] += 1
                rep_s.synchronize()

    threads = [threading.Thread(target=guarded(f), name=f.__name__)
               for f in (capturer, dropper, owner, replayer)]
    for t in threads:
        t.start()
    stop.wait(seconds)
    stop.set()
    for t in threads:
        t.join()
    rep_s.synchronize()
    if float(y[0]) != 4.0 * n["replays"] or float(x.abs().max()) != 0.0:
        errors.append(f"replayed sums: y {float(y[0])} for {n['replays']} "
                      f"rounds of 4, x {float(x.abs().max())}")
    del made[:]
    return dict(n, errors=errors)


def _graph_churn_child(seconds, results):
    import faulthandler

    faulthandler.enable()
    install_crash_trace(2)
    results.put(graph_churn(seconds))


def _graph_churn_step(smi, seconds=CHURN_S):
    """phase_mesh (b)'s reproducer of two torch races that kill a process
    freeing a finished owner beside a capture: ``graph_churn`` in a
    spawned process, so a crash is a failed step.  Fails on a crash, an error in a thread or a failed capture; at
    most ``seconds`` + 35 s."""
    import multiprocessing as mp
    import queue as queue_mod

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    t0 = time.perf_counter()
    proc = ctx.Process(target=_graph_churn_child, args=(seconds, results))
    proc.start()
    got = None
    while got is None and time.perf_counter() - t0 < seconds + 30:
        try:
            got = results.get(timeout=1.0)
        except queue_mod.Empty:
            if not proc.is_alive():
                break
    proc.join(5)
    if proc.is_alive():
        proc.kill()
        proc.join()
    wall = time.perf_counter() - t0
    print(f"graph churn ({seconds:.0f} s, a process of its own): "
          f"{got}, exit code {proc.exitcode}, {wall:.2f} s [{smi}]")
    if got is None or proc.exitcode != 0 or got["errors"]:
        raise AssertionError(f"graph churn: exit code {proc.exitcode}, "
                             f"{got}")
    return dict(got, wall_s=wall)


def soak(natural=SOAK_SPAWNS, recapture=SOAK_RECAPTURE_SPAWNS,
         one_by_two=SOAK_ONE_BY_TWO, recapture_loops=SOAK_RECAPTURE_LOOPS,
         out=None, smi=None):
    """The capture soak: fresh ``launch_local(2, ...)`` spawns on this
    card, each running phase_mesh (b)'s sequence (the checks, then the
    quickstart loop) under a ``CaptureRecorder`` in both ranks: ``natural``
    on 2x1, ``recapture`` on 2x1 with the leader's trainer recapturing
    every round over ``recapture_loops`` loops in the spawn (a loop makes
    4-11 rounds), ``one_by_two`` on 1x2, interleaved.  Prints one line a
    spawn and the totals, writes every spawn's results (failed windows'
    logs included) to ``out`` (JSON) when given, and raises at the end if
    any capture failed, any spawn failed (a rank that crashed included),
    or two live streams shared one CUDA stream.  With ``out``, each spawn
    keeps a ``_SoakLog`` in a folder named after it (every rank's stacks
    at a crash, ``live`` after every loop), and the JSON is rewritten after
    every spawn.  Each rank runs under ``faulthandler`` and the native
    crash trace (``install_crash_trace``): a crashed spawn's line prints
    the top native frames of the rank that died.  Ranks that ran loop
    after loop once segfaulted under this recorder: it kept a weak
    reference to every pool stream, which torch 2.11 leaves pointing at
    the freed wrapper, and each trainer capture's read incremented the
    word of whatever object reused that memory (PERF.md section 6); the
    recorder now marks a stream dead by a finalizer instead.
    To run it alone on the card:
    ``PYTHONPATH=src python -c "import chip_smoke as c;
    c.soak(out='soak.json')"``."""
    smi = smi or platform.nvidia_smi()
    _build.build_all()
    plan = ([((2, 1), False)] * natural + [((2, 1), True)] * recapture
            + [((1, 2), False)] * one_by_two)
    # interleave the kinds so that each spreads over the whole run
    plan = [x for _, x in sorted(
        (i / max(plan.count(k), 1) + 1e-9 * j, k)
        for j, k in enumerate(dict.fromkeys(plan))
        for i in range(plan.count(k)))]
    rows, t0 = [], time.perf_counter()
    for i, (shape, rc) in enumerate(plan):
        logs = str(Path(out).with_suffix("") / f"spawn{i}") if out else None
        outs, wall = _soak_spawn(shape, rc, True, recapture_loops if rc else 1,
                                 log_dir=logs)
        rows.append({"outs": outs, "wall_s": wall})
        print(_soak_line(i, outs, wall, smi), flush=True)
        if logs:
            rows[-1]["progress"] = got = _soak_progress(logs)
            err = " ".join(o.get("error", "") for o in outs)
            if _crashed(err):
                done = [g["loops_done"] for g in got.values()]
                last = [(g["live"] or [None])[-1] for g in got.values()]
                print(f"soak {i} crashed: loops finished {done}, live after "
                      f"the last {last}", flush=True)
                for r, g in got.items():
                    if g["native"]:
                        print(f"soak {i} {r} native: {g['native']['crash']}"
                              + "".join(f"\n  {f}"
                                        for f in g["native"]["frames"]),
                              flush=True)
            _write_soak(out, smi, _soak_totals(rows), rows)
    total = _soak_totals(rows)
    print(f"soak totals: {json.dumps(total)} in "
          f"{time.perf_counter() - t0:.2f} s [{smi}]", flush=True)
    if out:
        _write_soak(out, smi, total, rows)
    if total["failed_captures"] or total["failed_spawns"] or \
            total["shared_streams"]:
        raise AssertionError(f"soak: {total}")
    return total


def _write_soak(out, smi, total, rows):
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    Path(out).write_text(json.dumps({"smi": smi, "totals": total,
                                     "spawns": rows}, default=str))


def soak_forms(rounds=2, loops=SOAK_RECAPTURE_LOOPS, out=None, smi=None,
               forms=None):
    """Ten-loop 2x1 spawns (``loops`` loops a process, phase_mesh (b)'s
    checks in the first) in four forms, ``rounds`` of each, interleaved:
    the leader's trainer recapturing every round or not, each with and
    without the ``CaptureRecorder``.  Prints a line a spawn and one a form
    (spawns, crashed spawns, other failed spawns, failed captures) and
    writes the spawns to ``out`` (JSON) when given.  It measures and
    raises nothing: it tells the harness's share in a fault from the
    program's.  ``forms``: (recapture, recorder, collector) triples
    instead (``collector`` as ``_soak_rank`` takes it)."""
    smi = smi or platform.nvidia_smi()
    _build.build_all()
    forms = forms or [(rc, rec, "auto") for rc in (True, False)
                      for rec in (True, False)]
    names = [f"{'recapture' if rc else 'natural'} x{loops} loops, recorder "
             f"{_recorder_text(rec)}, collector {col}"
             for rc, rec, col in forms]
    table = {n: {"spawns": 0, "crashed": 0, "failed": 0,
                 "failed_captures": 0} for n in names}
    rows = []
    for i in range(rounds):
        for j, (rc, rec, col) in enumerate(forms):
            logs = (str(Path(out).with_suffix("") / f"round{i}_form{j}")
                    if out else None)
            outs, wall = _soak_spawn((2, 1), rc, True, loops, rec, logs, col)
            rows.append({"outs": outs, "wall_s": wall, "collector": col})
            if logs:
                rows[-1]["progress"] = _soak_progress(logs)
            print(_soak_line(f"form {i}", outs, wall, smi)
                  + f" collector {col}", flush=True)
            t = table[names[j]]
            err = " ".join(o["error"] for o in outs if "error" in o)
            t["spawns"] += 1
            t["crashed"] += _crashed(err)
            t["failed"] += bool(err) and not _crashed(err)
            t["failed_captures"] += sum(sum(o["failed"].values())
                                        for o in outs)
    for name, t in table.items():
        print(f"soak form {name}: {json.dumps(t)} [{smi}]", flush=True)
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps(
            {"smi": smi, "forms": table,
             "spawns": rows}, default=str))
    return table


def _crashed(error):
    """Whether a spawn's error says a rank died of a signal."""
    return "exited with code -" in error


def _soak_totals(rows):
    t = {"spawns": {}, "trainer_captures": {"natural": 0, "forced": 0},
         "failed_captures": 0, "failed_spawns": 0, "shared_streams": 0,
         "labels_per_s": {}, "send_ms": {}, "gc_in_window": 0,
         "in_window": {}}
    for r in rows:
        lead = r["outs"][0]
        kind = (f"{lead['shape'][0]}x{lead['shape'][1]} "
                f"{'recapture' if lead['recapture'] else 'natural'}")
        t["spawns"][kind] = t["spawns"].get(kind, 0) + 1
        tc = lead.get("pal_captures", {}).get("trainer", 0)
        t["trainer_captures"]["natural"] += tc - lead["forced"]
        t["trainer_captures"]["forced"] += lead["forced"]
        t["failed_captures"] += sum(sum(o["failed"].values())
                                    for o in r["outs"])
        t["failed_spawns"] += any("error" in o for o in r["outs"])
        t["shared_streams"] += sum(len(o["shared_streams"])
                                   for o in r["outs"])
        for o in r["outs"]:
            t["gc_in_window"] += o["gc_in_window"]
            for k, v in o["in_window"].items():
                t["in_window"][k] = t["in_window"].get(k, 0) + v
        p = lead.get("pal")
        if p:
            t["labels_per_s"].setdefault(kind, []).append(p["labels_per_s"])
            t["send_ms"].setdefault(kind, []).append(p["send_ms"])
    for k, v in t["labels_per_s"].items():
        t["labels_per_s"][k] = {"median": float(np.median(v)),
                                "min": min(v), "max": max(v)}
    for k, v in t["send_ms"].items():
        t["send_ms"][k] = {lane: float(np.median([s[lane] for s in v]))
                           for lane in ("engine", "trainer")}
    return t


def _mesh_flash_times(smi):
    """The partials and combine entries alone at the llama decode shape
    (each rank's 288-key half; the merge of 2 ranks), held against their
    plain versions and timed beside them, their bounds and the one-rank
    split path on the whole cache."""
    B, T, S, H, KV, D = MESH_ATTN
    dtype = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v, kvl = _fa_inputs(B, T, S, H, KV, D, dtype, gen, MESH_KV_LEN)
    qo, n = max(MESH_KV_LEN) - 1, 2
    halves = []
    for r in range(n):
        lo = r * S // n
        halves.append((k[:, lo:lo + S // n].contiguous(),
                       v[:, lo:lo + S // n].contiguous(),
                       (kvl - lo).clamp(min=0), qo - lo))
    kl, vl, kvl0, qo0 = halves[0]
    p = fa_kernel.plan(B, T, S // n, H, KV)

    def partials():
        return fa_kernel.flash_partials(q, kl, vl, q_offset=qo0,
                                        kv_len=kvl0)[0]

    def plain_partials():
        return fa_kernel.pack_partials(*fa_kernel.split_kv_partials(
            q, kl, vl, splits=p.splits, keys_per_split=p.keys_per_split,
            q_offset=qo0, kv_len=kvl0))

    parts = torch.cat([fa_kernel.flash_partials(
        q, a, b, q_offset=o, kv_len=c)[0] for a, b, c, o in halves])

    def combine():
        return fa_kernel.flash_combine(parts, ranks=n, splits=p.splits,
                                       B=B, T=T, H=H, KV=KV, D=D,
                                       dtype=dtype)

    def plain_combine():
        m, l, acc = (torch.cat(x) for x in zip(*(
            fa_kernel.unpack_partials(c, B, T, H, KV, D, p.splits)
            for c in parts.reshape(n, -1))))
        return fa_kernel.combine_partials(m, l, acc, dtype)

    tol = FA_TOL[dtype]
    want_o = ref.attention_ref(q, k, v, causal=True, q_offset=qo,
                               kv_len=kvl)
    err = {"partials": _max_err(partials(), plain_partials(), tol, tol,
                                "flash_partials vs plain"),
           "combine": max(_max_err(combine().float(), plain_combine().float(),
                                   tol, tol, "flash_combine vs plain"),
                          _max_err(combine().float(), want_o.float(), tol,
                                   tol, "flash_combine vs attention"))}
    torch.cuda.synchronize()
    es = torch.tensor([], dtype=dtype).element_size()
    keys = sum(min(x, S // n) for x in MESH_KV_LEN)   # the first half's
    pbytes = B * T * H * p.splits * (D + 2) * 4
    t_bytes = (es * (B * T * H * D + 2 * keys * KV * D) + pbytes) / \
        roofline.HBM_BW
    t_ops = 4 * H * T * D * keys / roofline.PEAK_FLOPS
    c_bytes = (n * pbytes + es * B * T * H * D) / roofline.HBM_BW
    t = {"partials": {
        "ms": graph_ms(partials, calls=10, replays=10),
        "plain_ms": graph_ms(plain_partials, calls=10, replays=10),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "max_abs_err": err["partials"],
        "splits": p.splits}, "combine": {
        "ms": graph_ms(combine, calls=10, replays=10),
        "plain_ms": graph_ms(plain_combine, calls=10, replays=10),
        "bound_ms": c_bytes * 1e3, "bound_by": "bytes",
        "library_ms": None, "max_abs_err": err["combine"]}}
    t["split_ms"] = graph_ms(lambda: ops.attention(
        q, k, v, causal=True, q_offset=qo, kv_len=kvl), calls=10,
        replays=10)
    print(f"flash partials (the rank's {S // n} keys, {p.splits} splits) "
          f"{t['partials']['ms']:.6f} ms (plain "
          f"{t['partials']['plain_ms']:.6f}, bound "
          f"{t['partials']['bound_ms']:.6f} {t['partials']['bound_by']}); "
          f"combine of {n} ranks {t['combine']['ms']:.6f} ms (plain "
          f"{t['combine']['plain_ms']:.6f}, bound "
          f"{t['combine']['bound_ms']:.6f} bytes); the one-rank split path "
          f"on {S} keys {t['split_ms']:.6f} ms [{smi}]")
    return t


def _same_pal_run(shape, pals):
    """Both ranks of a 2-rank PAL run: one stop token, the same dispatches,
    captures and handoffs."""
    lead, follow = sorted(pals, key=lambda p: p["rank"])
    if not lead["leader"] or follow["leader"]:
        raise AssertionError(f"PAL on {shape}: rank 0 must lead")
    for k in ("token", "dispatches", "captures", "handoffs", "launches"):
        if lead[k] != follow[k]:
            raise AssertionError(f"PAL on {shape}: {k} {lead[k]} on the "
                                 f"leader, {follow[k]} on the follower")


def _print_mesh_pal(host, b, smi):
    """The 2-rank PAL runs beside ``PAL(uq_mesh='host')``'s in (a)."""
    print(f"mesh PAL 1x1 (NCCL, one rank): {host['labels_per_s']:.4f} "
          f"labels/s, exchange it/s busy {host['it_busy']:.4f} idle "
          f"{host['it_idle']:.4f}, retrains {host['retrains']}, "
          f"{host['launches']} committee_uq launches for "
          f"{host['dispatches']} dispatches [{smi}]")
    for shape, outs in b.items():
        for o in sorted((o["pal"] for o in outs), key=lambda p: p["rank"]):
            head = (f"mesh PAL {shape[0]}x{shape[1]} rank {o['rank']} "
                    f"({'leader' if o['leader'] else 'follower'}): ")
            if o["leader"]:
                head += (f"{o['labels_per_s']:.4f} labels/s, exchange it/s "
                         f"busy {o['it_busy']:.4f} idle {o['it_idle']:.4f}, "
                         f"retrains {o['retrains']}, ")
            print(head + f"{o['launches']} committee_uq launches = "
                  f"{o['dispatches']} dispatches + 2 x {o['captures']} "
                  f"captures, {o['handoffs']} handoffs at 0 host bytes, "
                  f"control send ms a call engine "
                  f"{o['send_ms']['engine']:.4f} ({o['calls']['engine']} "
                  f"calls; first {o['first_send_ms']['engine']:.4f}, the "
                  f"rest {o['later_send_ms']['engine']:.4f}) trainer "
                  f"{o['send_ms']['trainer']:.4f} ({o['calls']['trainer']} "
                  f"calls; first {o['first_send_ms']['trainer']:.4f}, the "
                  f"rest {o['later_send_ms']['trainer']:.4f}), stop "
                  f"decision ms a "
                  f"step {o['decide_ms']:.4f} ({o['decides']} steps), "
                  f"collective_host_bytes {o['collective_host_bytes']}, "
                  f"stop {o['token']} after {o['wall_s']:.3f} s [{smi}]")


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dist_cli_smoke():
    """The CLI's two-process check on this card: 2 gloo ranks, one TCP
    coordinator, ``DIST_OK 2 2 28.0`` from both."""
    import os
    import subprocess

    port = _free_port()
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo",
               PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.distributed",
         "--coordinator", f"127.0.0.1:{port}", "--processes", "2",
         "--process-id", str(i), "--backend", "gloo", "--demo"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for i in range(2)]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        if p.returncode != 0 or "DIST_OK 2 2 28.0" not in out:
            raise AssertionError(f"distributed CLI: rc {p.returncode}\n"
                                 f"{out}\n{err[-2000:]}")
    return [o.strip() for o, _ in outs]


def phase_mesh(smi):
    """Multi-device on one card.  (a) World size 1 over NCCL: the 1x1 mesh
    engine == the unsharded engine bit for bit over 4 advancing rounds
    with the budget and re-weighting rules (state included; one capture,
    launches == dispatches + 2), the 1x1 mesh trainer == the unsharded
    one bit for bit over 20 captured steps with a 0-host-byte handoff, and
    ``PAL(uq_mesh='host')`` through the quickstart loop to its stop (cut:
    300 proposals per generator, not 1000).  (b) Two gloo ranks sharing
    this card (``launch_local``; the kernels were built before the spawn)
    on meshes 2x1 and 1x2: the engine against an unsharded engine on the
    same card (mean rtol 1e-5 atol 1e-6, stds rtol 1e-4 atol 1e-6, masks
    equal where the statistics are, rule state equal), the trainer (2x1
    bit for bit, 1x2 rtol 1e-5 atol 1e-6), the fleet on 2x1 at noise 0,
    ``attention(kv_seq_shard=True)`` at the llama decode shape in bf16
    and fp32 against the one-rank kernel and the plain version, and each
    rank's launch counts; then on each mesh ``PAL`` through the quickstart
    loop, cut as in (a) (``_mesh_pal``: both ranks one stop token and the
    same dispatches, captures and handoffs); then one more 2x1 loop in
    which the leader's trainer recaptures every round, under a
    ``CaptureRecorder`` (``_soak_short``: 0 failed captures); then the
    graph churn in a process of its own (``_graph_churn_step``: 0
    crashes, 0 errors); then the CLI's ``DIST_OK 2 2 28.0``.  Prints a
    64-row dispatch's host ms on 1x1 and 2x1 beside the unsharded
    engine's, the 2-rank loops' numbers beside the one-rank loop's, and
    the partials/combine entries' device ms beside the split path's."""
    import tempfile

    from repro_torch.launch import distributed
    from repro_torch.launch.mesh import make_host_mesh

    # --- (a) one rank over NCCL -------------------------------------------
    distributed.initialize(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        if torch.distributed.get_backend() != "nccl":
            raise AssertionError("world size 1 did not come up on NCCL")
        one = torch.ones(1, device="cuda")
        torch.distributed.all_reduce(one)
        if float(one) != 1.0:
            raise AssertionError("NCCL all_reduce over one rank")
        host = make_host_mesh()
        a_eng = _mesh_engine_check(host, exact=True, what="1x1 engine")
        tm, _ = _mesh_trainers(host, "1x1", exact=True)
        eng = a_eng.pop("engine")
        eng.refresh_from_device(tm.snapshot_cparams())
        if eng.refresh_host_bytes != 0 or eng.device_refreshes != 1:
            raise AssertionError("1x1 handoff moved host bytes")
        with tempfile.TemporaryDirectory() as tmp:
            pal = _runtime_pal(tmp, uq_mesh="host", steps=MESH_PAL_STEPS)
            if dict(pal.engine.mesh.shape) != {"data": 1, "model": 1} or \
                    pal.committee_trainer.mesh is not pal.engine.mesh:
                raise AssertionError("PAL(uq_mesh='host'): no host mesh")
            clock = _LoopClock(pal)
            before = cuq_kernel.launches
            rep, c, bad, t0, t1 = _run_until_stop(pal, "PAL on the mesh")
            launches = cuq_kernel.launches - before
            it_busy, it_idle, *_ = clock.split(t0, t1)
            pe = pal.engine
            tok = pal.stop_token
            if tok is None or not tok.origin.startswith("generator") or \
                    any(bad.values()):
                raise AssertionError(f"PAL on the mesh: stop {tok}, {bad}")
            if any(v != 1 for v in pe.trace_counts.values()) or \
                    launches != pe.dispatches + 2 * len(pe.trace_counts) \
                    or pe.refresh_host_bytes != 0:
                raise AssertionError(
                    f"PAL on the mesh: captures {pe.trace_counts}, "
                    f"{launches} launches for {pe.dispatches} dispatches, "
                    f"{pe.refresh_host_bytes} handoff host bytes")
            pal_stats = {"labels": rep["labeled_total"],
                         "retrains": c.get("train.retrains", 0),
                         "wall_s": t1 - t0, "launches": launches,
                         "dispatches": pe.dispatches,
                         "labels_per_s": rep["labeled_total"] / (t1 - t0),
                         "it_busy": it_busy, "it_idle": it_idle}
            del pal
    finally:
        distributed.shutdown()
    print(f"mesh (a) 1x1 over NCCL: engine and trainer bit for bit; a "
          f"{MESH_ROWS}-row dispatch {a_eng['mesh_ms']:.4f} ms on the mesh, "
          f"{a_eng['unsharded_ms']:.4f} ms unsharded (host ms, "
          f"{MESH_DISPATCHES} calls); PAL(uq_mesh='host') {pal_stats} "
          f"[{smi}]")

    # --- (b) two gloo ranks sharing the card ------------------------------
    b = {}
    for shape in ((2, 1), (1, 2)):
        with tempfile.TemporaryDirectory() as tmp:
            b[shape] = distributed.launch_local(2, _mesh_rank, shape, tmp,
                                                device="cuda:0", timeout=600)
        _same_pal_run(shape, [o["pal"] for o in b[shape]])
    recap = _soak_short(smi)
    churn = _graph_churn_step(smi)
    cli = _dist_cli_smoke()
    for shape, outs in b.items():
        for o in outs:
            e = o["engine"]
            print(f"mesh (b) {shape} rank {o['rank']}: engine worst "
                  f"{e['worst']:.3e}, {e['launches']} committee_uq "
                  f"launches for {e['dispatches']} dispatches, members "
                  f"{e['members']}, rows {e['rows']}; a {MESH_ROWS}-row "
                  f"dispatch {e['mesh_ms']:.4f} ms on the mesh "
                  f"(collectives {e['collective_ms']:.4f} ms, "
                  f"{e['collective_host_bytes']} bytes staged), "
                  f"{e['unsharded_ms']:.4f} ms unsharded; trainer worst "
                  f"{o['train_worst']:.3e} ({o['train_local']} members); "
                  f"kv_seq_shard {o['kv_range']} worst {o['attn_worst']}, "
                  f"(partials, combine) launches {o['attn_launches']}"
                  + (f"; fleet worst {o['fleet'][0]:.3e}, "
                     f"{o['fleet'][1]} steps" if "fleet" in o else "")
                  + f" [{smi}]")
    print(f"distributed CLI: {cli}")
    _print_mesh_pal(pal_stats, b, smi)
    times = _mesh_flash_times(smi)
    attn = [o for outs in b.values() for o in outs]
    return {"a": a_eng, "pal": pal_stats, "b": b, "times": times,
            "recapture": recap, "churn": churn,
            "partials_launches": sum(o["attn_launches"][0] for o in attn),
            "combine_launches": sum(o["attn_launches"][1] for o in attn),
            "cuq_launches": a_eng["launches"] + sum(
                o["engine"]["launches"] for o in attn),
            "attn_worst": max(max(o["attn_worst"].values()) for o in attn)}


# ---------------------------------------------------------------------------
# 4. flash_attention against its plain version
# ---------------------------------------------------------------------------


def _fa_inputs(B, T, S, H, KV, D, dtype, gen, kv_len=None, q_scale=1.0,
               v_scale=1.0):
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               for shape in ((B, T, H, D), (B, S, KV, D), (B, S, KV, D)))
    q, k, v = (q * q_scale).to(dtype), k.to(dtype), (v * v_scale).to(dtype)
    kvl = (None if kv_len is None else
           torch.tensor(kv_len, dtype=torch.int32, device="cuda"))
    return q, k, v, kvl


def _check_fa(B, T, S, H, KV, D, dtype, gen, causal=True, window=None,
              q_offset=0, kv_len=None, path=None, q_scale=1.0, v_scale=1.0):
    """Kernel vs plain version on one input (q and v scaled by ``q_scale``
    and ``v_scale``); the call must take the path of the wrapper's rule
    (and ``path`` when given) by the per-path counts.  ``q_offset="device"``:
    the decode entry with the position on the device, each row's offset
    ``kv_len - T`` as a tensor.  Returns the worst abs error."""
    q, k, v, kvl = _fa_inputs(B, T, S, H, KV, D, dtype, gen, kv_len,
                              q_scale, v_scale)
    kw = dict(causal=causal, window=window, kv_len=kvl,
              q_offset=kvl - T if q_offset == "device" else q_offset)
    want_path = fa_kernel.plan(B, T, S, H, KV).path
    if path is not None and path != want_path:
        raise AssertionError(f"the rule sends {(B, T, S, H, KV)} to "
                             f"{want_path}, the case expects {path}")
    before = (fa_kernel.launches_tiled, fa_kernel.launches_split)
    got = ops.attention(q, k, v, **kw)
    step = (fa_kernel.launches_tiled - before[0],
            fa_kernel.launches_split - before[1])
    want = ref.attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    tag = (f"flash B={B} T={T} S={S} H={H} KV={KV} D={D} {dtype} "
           f"causal={causal} window={window} q_offset={q_offset} "
           f"kv_len={kv_len} q x{q_scale} v x{v_scale}")
    if step != ((1, 0) if want_path == "tiled" else (0, 1)):
        raise AssertionError(f"{tag}: (tiled, split) launches {step}, "
                             f"expected one {want_path}")
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{tag}: output {tuple(got.shape)} {got.dtype} "
                             f"vs {tuple(want.shape)} {want.dtype}")
    tol = FA_TOL[dtype]
    return _max_err(got.float(), want.float(), tol, tol, tag)


def fa_bound(B, T, H, KV, D, dtype, causal, kv_len, window=None):
    """Least time for the work, in ms: q, o and the visible K/V rows moved
    once (per batch row, ``kv_len`` keys; a decode row sees the last
    ``window`` of them), against the scores and the AV product over the
    visible keys (causal prefill: 2*B*H*T^2*D, half of 4*B*H*T^2*D, less
    the (T - window)^2 / 2 pairs past a window), at the peak rate of the
    inputs' type."""
    esize = torch.tensor([], dtype=dtype).element_size()
    if window is not None and not causal:
        kv_len = [min(n, window) for n in kv_len]
    keys = sum(kv_len)                            # summed over the batch
    nbytes = esize * (2 * B * T * H * D + 2 * keys * KV * D)
    pairs = T * T / 2 - (max(T - window, 0) ** 2 / 2 if window else 0)
    flops = (4 * B * H * pairs * D if causal else 4 * H * T * D * keys)
    peak = (roofline.PEAK_FLOPS if dtype == torch.bfloat16
            else roofline.PEAK_FP32_FLOPS)
    t_bytes, t_ops = nbytes / roofline.HBM_BW, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _sdpa_inputs(q, k, v, kvl, causal, window=None, q_offset=0):
    """The same attention for ``scaled_dot_product_attention``: heads
    second, K/V expanded to H heads, a boolean key mask for ``kv_len``;
    with a ``window``, the whole mask (``ref._mask``: causal, window,
    ``q_offset``) as a boolean (B or 1, 1, T, S), and ``is_causal`` False.
    Returns (q, k, v, mask, is_causal)."""
    G = q.shape[2] // k.shape[2]
    qs = q.transpose(1, 2).contiguous()
    ks = k.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    vs = v.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    T, S = q.shape[1], k.shape[1]
    kpos = torch.arange(S, device=q.device)
    mask = None
    if window is not None:
        mask = ref._mask(T, S, q_offset, causal, window, q.device)
        mask = mask if mask.dim() == 3 else mask[None]
        if kvl is not None:
            mask = mask & (kpos[None, :] < kvl[:, None])[:, None, :]
        return qs, ks, vs, mask[:, None], False
    if kvl is not None:
        mask = (kpos[None, :] < kvl[:, None])[:, None, None, :]
    return qs, ks, vs, mask, causal


def _time_fa(name, B, T, S, H, KV, D, dtype, gen, causal, q_offset, kv_len,
             smi, window=None, plain=ref.attention_ref,
             reps=(10, 10, 50, 20)):
    """``q_offset="device"``: the decode entry, each row's offset ``kv_len -
    T`` a tensor on the card.  ``plain``: the plain version timed (and held
    against); ``reps``: calls a graph, its replays, eager calls and their
    warm-up calls."""
    q, k, v, kvl = _fa_inputs(B, T, S, H, KV, D, dtype, gen, kv_len)
    kw = dict(causal=causal, kv_len=kvl, window=window,
              q_offset=kvl - T if q_offset == "device" else q_offset)
    qs, ks, vs, mask, is_causal = _sdpa_inputs(q, k, v, kvl, causal, window,
                                               kw["q_offset"])
    kg, vg = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library():
        return sdpa(qs, ks, vs, attn_mask=mask, is_causal=is_causal)

    def library_gqa():                  # K/V not expanded (torch >= 2.5)
        return sdpa(qs, kg, vg, attn_mask=mask, is_causal=is_causal,
                    enable_gqa=True)

    # the yardsticks must compute the same function
    want = plain(q, k, v, **kw).float()
    _max_err(ops.attention(q, k, v, **kw).float(), want, FA_TOL[dtype],
             FA_TOL[dtype], f"{name}: the kernel")
    fns = {"ms": lambda: ops.attention(q, k, v, **kw),
           "plain_ms": lambda: plain(q, k, v, **kw),
           "library_ms": library, "library_gqa_ms": library_gqa}
    for key, f in (("library_ms", library), ("library_gqa_ms", library_gqa)):
        try:
            out = f().transpose(1, 2)
        except TypeError:               # this torch has no enable_gqa
            del fns[key]
            continue
        _max_err(out.float(), want, FA_TOL[dtype], FA_TOL[dtype],
                 f"{name}: sdpa yardstick {key}")
    calls, replays, iters, warmup = reps
    t = {key: graph_ms(f, calls=calls, replays=replays)
         for key, f in fns.items()}
    t.update({key.replace("ms", "eager_ms"): time_ms(f, iters=iters,
                                                     warmup=warmup)
              for key, f in fns.items()})
    t.setdefault("library_gqa_ms", None)
    keys = kv_len if kv_len is not None else [S] * B
    t["bound_ms"], t["bound_by"] = fa_bound(B, T, H, KV, D, dtype, causal,
                                            keys, window)
    p = fa_kernel.plan(B, T, S, H, KV)
    t["path"], t["splits"] = p.path, p.splits
    gqa = ("not taken by this torch" if t["library_gqa_ms"] is None
           else f"{t['library_gqa_ms']:.6f} ms")
    wnote = "" if window is None else f", window {window}"
    print(f"flash_attention {name} (B,T,S,H,KV,D)=({B},{T},{S},{H},{KV},{D}) "
          f"{dtype}{wnote}, {p.path} path ({p.splits} splits): device time "
          f"per call (CUDA graph) kernel {t['ms']:.6f} ms, plain "
          f"{t['plain_ms']:.6f} ms, scaled_dot_product_attention "
          f"{t['library_ms']:.6f} ms (K/V expanded), {gqa} (enable_gqa); "
          f"eager per call kernel {t['eager_ms']:.6f} ms, plain "
          f"{t['plain_eager_ms']:.6f} ms, sdpa "
          f"{t['library_eager_ms']:.6f} ms; bound {t['bound_ms']:.6f} ms "
          f"({t['bound_by']}) [{smi}]")
    return t


def sass_mma_counts(name):
    """HMMA/HGMMA instructions of each kernel function in the built library
    ``name``, from ``cuobjdump -sass``: {mangled function: count}."""
    import re
    import shutil
    import subprocess

    exe = shutil.which("cuobjdump") or str(
        Path(_build.nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([exe, "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn is not None and re.search(r"\bHG?MMA\b", line):
            counts[fn] += 1
    return counts


def phase_flash(smi):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst, cases = 0.0, 0
    f32, bf16 = torch.float32, torch.bfloat16
    n0 = (fa_kernel.launches_tiled, fa_kernel.launches_split)

    def check(*args, **kw):
        nonlocal worst, cases
        worst = max(worst, _check_fa(*args, gen=gen, **kw))
        cases += 1

    for dtype in (f32, bf16):
        # the reference's sweep (tests/test_kernels.py)
        for B, T, H, KV, D in ((1, 128, 4, 4, 64), (2, 256, 8, 2, 64),
                               (1, 128, 4, 1, 128)):
            for causal, window in ((True, None), (True, 64), (False, None)):
                check(B, T, T, H, KV, D, dtype, causal=causal, window=window,
                      path="tiled")
        # decode with kv_len, and the sliding-window decode
        check(3, 1, 192, 8, 4, 64, dtype, causal=False, q_offset=191,
              kv_len=[50, 192, 1], path="split")
        check(2, 1, 256, 4, 4, 64, dtype, causal=False, window=64,
              q_offset=255, kv_len=[200, 256], path="split")
        # ragged T and S
        check(2, 100, 100, 8, 2, 64, dtype)
        check(2, 200, 577, 8, 2, 64, dtype, causal=False)
        check(1, 577, 577, 4, 4, 64, dtype, window=200)
        check(2, 1, 577, 8, 2, 64, dtype, causal=False, q_offset=576,
              kv_len=[577, 300])
        # head dims 16 and 120
        check(2, 64, 64, 4, 2, 16, dtype)
        check(2, 1, 100, 4, 2, 16, dtype, causal=False, q_offset=99,
              kv_len=[100, 37])
        check(1, 200, 200, 8, 8, 120, dtype, window=64)
        check(2, 1, 300, 8, 8, 120, dtype, causal=False, q_offset=299,
              kv_len=[300, 123])
        # the two llama3.2-1b serving shapes
        check(8, 512, 512, 32, 8, 64, dtype, path="tiled")
        check(8, 1, 576, 32, 8, 64, dtype, causal=False, q_offset=511,
              kv_len=list(range(512, 576, 9)), path="split")
        # the redesign's paths: a multi-token decode past the split rows
        # (tiled, with q_offset and kv_len), a two-token decode (split),
        # kv_len 0 and 1, kv_len on and either side of the split
        # boundaries (9 splits of 64 keys), G = 8 at D = 128 (the Jamba
        # shapes) and a split decode at every head dim
        check(2, 8, 256, 8, 2, 64, dtype, q_offset=200, kv_len=[208, 150],
              path="tiled")
        check(2, 2, 300, 8, 2, 64, dtype, q_offset=298, window=100,
              kv_len=[300, 250], path="split")
        check(3, 1, 192, 8, 4, 64, dtype, causal=False, q_offset=191,
              kv_len=[0, 1, 192], path="split")
        check(8, 1, 576, 32, 8, 64, dtype, causal=False, q_offset=575,
              kv_len=[63, 64, 65, 127, 128, 129, 575, 576], path="split")
        check(8, 512, 512, 64, 8, 128, dtype, path="tiled")
        check(8, 1, 576, 64, 8, 128, dtype, causal=False, q_offset=511,
              kv_len=list(range(512, 576, 9)), path="split")
        for D in (16, 120, 128):
            check(4, 1, 576, 16, 2, D, dtype, causal=False, q_offset=575,
                  kv_len=[0, 64, 300, 576], path="split")
        # the rest of the LM zoo's shapes: the Whisper encoder (S = 1500,
        # H = KV = 12, non-causal), its cross-attention in the prefill
        # (T != S) and in a decode step (no kv_len), InternVL's prefill
        # (256 patches + 512 tokens, G = 2 at D = 128) and decode over its
        # 832-slot cache, qwen2-moe's prefill and decode (G = 1, D = 128)
        check(8, 1500, 1500, 12, 12, 64, dtype, causal=False, path="tiled")
        check(8, 64, 1500, 12, 12, 64, dtype, causal=False, path="tiled")
        check(8, 1, 1500, 12, 12, 64, dtype, causal=False, path="split")
        check(8, 768, 768, 16, 8, 128, dtype, path="tiled")
        check(8, 1, 832, 16, 8, 128, dtype, causal=False, q_offset=831,
              kv_len=list(range(769, 833, 8)), path="split")
        check(8, 512, 512, 16, 16, 128, dtype, path="tiled")
        check(8, 1, 576, 16, 16, 128, dtype, causal=False, q_offset=575,
              kv_len=list(range(513, 577, 8)), path="split")
        # the decode entry with the position on the device (ServeEngine's
        # captured decode): the llama and Jamba decode shapes, windows,
        # a two-token step (split) and an eight-token one (tiled)
        check(8, 1, 576, 32, 8, 64, dtype, causal=False, q_offset="device",
              kv_len=list(range(512, 576, 9)), path="split")
        check(8, 1, 576, 64, 8, 128, dtype, causal=False,
              q_offset="device", kv_len=list(range(512, 576, 9)),
              path="split")
        check(2, 1, 256, 4, 4, 64, dtype, causal=False, window=64,
              q_offset="device", kv_len=[200, 256], path="split")
        check(2, 2, 300, 8, 2, 64, dtype, q_offset="device", window=100,
              kv_len=[300, 250], path="split")
        check(2, 8, 256, 8, 2, 64, dtype, q_offset="device",
              kv_len=[208, 150], path="tiled")
        check(4, 1, 576, 16, 2, 128, dtype, causal=False, window=100,
              q_offset="device", kv_len=[1, 64, 300, 576], path="split")
        # the four archs served last: danube's d120 prefill past its
        # 4096-token window (B cut to 2: the plain version holds the
        # scores whole) and its windowed decode; minicpm's 36-head MHA;
        # nemo's; qwen3-moe's G = 16, whose one-token decode is 16 (t, g)
        # rows a kv head and takes the tiled path, kv_len 0 and 1 included
        check(2, 4608, 4608, 32, 8, 120, dtype, window=4096, path="tiled")
        check(8, 1, 4672, 32, 8, 120, dtype, causal=False, window=4096,
              q_offset="device", kv_len=list(range(4609, 4673, 8)),
              path="split")
        check(8, 512, 512, 36, 36, 64, dtype, path="tiled")
        check(8, 1, 576, 36, 36, 64, dtype, causal=False, q_offset="device",
              kv_len=list(range(513, 577, 8)), path="split")
        check(8, 512, 512, 32, 8, 128, dtype, path="tiled")
        check(8, 1, 576, 32, 8, 128, dtype, causal=False, q_offset="device",
              kv_len=list(range(513, 577, 8)), path="split")
        check(8, 512, 512, 64, 4, 128, dtype, path="tiled")
        check(8, 1, 576, 64, 4, 128, dtype, causal=False, q_offset="device",
              kv_len=list(range(513, 577, 8)), path="tiled")
        check(4, 1, 576, 64, 4, 128, dtype, causal=False, q_offset="device",
              kv_len=[0, 1, 300, 576], path="tiled")
        # sharp attention over large values that cancel, as a random-weight
        # LM's activations give (P must keep more than bf16's 8 bits)
        for D in (64, 128):
            check(2, 256, 256, 16, 2, D, dtype, q_scale=4.0, v_scale=100.0,
                  path="tiled")
            check(4, 1, 576, 16, 2, D, dtype, causal=False, q_offset=575,
                  kv_len=[1, 64, 300, 576], q_scale=4.0, v_scale=100.0,
                  path="split")
    n_tiled = fa_kernel.launches_tiled - n0[0]
    n_split = fa_kernel.launches_split - n0[1]
    print(f"flash_attention: kernel == plain version on {cases} cases "
          f"(fp32 and bf16; causal, window, kv_len, ragged T and S, "
          f"D in 16/64/120/128; {n_tiled} on the tiled path, {n_split} on "
          f"the split path); worst |err| {worst:.3e} (tol fp32 "
          f"{FA_TOL[f32]}, bf16 {FA_TOL[bf16]})")

    # the split path merges its partials in a fixed order: the same bits
    # on every call
    for dtype in (f32, bf16):
        q, k, v, kvl = _fa_inputs(8, 1, 576, 64, 8, 128, dtype, gen,
                                  list(range(512, 576, 9)))
        kw = dict(causal=False, q_offset=511, kv_len=kvl)
        outs = [ops.attention(q, k, v, **kw) for _ in range(3)]
        if not all(torch.equal(outs[0], o) for o in outs[1:]):
            raise AssertionError(f"split-KV decode ({dtype}) gave other "
                                 f"bits on a repeated call")
    print("flash_attention: three split-KV decode calls on the same inputs "
          "give identical bits (fp32 and bf16)")

    # the tensor cores, by the built code: every bf16 instance (tiled and
    # split) must hold HMMA/HGMMA instructions
    mma = {fn: c for fn, c in sass_mma_counts("flash_attention").items()
           if "flash_" in fn}
    short = {}
    for fn, c in sorted(mma.items()):
        kind = ("tiled" if "flash_tiled" in fn else "split_mma"
                if "flash_split_mma" in fn else "split" if "flash_split"
                in fn else "combine" if "flash_combine" in fn else "fp32")
        short.setdefault(kind, []).append(c)
        if kind in ("tiled", "split_mma") and c == 0:
            raise AssertionError(f"{fn}: no HMMA/HGMMA instruction")
    if "tiled" not in short or "split_mma" not in short:
        raise AssertionError("the built library lacks a bf16 tensor-core "
                             "kernel (flash_tiled_kernel, "
                             "flash_split_mma_kernel)")
    print("flash_attention SASS (cuobjdump -sass), HMMA/HGMMA instructions "
          "per kernel instance: " + "; ".join(
              f"{kind} {sorted(cs)}" for kind, cs in sorted(short.items())))

    timings = {
        "prefill": _time_fa("llama prefill", 8, 512, 512, 32, 8, 64, bf16,
                            gen, True, 0, None, smi),
        "decode": _time_fa("llama decode", 8, 1, 576, 32, 8, 64, bf16, gen,
                           False, 511, list(range(512, 576, 9)), smi),
        "decode_device": _time_fa(
            "llama decode, position on the device", 8, 1, 576, 32, 8, 64,
            bf16, gen, False, "device", list(range(512, 576, 9)), smi),
        "jamba_prefill": _time_fa("Jamba prefill", 8, 512, 512, 64, 8, 128,
                                  bf16, gen, True, 0, None, smi),
        "jamba_decode": _time_fa("Jamba decode", 8, 1, 576, 64, 8, 128,
                                 bf16, gen, False, 511,
                                 list(range(512, 576, 9)), smi),
        "whisper_encoder": _time_fa("Whisper encoder", 8, 1500, 1500, 12,
                                    12, 64, bf16, gen, False, 0, None, smi),
        "whisper_cross_decode": _time_fa(
            "Whisper cross-attention decode", 8, 1, 1500, 12, 12, 64, bf16,
            gen, False, 0, None, smi),
        "internvl_prefill": _time_fa("InternVL prefill", 8, 768, 768, 16,
                                     8, 128, bf16, gen, True, 0, None, smi),
        "moe_prefill": _time_fa("qwen2-moe prefill", 8, 512, 512, 16, 16,
                                128, bf16, gen, True, 0, None, smi),
        # the four archs served last (decodes through the device-offset
        # entry, as the captured decode runs them); danube's prefill timed
        # with fewer calls, its plain version by query rows of 512
        "danube_prefill": _time_fa(
            "danube prefill", 8, 4608, 4608, 32, 8, 120, bf16, gen, True, 0,
            None, smi, window=4096, plain=attention_ref_rows,
            reps=(2, 3, 3, 1)),
        "danube_decode": _time_fa(
            "danube decode", 8, 1, 4672, 32, 8, 120, bf16, gen, False,
            "device", list(range(4609, 4673, 8)), smi, window=4096),
        "minicpm_prefill": _time_fa("minicpm prefill", 8, 512, 512, 36, 36,
                                    64, bf16, gen, True, 0, None, smi),
        "minicpm_decode": _time_fa(
            "minicpm decode", 8, 1, 576, 36, 36, 64, bf16, gen, False,
            "device", list(range(513, 577, 8)), smi),
        "nemo_prefill": _time_fa("nemo prefill", 8, 512, 512, 32, 8, 128,
                                 bf16, gen, True, 0, None, smi),
        "nemo_decode": _time_fa(
            "nemo decode", 8, 1, 576, 32, 8, 128, bf16, gen, False,
            "device", list(range(513, 577, 8)), smi),
        "qwen3_prefill": _time_fa("qwen3-moe prefill", 8, 512, 512, 64, 4,
                                  128, bf16, gen, True, 0, None, smi),
        "qwen3_decode": _time_fa(
            "qwen3-moe decode (G = 16, tiled)", 8, 1, 576, 64, 4, 128, bf16,
            gen, False, "device", list(range(513, 577, 8)), smi),
    }
    timings["sass_mma"] = {kind: sorted(cs) for kind, cs in short.items()}
    return worst, timings


# ---------------------------------------------------------------------------
# 5. the LM serving path at llama3.2-1b full width
# ---------------------------------------------------------------------------


def teacher_forced(model, params, prompt, gen_tokens, max_seq, n_prefix=0,
                   **extras):
    """Last-position logits (fp32) of a prefill of ``prompt`` (with the
    prefill's ``extras``: frame or patch embeddings) and of one decode step
    per token of ``gen_tokens`` but the last, fed those tokens at positions
    after the ``n_prefix`` prefix and the prompt: the logits that chose each
    generated token."""
    B = prompt.shape[0]
    cache = model.init_cache(B, max_seq, device=prompt.device)
    logits, cache = model.prefill(params, prompt, cache, **extras)
    out = [logits.float()]
    for i in range(gen_tokens.shape[1] - 1):
        logits, cache = model.decode_step(params, gen_tokens[:, i:i + 1],
                                          cache, n_prefix + prompt.shape[1]
                                          + i)
        out.append(logits.float())
    return torch.stack(out, dim=1)                  # (B, gen, V)


def _margin_tokens_agree(tokens, logits, tol_abs, what):
    """Tokens must be the argmax of ``logits`` wherever their top-2 margin
    exceeds ``tol_abs``; returns (positions checked, positions)."""
    top2 = logits.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > tol_abs
    want = logits.argmax(dim=-1)
    bad = sure & (want != tokens)
    if bool(bad.any()):
        raise AssertionError(f"{what}: {int(bad.sum())} tokens differ from "
                             f"the plain path where its margin exceeds "
                             f"{tol_abs:.3e}")
    return int(sure.sum()), sure.numel()


def _attention_f64(q, k, v, *, causal=True, window=None, q_offset=0,
                   kv_len=None, q_chunk=None):
    """Attention with the semantics of ``ref.attention_ref``, taken in
    float64 and rounded once to ``v.dtype``: a second correct version
    whose roundings differ from the plain one's."""
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    qd = q.double().reshape(B, T, KV, H // KV, D)
    s = torch.einsum("btkgd,bskd->bkgts", qd, k.double()) / np.sqrt(D)
    qpos = q_offset + torch.arange(T, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    m = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        m &= kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    m = m[None, None, None]
    if kv_len is not None:
        m = m & (kpos < kv_len[:, None])[:, None, None, None, :]
    p = torch.softmax(s.masked_fill(~m, float("-inf")), -1).nan_to_num(0.0)
    out = torch.einsum("bkgts,bskd->btkgd", p, v.double())
    return out.reshape(B, T, H, D).to(v.dtype)


GATE_ROWS = 512          # query rows of one plain call in the per-call gate


def attention_ref_rows(q, k, v, *, rows=GATE_ROWS, fn=ref.attention_ref,
                       q_offset=0, **kw):
    """``fn`` (``ref.attention_ref``, fp32 P) on ``rows`` query rows at a
    time, each slice at its own offset: the same function, with the scores
    of ``rows`` queries in memory at once (danube's prefill call, (8, 4608,
    4608) over 32 heads, would hold 21.7 GB of fp32 scores whole)."""
    return torch.cat([fn(q[:, i:i + rows], k, v, q_offset=q_offset + i,
                         **kw) for i in range(0, q.shape[1], rows)], dim=1)


# each LM serving phase's captured-against-eager numbers, by phase label
SERVING = {}


def _reserved_gib():
    """What the caching allocator holds on the card once its free blocks
    are released (a live CUDA graph's pool stays held)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved() / 2**30


def _eager_generate(eng, batch, gen):
    """The engine's loop without capture, op by op on the default
    stream: ``model_zoo.make_prefill_fn`` and ``make_decode_fn`` on the
    engine's params, a fresh cache, the position a host int, greedy (after
    one untimed prefill and step): the "before" of the captured engine.
    Returns (new tokens (B, gen) int32, the logits that chose them (B,
    gen, V) fp32, prefill s, decode ms a step, peak GiB allocated over the
    loop)."""
    m = eng.model
    dt = cm.torch_dtype(m.cfg.dtype)
    inputs = {k: torch.from_numpy(np.asarray(v)).to(
        "cuda", torch.int32 if k == "tokens" else dt)
        for k, v in batch.items()}
    B, P = batch["tokens"].shape
    n_prefix = m.cfg.vision_tokens if m.cfg.family == "vlm" else 0
    prefill = model_zoo.make_prefill_fn(m)
    decode = model_zoo.make_decode_fn(m)
    # an untimed prefill and decode step first, as the captured engine's
    # warm-up generate: the allocator's cache (emptied by the memory
    # readings) and the kernels are warm for the timed loop
    cache = m.init_cache(B, eng.max_seq, device="cuda")
    logits, cache = prefill(eng.params, inputs, cache)
    decode(eng.params, torch.argmax(logits, dim=-1).to(torch.int32)[:, None],
           cache, n_prefix + P)
    del cache, logits
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cache = m.init_cache(B, eng.max_seq, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(eng.params, inputs, cache)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    cur = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    toks, outs = [cur], [logits]
    t1 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = decode(eng.params, cur, cache, n_prefix + P + i)
        cur = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        toks.append(cur)
        outs.append(logits)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t1) / (gen - 1) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    return (torch.cat(toks, dim=1), torch.stack(outs, dim=1).float(),
            prefill_s, step_ms, peak)


def _captured_against_eager(label, eng, batch, res, reserved, smi):
    """The captured engine's counted ``generate`` (``res``) against the
    eager loop on the same prompt and weights: one prefill graph and one
    decode graph captured in all; decode ms a step, prefill s, memory; the
    captured tokens must be the eager loop's argmax wherever its top-2
    margin exceeds 1e-3 x max|logit|, up to the first position where the
    two runs' tokens part (after it each run conditions on its own
    tokens).  ``reserved``: ``_reserved_gib`` before and after the
    capturing generate."""
    P = batch["tokens"].shape[1]
    gen = res.tokens.shape[1] - P
    if eng.captures != 2:
        raise AssertionError(f"{label}: {eng.captures} graphs captured, not "
                             f"one prefill graph for ({LM_BATCH}, {P}) and "
                             f"one decode graph for B={LM_BATCH}")
    toks, logits, e_prefill, e_step, e_peak = _eager_generate(eng, batch,
                                                              gen)
    cap = torch.from_numpy(res.tokens[:, P:]).to("cuda")
    differ = cap != toks
    first = torch.where(differ.any(dim=1), differ.int().argmax(dim=1), gen)
    upto = torch.arange(gen, device="cuda")[None] <= first[:, None]
    scale = float(logits.abs().max())
    checked, total = _margin_tokens_agree(
        cap[upto], logits[upto], 1e-3 * scale,
        f"{label}: captured generate vs the eager loop")
    same = int((~differ).sum())
    step = res.decode_seconds / (gen - 1) * 1e3
    out = {"step_ms": step, "eager_step_ms": e_step,
           "prefill_s": res.prefill_seconds, "eager_prefill_s": e_prefill,
           "reserved_gib": reserved[1],
           "captured_extra_gib": reserved[1] - reserved[0],
           "eager_peak_gib": e_peak, "graphs": eng.captures,
           "tokens_identical": same, "tokens": differ.numel(),
           "margin_checked": checked}
    SERVING[label] = out
    print(f"{label}, captured against eager (the same prompt and weights): "
          f"decode {step:.4f} ms a step captured, {e_step:.4f} eager "
          f"({e_step / step:.2f}x); prefill {res.prefill_seconds:.4f} s "
          f"captured, {e_prefill:.4f} s eager; memory: {reserved[1]:.3f} GiB "
          f"held after the capture (params, the engine's buffers and its "
          f"graph pool; +{reserved[1] - reserved[0]:.3f} GiB for the "
          f"capture), the eager loop's peak {e_peak:.3f} GiB allocated (the "
          f"engine's buffers and graphs held too); {eng.captures} graphs "
          f"({eng.replays} replays); tokens identical at {same} of "
          f"{differ.numel()} positions, the captured == the eager loop's "
          f"argmax at {checked} of {total} positions (up to the first "
          f"parting) whose top-2 margin exceeds 1e-3 x max|logit| [{smi}]")
    del logits
    return out


def phase_lm(smi):
    cfg = get_arch(LM_ARCH).model
    max_seq = LM_PROMPT + LM_GEN
    model = model_zoo.build_model(cfg, max_seq=max_seq)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED),
                        device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for t in cmte.tree_leaves(params))
    eng = ServeEngine(model, params, max_seq=max_seq, batch=LM_BATCH,
                      device="cuda")
    prompt = np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT)).astype(np.int32)
    r0 = _reserved_gib()
    # warm-up, not counted: captures the prefill and the decode graph
    eng.generate({"tokens": prompt}, max_new_tokens=2)
    reserved = (r0, _reserved_gib())
    torch.cuda.reset_peak_memory_stats()

    fa_kernel.launches = 0                       # main path starts here
    fa_kernel.launches_tiled = fa_kernel.launches_split = 0
    res = eng.generate({"tokens": prompt}, max_new_tokens=LM_GEN)
    launches = fa_kernel.launches
    paths = (fa_kernel.launches_tiled, fa_kernel.launches_split)
    peak = torch.cuda.max_memory_allocated()
    want = cfg.num_layers * (1 + LM_GEN - 1)
    if launches != want:
        raise AssertionError(f"flash_attention launches {launches} != "
                             f"{cfg.num_layers} layers x (1 prefill + "
                             f"{LM_GEN - 1} decode steps) = {want}")
    if paths != (cfg.num_layers, cfg.num_layers * (LM_GEN - 1)):
        raise AssertionError(f"flash_attention (tiled, split) launches "
                             f"{paths}: every prefill call must be tiled "
                             f"and every decode call split")
    toks = res.tokens
    if toks.shape != (LM_BATCH, max_seq) or \
            not np.array_equal(toks[:, :LM_PROMPT], prompt) or \
            toks.min() < 0 or toks.max() >= cfg.padded_vocab:
        raise AssertionError(f"generated tokens misshapen or out of range: "
                             f"{toks.shape}")
    print(f"LM serving {LM_ARCH} full width ({cfg.num_layers} layers, d "
          f"{cfg.d_model}, {cfg.num_heads} heads, kv {cfg.num_kv_heads}, "
          f"vocab {cfg.vocab_size}, {n_params} params fp32, {cfg.dtype} "
          f"activations), init {t_init:.2f} s: B={LM_BATCH} prompt "
          f"{LM_PROMPT} + {LM_GEN} new tokens: prefill "
          f"{res.prefill_seconds:.4f} s, decode {res.decode_seconds:.4f} s "
          f"= {res.decode_tokens_per_s:.1f} tokens/s, peak memory "
          f"{peak / 2**30:.3f} GiB; flash_attention launches {launches} == "
          f"{cfg.num_layers} x (1 + {LM_GEN - 1}): {paths[0]} tiled "
          f"(prefill), {paths[1]} split (decode), counted by replay [{smi}]")
    _captured_against_eager(f"LM serving {LM_ARCH}", eng,
                            {"tokens": prompt}, res, reserved, smi)

    # teacher-forced runs over the generated tokens, on the card
    prompt_t = torch.from_numpy(prompt).to("cuda")
    gen_t = torch.from_numpy(toks[:, LM_PROMPT:].astype(np.int32)).to("cuda")
    lk = teacher_forced(model, eng.params, prompt_t, gen_t, max_seq)
    if not torch.isfinite(lk).all():
        raise AssertionError("kernel path: non-finite logits")
    scale = float(lk.abs().max())
    checked, total = _margin_tokens_agree(gen_t, lk, 1e-3 * scale,
                                          "generate vs its own replay")

    # every attention call of the plain path (prefill + 63 decode steps x
    # 16 layers), on the model's own activations, also through the kernel
    plain = model_zoo.build_model(cfg, impl="plain")
    calls, worst = 0, 0.0
    plain_attention = ops.plain_attention

    def shadowed(q, k, v, **kw):
        nonlocal calls, worst
        out = plain_attention(q, k, v, **kw)
        kw.pop("q_chunk", None)
        got = fa_kernel.flash_attention(q, k, v, device=q.device, **kw)
        tol = FA_TOL[q.dtype]
        worst = max(worst, _max_err(got.float(), out.float(), tol, tol,
                                    f"attention call {calls}"))
        calls += 1
        return out

    ops.plain_attention = shadowed
    try:
        lp = teacher_forced(plain, eng.params, prompt_t, gen_t, max_seq)
    finally:
        ops.plain_attention = plain_attention
    if calls != want:
        raise AssertionError(f"{calls} attention calls shadowed, not {want}")

    # A control for the end-to-end logits: the plain path again with its
    # attention taken in float64 (the same function, other roundings).
    # Random-weight layers amplify any rounding difference (see PERF.md),
    # so the logits of two correct attentions drift apart over 16 layers;
    # the drift of the kernel path is printed beside the control's.
    ops.plain_attention = _attention_f64
    try:
        l64 = teacher_forced(plain, eng.params, prompt_t, gen_t, max_seq)
    finally:
        ops.plain_attention = plain_attention
    p_scale = float(lp.abs().max())
    drift = float((lk - lp).abs().max()) / p_scale
    drift64 = float((l64 - lp).abs().max()) / p_scale
    print(f"LM serving: the kernel == plain attention on all {calls} "
          f"attention calls of a teacher-forced plain run over the "
          f"generated tokens (the model's own bf16 activations; worst "
          f"|err| {worst:.4e} at rtol = atol = {FA_TOL[torch.bfloat16]}); "
          f"generate's tokens == the argmax of its own teacher-forced "
          f"replay at {checked} of {total} positions whose top-2 margin "
          f"exceeds 1e-3 "
          f"x max|logit|; end-to-end logit drift from the plain path "
          f"(max |err| / max|logit| {p_scale:.4e}): kernel path "
          f"{drift:.4e}, float64-attention control {drift64:.4e}")
    del lk, lp, l64, eng, params
    torch.cuda.empty_cache()
    return launches, paths


# ---------------------------------------------------------------------------
# 6. card (kernel) against CPU (plain path), fp32, 2 layers
# ---------------------------------------------------------------------------


def _greedy_logits(model, params, prompt, steps, max_seq, n_prefix=0,
                   **extras):
    """Greedy prefill (with the prefill's ``extras``) + ``steps`` decode
    steps after the ``n_prefix`` prefix; (tokens (B, steps+1), logits (B,
    steps+1, V) fp32) — the logits that chose each token."""
    cache = model.init_cache(prompt.shape[0], max_seq, device=prompt.device)
    logits, cache = model.prefill(params, prompt, cache, **extras)
    toks, outs = [], []
    for i in range(steps + 1):
        outs.append(logits.float())
        toks.append(torch.argmax(logits, dim=-1).to(torch.int32))
        if i == steps:
            break
        logits, cache = model.decode_step(params, toks[-1][:, None], cache,
                                          n_prefix + prompt.shape[1] + i)
    return torch.stack(toks, dim=1), torch.stack(outs, dim=1)


def two_layers(arch):
    """``arch`` at full width cut to 2 layers, in fp32."""
    return get_arch(arch).model.replace(num_layers=2, dtype="float32")


class _RouteRecorder:
    """Records every MoE routing (``moe.route``) of a run on the host, per
    call (one call per layer per step): which experts each token chose
    (``sel``), whether it fit their capacity (``in_cap``) and the router
    probabilities, each (B, T, E)."""

    def __init__(self):
        self.calls = []
        self._route = moe_mod.route

    def __enter__(self):
        def route(p, x, cfg):
            r = self._route(p, x, cfg)
            B, T = x.shape[:2]
            self.calls.append(tuple(
                t.reshape(B, T, -1).cpu() for t in (r.sel, r.in_cap,
                                                    r.probs)))
            return r

        moe_mod.route = route
        return self

    def __exit__(self, *exc):
        moe_mod.route = self._route

    @property
    def chosen(self) -> int:
        return int(sum(c[0].sum() for c in self.calls))

    @property
    def dropped(self) -> int:
        return int(sum(((c[0] > 0) & ~c[1]).sum() for c in self.calls))


def routing_agreement(card, cpu, steps, top_k):
    """Where two runs routed alike: (agree (B, steps) bool — row b's
    tokens chose the same experts and kept the same capacity slots in every
    layer of steps 0..s — the choices that flipped, the slots that flipped,
    and the CPU's gap between the k-th and (k+1)-th router probability at
    each token whose choice flipped)."""
    if len(card.calls) != len(cpu.calls) or len(cpu.calls) % steps:
        raise AssertionError(f"routing calls: card {len(card.calls)}, CPU "
                             f"{len(cpu.calls)}, for {steps} steps")
    layers = len(cpu.calls) // steps
    B = cpu.calls[0][0].shape[0]
    row_ok = torch.ones((B, steps), dtype=torch.bool)
    sel_flips, cap_flips, gaps = 0, 0, []
    for i, ((sg, cg, _), (sc, cc, pc)) in enumerate(zip(card.calls,
                                                        cpu.calls)):
        ds, dc = sg != sc, cg != cc
        sel_flips += int(ds.sum())
        cap_flips += int((dc & ~ds).sum())
        row_ok[:, i // layers] &= ~(ds | dc).flatten(1).any(dim=1)
        flipped = ds.any(dim=-1)
        if bool(flipped.any()):
            top = pc[flipped].sort(dim=-1, descending=True).values
            gaps += (top[:, top_k - 1] - top[:, top_k]).tolist()
    return torch.cumprod(row_ok.int(), dim=1).bool(), sel_flips, \
        cap_flips, gaps


def prefill_extras(cfg, B, seed):
    """The prefill's inputs beside the tokens, numpy from ``seed``, as the
    serving CLI makes them (``launch/serve.prefill_inputs``)."""
    return serve.prefill_inputs(cfg, B, np.random.RandomState(seed))


def phase_card_vs_cpu(name, cfg, kernels, f64_control=None):
    """``cfg`` (an fp32 cut of ``name``): greedy prefill + 8 decode steps
    on the card against the CPU plain path, teacher-forced with the card's
    tokens (with ``prefill_extras``: frame or patch embeddings).
    ``kernels``: the wrapper modules whose launch counters the CPU path
    must leave alone.  A model with MoE layers in every layer (the moe
    family) is held where its routing agrees: each row's logits at each
    step whose routing, and every earlier step's, chose and kept the same
    experts on both (a near-tie in the router may flip a choice; the flips
    are counted and printed); any other model with MoE layers must drop
    the same choices on both.

    The encoder-decoder family is held against a control: the CPU path
    runs a second time with its attention in float64 (``_attention_f64``,
    rounded once), and the card's logits must lie within the tolerance
    plus twice that control's largest move of the CPU's: whisper-small's random-weight attention is nearly one-hot over
    1500 frames (scores of std ~66), so a change of rounding alone moves
    its fp32 logits by ~1e-3 of their max-abs, past the elementwise
    tolerance, and the card rounds its matmuls and its attention otherwise
    than the CPU does.  ``f64_control=True`` holds another arch so
    (``serve_rest``: h2o-danube-3-4b and mistral-nemo-12b, whose 2-layer
    random-weight scores have a std of about d_model / sqrt(H * KV), 240
    and 320, and where rtol = atol = 1e-3 alone failed on the card)."""
    B, P, steps = 2, 128, 8
    n_prefix = cfg.vision_tokens if cfg.family == "vlm" else 0
    max_seq = n_prefix + P + steps + 1
    routed = cfg.family == "moe"
    if f64_control is None:
        f64_control = cfg.family == "encdec"
    model = model_zoo.build_model(cfg, max_seq=max_seq)
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED + 1),
                        device="cuda")
    prompt = torch.from_numpy(np.random.RandomState(SEED + 1).randint(
        0, cfg.vocab_size, (B, P)).astype(np.int32))
    extras = {k: torch.from_numpy(v)
              for k, v in prefill_extras(cfg, B, SEED + 1).items()}
    with _RouteRecorder() as drops_g:
        toks_g, logits_g = _greedy_logits(
            model, params, prompt.to("cuda"), steps, max_seq, n_prefix,
            **{k: v.to("cuda") for k, v in extras.items()})
    before = [k.launches for k in kernels]
    params_c = cmte.tree_map(lambda t: t.cpu(), params)
    del params
    torch.cuda.empty_cache()
    # the CPU plain path, teacher-forced with the card's tokens
    with _RouteRecorder() as drops_c:
        cache = model.init_cache(B, max_seq, device="cpu")
        logits, cache = model.prefill(params_c, prompt, cache, **extras)
        outs = [logits]
        for i in range(steps):
            logits, cache = model.decode_step(
                params_c, toks_g[:, i:i + 1].cpu(), cache, n_prefix + P + i)
            outs.append(logits)
    logits_c = torch.stack(outs, dim=1)
    if [k.launches for k in kernels] != before:
        raise AssertionError("the CPU plain path launched a kernel")
    logits_g, toks_g = logits_g.cpu(), toks_g.cpu()
    ctrl_note, margin_extra = "", 0.0
    if f64_control:
        plain_attention = ops.plain_attention
        ops.plain_attention = _attention_f64
        try:
            cache = model.init_cache(B, max_seq, device="cpu")
            logits, cache = model.prefill(params_c, prompt, cache, **extras)
            outs = [logits]
            for i in range(steps):
                logits, cache = model.decode_step(
                    params_c, toks_g[:, i:i + 1], cache, n_prefix + P + i)
                outs.append(logits)
        finally:
            ops.plain_attention = plain_attention
        lf = torch.stack(outs, dim=1)
        ctrl = float((logits_c - lf).abs().max())
        d = (logits_g - logits_c).abs()
        bound = CPU_ATOL + CPU_RTOL * logits_c.abs() + 2 * ctrl
        if bool((d > bound).any()):
            raise AssertionError(
                f"{name}: {int((d > bound).sum())} logits outside the "
                f"tolerance + twice the control's move {ctrl:.3e} (card - "
                f"CPU max {float(d.max()):.3e})")
        over = int((d > CPU_ATOL + CPU_RTOL * logits_c.abs()).sum())
        margin_extra = 2 * ctrl
        ctrl_note = (f"; the CPU's fp32 path moves by up to {ctrl:.3e} "
                     f"(max |logit| {float(logits_c.abs().max()):.3e}) with "
                     f"its attention in float64, and the card lies within "
                     f"the tolerance + twice that of the CPU ({over} of "
                     f"{d.numel()} logits past the tolerance alone)")
    if routed:
        agree, sel_flips, cap_flips, gaps = routing_agreement(
            drops_g, drops_c, steps + 1, cfg.moe_top_k)
        if not bool(agree.any()):
            raise AssertionError(f"{name}: the routing differs in the "
                                 f"prefill of every row")
        logits_g, logits_c, toks_g = (t[agree] for t in (logits_g, logits_c,
                                                         toks_g))
        gap_note = (f", the CPU's k-th to (k+1)-th router probability gap "
                    f"at the flipped tokens max {max(gaps):.3e}"
                    if gaps else "")
        moe_note = (f"; MoE routing: {sel_flips} expert choices and "
                    f"{cap_flips} capacity slots of "
                    f"{drops_c.chosen} choices flipped between the card "
                    f"and the CPU{gap_note}; {drops_g.dropped} (card) and "
                    f"{drops_c.dropped} (CPU) choices dropped past "
                    f"capacity; logits held at {int(agree.sum())} of "
                    f"{agree.numel()} (row, step) positions whose routing "
                    f"agreed at every layer so far")
    elif (drops_g.dropped, drops_g.chosen) != (drops_c.dropped,
                                               drops_c.chosen):
        raise AssertionError(f"MoE drops differ: card {drops_g.dropped} of "
                             f"{drops_g.chosen}, CPU {drops_c.dropped} of "
                             f"{drops_c.chosen}")
    else:
        moe_note = (f"; MoE choices dropped past capacity: "
                    f"{drops_c.dropped} of {drops_c.chosen} on both"
                    if drops_c.chosen else "")
    if f64_control:
        err = float((logits_g - logits_c).abs().max())
    else:
        err = _max_err(logits_g, logits_c, CPU_RTOL, CPU_ATOL,
                       "card vs CPU logits")
    checked, total = _margin_tokens_agree(
        toks_g, logits_c, CPU_ATOL + CPU_RTOL * float(
            logits_c.abs().max()) + margin_extra, "card vs CPU tokens")
    extra_note = "".join(f", {k} {tuple(v.shape)}" for k, v in
                         extras.items())
    print(f"card vs CPU: {name} cut to {cfg.num_layers} layers, d "
          f"{cfg.d_model}, fp32, B={B} prompt {P} + {steps} decode "
          f"steps{extra_note}: logits match (worst |err| {err:.3e}; rtol "
          f"{CPU_RTOL} atol {CPU_ATOL}"
          f"{', against the control below' if f64_control else ''}); "
          f"greedy tokens identical at "
          f"{checked} of {total} positions whose margin allows{moe_note}"
          f"{ctrl_note}")
    return {"sel_flips": sel_flips, "cap_flips": cap_flips} if routed \
        else None


# ---------------------------------------------------------------------------
# 7. wkv6 against its plain version
# ---------------------------------------------------------------------------


def _wkv_inputs(B, T, H, N, dtype, gen, w_const=None, state=True,
                scale=1.0, mixed=False):
    """r, k, v normal times ``scale`` and w uniform in [0.2, 0.999) (or
    ``w_const``; or, ``mixed``, per key channel 1e-12, exactly 1 or
    uniform in turn) in ``dtype``; u (H, N) and the incoming state (B, H,
    N, N) normal fp32 (or no state)."""
    shape = (B, T, H, N)
    r, k, v = ((scale * torch.randn(shape, generator=gen, device="cuda"))
               .to(dtype) for _ in range(3))
    if w_const is None:
        w = 0.2 + 0.799 * torch.rand(shape, generator=gen, device="cuda")
    else:
        w = torch.full(shape, w_const, device="cuda")
    if mixed:
        w[..., 0::3] = 1e-12
        w[..., 1::3] = 1.0
    u = torch.randn((H, N), generator=gen, device="cuda")
    s0 = (torch.randn((B, H, N, N), generator=gen, device="cuda") if state
          else None)
    return r, k, v, w.to(dtype), u, s0


def _check_wkv(B, T, H, N, chunk, dtype, gen, **kw):
    """Kernel vs plain version on one input; returns the worst abs error
    over y and the state."""
    x = _wkv_inputs(B, T, H, N, dtype, gen, **kw)
    y, s = ops.wkv6(*x, chunk=chunk)
    y_want, s_want = ops.plain_wkv6(*x, chunk=chunk)
    torch.cuda.synchronize()
    tag = f"wkv6 (B,T,H,N)=({B},{T},{H},{N}) chunk {chunk} {dtype} {kw}"
    for g, w in ((y, y_want), (s, s_want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{tag}: output {tuple(g.shape)} {g.dtype} "
                                 f"vs {tuple(w.shape)} {w.dtype}")
    rtol, atol = WKV_TOL[dtype]
    return max(_max_err(y.float(), y_want.float(), rtol, atol, f"{tag} y"),
               _max_err(s, s_want, rtol, atol, f"{tag} state"))


def wkv_bound(B, T, H, N, dtype, state_in=True):
    """Least time for the work, in ms: r, k, v, w read and y written once
    in the inputs' dtype, u and the state (in, when given, and out) in
    fp32, against the recurrence's 4*B*T*H*N^2 operations (the count of
    ``src/repro/launch/roofline.py``) at the peak of the inputs' type."""
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = (5 * B * T * H * N * esize + H * N * 4
              + (2 if state_in else 1) * B * H * N * N * 4)
    flops = 4 * B * T * H * N * N
    peak = (roofline.PEAK_FLOPS if dtype == torch.bfloat16
            else roofline.PEAK_FP32_FLOPS)
    t_bytes, t_ops = nbytes / roofline.HBM_BW, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_wkv6(smi):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst, cases = 0.0, 0
    f32, bf16 = torch.float32, torch.bfloat16
    for dtype in (f32, bf16):
        for B, T, H, N, chunk, kw in (
                # the reference's sweep (tests/test_kernels.py)
                (1, 64, 2, 16, 16, {}), (2, 128, 3, 32, 32, {}),
                (1, 96, 1, 64, 32, {}),
                (2, 64, 4, 32, 64, {}),            # the smoke preset's N
                (1, 96, 2, 64, 48, {}),            # chunks below 64
                (2, 128, 4, 64, 16, {}),
                (1, 8, 2, 16, 1, {}),
                (1, 77, 2, 32, 7, dict(mixed=True)),   # T not of 8 rows
                (1, 128, 2, 16, 32, dict(w_const=1e-4)),   # strong decay
                (2, 64, 2, 32, 64, dict(state=False)),
                (2, 128, 4, 64, 64, dict(w_const=1e-12)),  # the log's clip
                (2, 128, 4, 64, 32, dict(w_const=1.0)),    # no decay
                (2, 128, 4, 64, 64, dict(mixed=True)),  # both, per channel
                (*WKV_SERVE, 64, dict(mixed=True)),
                (*WKV_SERVE, 64, {})):             # rwkv6-7b's prefill
            worst = max(worst, _check_wkv(B, T, H, N, chunk, dtype, gen,
                                          **kw))
            cases += 1
    # |r|, |k|, |v| ~ 100: large terms that cancel, where the bf16
    # tolerance is relative (fp32's rtol 1e-4 is below the reference's own
    # distance from exact arithmetic there, so fp32 is not held at x100)
    for B, T, H, N, chunk in ((1, 64, 2, 32, 32), (1, 64, 1, 64, 64)):
        for mixed in (False, True):
            worst = max(worst, _check_wkv(B, T, H, N, chunk, bf16, gen,
                                          scale=100.0, mixed=mixed))
            cases += 1
    print(f"wkv6: kernel == plain version on {cases} cases (fp32 and bf16; "
          f"N 16/32/64, chunks 1, 7, 16, 32, 48, 64, strong decay, w = "
          f"1e-12, w = 1, both per key channel, no state, |r|, |k|, |v| ~ "
          f"100 in bf16, the rwkv6-7b serving shape); worst |err| "
          f"{worst:.3e} (fp32 rtol {WKV_TOL[f32][0]} atol {WKV_TOL[f32][1]}, "
          f"bf16 rtol {WKV_TOL[bf16][0]} atol {WKV_TOL[bf16][1]})")

    # no atomics: the same bits on every call
    for dtype in (f32, bf16):
        x = _wkv_inputs(4, 256, 8, 64, dtype, gen, mixed=True)
        outs = [ops.wkv6(*x, chunk=64) for _ in range(3)]
        if not all(torch.equal(outs[0][0], y) and torch.equal(outs[0][1], s)
                   for y, s in outs[1:]):
            raise AssertionError(f"wkv6 ({dtype}) gave other bits on a "
                                 f"repeated call")
    print("wkv6: three calls on the same inputs give identical bits (fp32 "
          "and bf16)")

    # the tensor cores, by the built code: every bf16 instance holds
    # HMMA/HGMMA instructions
    mma = {fn: c for fn, c in sass_mma_counts("wkv6").items()
           if "wkv6_" in fn}
    short = {}
    for fn, c in sorted(mma.items()):
        kind = "mma" if "wkv6_mma_kernel" in fn else "fp32"
        short.setdefault(kind, []).append(c)
        if kind == "mma" and c == 0:
            raise AssertionError(f"{fn}: no HMMA/HGMMA instruction")
    if len(short.get("mma", [])) != len(wkv_kernel.HEAD_DIMS):
        raise AssertionError(f"the built library lacks a bf16 tensor-core "
                             f"instance (wkv6_mma_kernel): {sorted(mma)}")
    print("wkv6 SASS (cuobjdump -sass), HMMA/HGMMA instructions per kernel "
          "instance: " + "; ".join(f"{kind} {sorted(cs)}"
                                   for kind, cs in sorted(short.items())))

    B, T, H, N = WKV_SERVE
    x = _wkv_inputs(B, T, H, N, bf16, gen)
    xf = _wkv_inputs(B, T, H, N, f32, gen)
    fns = {"ms": lambda: ops.wkv6(*x, chunk=64),
           "plain_ms": lambda: ops.plain_wkv6(*x, chunk=64)}
    t = {key: graph_ms(f, calls=10, replays=10) for key, f in fns.items()}
    t.update({key.replace("ms", "eager_ms"): time_ms(f, iters=20, warmup=3)
              for key, f in fns.items()})
    t["fp32_ms"] = graph_ms(lambda: ops.wkv6(*xf, chunk=64), calls=10,
                            replays=10)
    t["bound_ms"], t["bound_by"] = wkv_bound(B, T, H, N, bf16)
    t["fp32_bound_ms"], _ = wkv_bound(B, T, H, N, f32)
    t["library_ms"] = None            # no single PyTorch call computes WKV6
    t["sass_mma"] = {kind: sorted(cs) for kind, cs in short.items()}
    print(f"wkv6 prefill (B,T,H,N)=({B},{T},{H},{N}) bf16, chunk 64: device "
          f"time per call (CUDA graph) kernel {t['ms']:.6f} ms, plain "
          f"{t['plain_ms']:.6f} ms; eager per call kernel "
          f"{t['eager_ms']:.6f} ms, plain {t['plain_eager_ms']:.6f} ms; "
          f"bound {t['bound_ms']:.6f} ms ({t['bound_by']}); no library "
          f"call computes WKV6; the fp32 instance (off the serving path) "
          f"{t['fp32_ms']:.6f} ms, bound {t['fp32_bound_ms']:.6f} ms [{smi}]")
    return worst, t


# ---------------------------------------------------------------------------
# 8. the RWKV6 serving path at rwkv6-7b full width
# ---------------------------------------------------------------------------


def phase_rwkv(smi):
    cfg = get_arch(RWKV_ARCH).model
    L = cfg.num_layers
    max_seq = LM_PROMPT + LM_GEN
    model = model_zoo.build_model(cfg, max_seq=max_seq)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED),
                        device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for t in cmte.tree_leaves(params))
    eng = ServeEngine(model, params, max_seq=max_seq, batch=LM_BATCH,
                      device="cuda")
    prompt = np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT)).astype(np.int32)
    r0 = _reserved_gib()
    # warm-up, not counted: captures the prefill and the decode graph
    eng.generate({"tokens": prompt}, max_new_tokens=2)
    reserved = (r0, _reserved_gib())
    torch.cuda.reset_peak_memory_stats()

    wkv_kernel.launches = 0                      # main path starts here
    res = eng.generate({"tokens": prompt}, max_new_tokens=LM_GEN)
    launches = wkv_kernel.launches
    peak = torch.cuda.max_memory_allocated()
    if launches != L:
        raise AssertionError(f"wkv6 launches {launches} != {L} layers x 1 "
                             f"prefill (and none in {LM_GEN - 1} decode "
                             f"steps)")
    toks = res.tokens
    if toks.shape != (LM_BATCH, max_seq) or \
            not np.array_equal(toks[:, :LM_PROMPT], prompt) or \
            toks.min() < 0 or toks.max() >= cfg.padded_vocab:
        raise AssertionError(f"generated tokens misshapen or out of range: "
                             f"{toks.shape}")
    print(f"RWKV6 serving {RWKV_ARCH} full width ({L} layers, d "
          f"{cfg.d_model}, {cfg.rwkv_num_heads} wkv heads of "
          f"{cfg.rwkv_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{n_params} params fp32, {cfg.dtype} activations), init "
          f"{t_init:.2f} s: B={LM_BATCH} prompt {LM_PROMPT} + {LM_GEN} new "
          f"tokens: prefill {res.prefill_seconds:.4f} s, decode "
          f"{res.decode_seconds:.4f} s = {res.decode_tokens_per_s:.1f} "
          f"tokens/s, peak memory {peak / 2**30:.3f} GiB; wkv6 launches "
          f"{launches} == {L} layers x 1 prefill, counted by replay [{smi}]")
    _captured_against_eager(f"RWKV6 serving {RWKV_ARCH}", eng,
                            {"tokens": prompt}, res, reserved, smi)

    # the kernel launches in the prefill of every layer and never in decode
    prompt_t = torch.from_numpy(prompt).to("cuda")
    gen_t = torch.from_numpy(toks[:, LM_PROMPT:].astype(np.int32)).to("cuda")
    cache = model.init_cache(LM_BATCH, max_seq, device="cuda")
    before = wkv_kernel.launches
    _, cache = model.prefill(eng.params, prompt_t, cache)
    n_prefill = wkv_kernel.launches - before
    model.decode_step(eng.params, gen_t[:, :1], cache, LM_PROMPT)
    n_decode = wkv_kernel.launches - before - n_prefill
    if n_prefill != L or n_decode != 0:
        raise AssertionError(f"wkv6 launched {n_prefill} times in a prefill "
                             f"and {n_decode} in a decode step")
    del cache

    # teacher-forced runs over the generated tokens, on the card
    lk = teacher_forced(model, eng.params, prompt_t, gen_t, max_seq)
    if not torch.isfinite(lk).all():
        raise AssertionError("kernel path: non-finite logits")
    scale = float(lk.abs().max())
    checked, total = _margin_tokens_agree(gen_t, lk, 1e-3 * scale,
                                          "generate vs its own replay")

    # every wkv6 call of the plain path (one prefill x 32 layers), on the
    # model's own activations, also through the kernel
    plain = model_zoo.build_model(cfg, impl="plain")
    calls, worst_y, worst_s = 0, 0.0, 0.0
    plain_wkv6 = ops.plain_wkv6

    def shadowed(r, k, v, w, u, state=None, *, chunk=64, state_out=None):
        nonlocal calls, worst_y, worst_s
        # the kernel first: the plain version overwrites the aliased state
        y_k, s_k = wkv_kernel.wkv6(r, k, v, w, u, state, chunk=chunk,
                                   device=r.device)
        y, s = plain_wkv6(r, k, v, w, u, state, chunk=chunk,
                          state_out=state_out)
        rtol, atol = WKV_TOL[r.dtype]
        worst_y = max(worst_y, _max_err(y_k.float(), y.float(), rtol, atol,
                                        f"wkv6 call {calls} y"))
        worst_s = max(worst_s, _max_err(s_k, s, rtol, atol,
                                        f"wkv6 call {calls} state"))
        calls += 1
        return y, s

    ops.plain_wkv6 = shadowed
    try:
        lp = teacher_forced(plain, eng.params, prompt_t, gen_t, max_seq)
    finally:
        ops.plain_wkv6 = plain_wkv6
    if calls != L:
        raise AssertionError(f"{calls} wkv6 calls shadowed, not {L}")

    # A control for the end-to-end logits: the plain path again with the
    # sequential-scan oracle in place of the chunked form (the same
    # function, other roundings); its drift is printed beside the kernel's.
    def scan_wkv6(r, k, v, w, u, state=None, *, chunk=64, state_out=None):
        y, s = ref.wkv6_ref(r, k, v, w, u, state)
        if state_out is not None:
            state_out.copy_(s)
            s = state_out
        return y, s

    ops.plain_wkv6 = scan_wkv6
    try:
        ls = teacher_forced(plain, eng.params, prompt_t, gen_t, max_seq)
    finally:
        ops.plain_wkv6 = plain_wkv6
    p_scale = float(lp.abs().max())
    drift = float((lk - lp).abs().max()) / p_scale
    drift_scan = float((ls - lp).abs().max()) / p_scale
    rtol, atol = WKV_TOL[torch.bfloat16]
    print(f"RWKV6 serving: the kernel == plain version on all {calls} wkv6 "
          f"calls of a teacher-forced plain run over the generated tokens "
          f"(the model's own bf16 activations; worst |err| y {worst_y:.4e}, "
          f"state {worst_s:.4e} at rtol {rtol} atol {atol}); generate's "
          f"tokens == the argmax of its own teacher-forced replay at "
          f"{checked} of {total} positions whose top-2 margin exceeds 1e-3 x "
          f"max|logit|; end-to-end logit drift of the kernel path from the "
          f"plain path over {L} layers (not gated; max |err| / max|logit| "
          f"{p_scale:.4e}): kernel path {drift:.4e}, sequential-scan control "
          f"{drift_scan:.4e}")
    del lk, lp, ls, eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# 10. ssd against its plain version
# ---------------------------------------------------------------------------


def _ssd_inputs(B, T, H, P, N, dtype, gen, a_lo=0.3, a_hi=1.0, state=True,
                broadcast=False, scale=1.0):
    """x, B, C normal times ``scale`` and a uniform in [a_lo, a_hi) (a_lo =
    a_hi = 1: no decay), in ``dtype``; the incoming state (B, H, N, P)
    normal fp32 (or none).  ``broadcast``: B and C one (B, T, N)
    projection expanded across the heads (stride 0), as Jamba's mixer
    makes them."""
    x = (scale * torch.randn((B, T, H, P), generator=gen,
                             device="cuda")).to(dtype)
    a = a_lo + (a_hi - a_lo) * torch.rand((B, T, H), generator=gen,
                                          device="cuda")
    hb = 1 if broadcast else H
    Bm, Cm = ((scale * torch.randn((B, T, hb, N), generator=gen,
                                   device="cuda")).to(dtype)
              for _ in range(2))
    if broadcast:
        Bm, Cm = Bm.expand(B, T, H, N), Cm.expand(B, T, H, N)
    s0 = (torch.randn((B, H, N, P), generator=gen, device="cuda") if state
          else None)
    return x, a.to(dtype), Bm, Cm, s0


def ssd_exact(x, a, Bm, Cm, s0):
    """The recurrence S_t = a_t S_{t-1} + B_t^T x_t, y_t = C_t S_t in
    float64 on the same inputs: (y, S)."""
    B, T, H, P = x.shape
    S = (torch.zeros((B, H, Bm.shape[-1], P), dtype=torch.float64,
                     device=x.device) if s0 is None else s0.double())
    ys = []
    for t in range(T):
        S = a[:, t, :, None, None].double() * S + \
            Bm[:, t, :, :, None].double() * x[:, t, :, None, :].double()
        ys.append(torch.einsum("bhn,bhnp->bhp", Cm[:, t].double(), S))
    return torch.stack(ys, 1), S


def _check_ssd(B, T, H, P, N, chunk, dtype, gen, exact=False, **kw):
    """Kernel vs plain version on one input; returns the worst abs error
    over y and the state.  ``exact`` (the x100 cases): an entry where the
    kernel misses the plain version may instead lie within the same
    tolerance of the recurrence evaluated in float64 (there the fp32 plain
    version is itself further off: terms of ~1e6 that cancel to ~1e2 move
    by more than the bf16 tolerance with one ulp of one fp32 log)."""
    x = _ssd_inputs(B, T, H, P, N, dtype, gen, **kw)
    y, s = ops.ssd(*x, chunk=chunk)
    y_want, s_want = ops.plain_ssd(*x, chunk=chunk)
    torch.cuda.synchronize()
    tag = f"ssd (B,T,H,P,N)=({B},{T},{H},{P},{N}) chunk {chunk} {dtype} {kw}"
    for g, w in ((y, y_want), (s, s_want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{tag}: output {tuple(g.shape)} {g.dtype} "
                                 f"vs {tuple(w.shape)} {w.dtype}")
    rtol, atol = SSD_TOL[dtype]
    if not exact:
        return max(_max_err(y.float(), y_want.float(), rtol, atol,
                            f"{tag} y"),
                   _max_err(s, s_want, rtol, atol, f"{tag} state"))
    worst = 0.0
    for name, g, w, e in zip(("y", "state"), (y, s), (y_want, s_want),
                             ssd_exact(*x)):
        g, w = g.double(), w.double()
        off = ((g - w).abs() > atol + rtol * w.abs()) & \
            ((g - e).abs() > atol + rtol * e.abs())
        if bool(off.any()) or not bool(torch.isfinite(g).all()):
            raise AssertionError(
                f"{tag} {name}: {int(off.sum())} entries outside rtol={rtol} "
                f"atol={atol} of both the plain version and the float64 "
                f"recurrence")
        worst = max(worst, float((g - w).abs().max()))
    return worst


def _stored_bytes(t):
    """Bytes of the distinct elements of ``t`` (a broadcast dimension,
    stride 0, counts once): what a kernel reading it through its strides
    must move."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


def ssd_bound(x, a, Bm, Cm, state):
    """Least time for the work, in ms: x, a, B, C read (B and C as the
    kernel receives them) and y written once in their dtype, the state in
    (when given) and out in fp32, against the recurrence's 4*B*T*H*N*P
    operations (the count of ``src/repro/launch/roofline.py``) at the peak
    of the inputs' type."""
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    nbytes = (2 * _stored_bytes(x) + _stored_bytes(a) + _stored_bytes(Bm)
              + _stored_bytes(Cm) + (2 if state is not None else 1)
              * B * H * N * P * 4)
    flops = 4 * B * T * H * N * P
    peak = (roofline.PEAK_FLOPS if x.dtype == torch.bfloat16
            else roofline.PEAK_FP32_FLOPS)
    t_bytes, t_ops = nbytes / roofline.HBM_BW, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_ssd(smi):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst, cases = 0.0, 0
    f32, bf16 = torch.float32, torch.bfloat16
    for dtype in (f32, bf16):
        for B, T, H, P, N, chunk, kw in (
                # the reference's sweep (tests/test_kernels.py)
                (1, 64, 2, 16, 8, 16, {}), (2, 128, 4, 32, 16, 32, {}),
                (1, 128, 2, 128, 16, 64, {}),      # Jamba's head shape
                (2, 64, 8, 32, 8, 64, dict(broadcast=True)),  # smoke preset
                (1, 96, 2, 128, 16, 48, {}),       # chunks below 64
                (2, 128, 4, 16, 16, 16, {}),
                (1, 8, 2, 16, 8, 1, {}),
                (1, 128, 2, 32, 16, 32, dict(a_lo=1e-4, a_hi=2e-4)),
                (1, 128, 2, 32, 16, 64, dict(a_lo=0.999, a_hi=1.0)),
                (2, 64, 2, 128, 8, 64, dict(state=False)),
                (1, 128, 2, 32, 16, 32, dict(a_lo=1.0, a_hi=1.0)),  # a = 1
                (2, 128, 4, 128, 16, 64, dict(a_lo=1.0, a_hi=1.0,
                                              broadcast=True)),
                (*SSD_SERVE, 64, dict(broadcast=True))):  # Jamba's prefill
            worst = max(worst, _check_ssd(B, T, H, P, N, chunk, dtype, gen,
                                          **kw))
            cases += 1
    # |x|, |B|, |C| ~ 100: large terms that cancel, where the bf16
    # tolerance is relative; held to the plain version or, where that is
    # further off, to the float64 recurrence (fp32's rtol 1e-4 is below the
    # fp32 plain version's own distance from exact arithmetic there, so
    # fp32 is not held at x100)
    for B, T, H, P, N, chunk, kw in (
            (1, 128, 2, 32, 16, 32, {}), (1, 128, 2, 128, 8, 64, {}),
            (2, 128, 4, 128, 16, 64, dict(broadcast=True)),
            (1, 128, 2, 128, 16, 16, dict(a_lo=1.0, a_hi=1.0)),
            (1, 96, 2, 16, 16, 48, dict(state=False))):
        worst = max(worst, _check_ssd(B, T, H, P, N, chunk, bf16, gen,
                                      scale=100.0, exact=True, **kw))
        cases += 1
    print(f"ssd: kernel == plain version on {cases} cases (fp32 and bf16; "
          f"P 16/32/128, N 8/16, chunks 1, 16, 32, 48, 64, strong decay, "
          f"decay near 1, a = 1, no state, B and C broadcast, |x|, |B|, |C| "
          f"~ 100 in bf16, the jamba serving shape); worst |err| "
          f"{worst:.3e} (fp32 rtol {SSD_TOL[f32][0]} atol "
          f"{SSD_TOL[f32][1]}, bf16 rtol {SSD_TOL[bf16][0]} atol "
          f"{SSD_TOL[bf16][1]})")

    # no atomics: the same bits on every call
    for dtype in (f32, bf16):
        x = _ssd_inputs(4, 256, 8, 128, 16, dtype, gen, broadcast=True)
        outs = [ops.ssd(*x, chunk=64) for _ in range(3)]
        if not all(torch.equal(outs[0][0], y) and torch.equal(outs[0][1], s)
                   for y, s in outs[1:]):
            raise AssertionError(f"ssd ({dtype}) gave other bits on a "
                                 f"repeated call")
    print("ssd: three calls on the same inputs give identical bits (fp32 "
          "and bf16)")

    # the tensor cores, by the built code: every bf16 instance holds
    # HMMA/HGMMA instructions
    mma = {fn: c for fn, c in sass_mma_counts("ssd").items() if "ssd_" in fn}
    short = {}
    for fn, c in sorted(mma.items()):
        kind = "mma" if "ssd_mma_kernel" in fn else "fp32"
        short.setdefault(kind, []).append(c)
        if kind == "mma" and c == 0:
            raise AssertionError(f"{fn}: no HMMA/HGMMA instruction")
    if len(short.get("mma", [])) != len(ssd_kernel.HEAD_DIMS):
        raise AssertionError(f"the built library lacks a bf16 tensor-core "
                             f"instance (ssd_mma_kernel): {sorted(mma)}")
    print("ssd SASS (cuobjdump -sass), HMMA/HGMMA instructions per kernel "
          "instance: " + "; ".join(f"{kind} {sorted(cs)}"
                                   for kind, cs in sorted(short.items())))

    B, T, H, P, N = SSD_SERVE
    x = _ssd_inputs(B, T, H, P, N, bf16, gen, broadcast=True)
    xf = _ssd_inputs(B, T, H, P, N, f32, gen, broadcast=True)
    fns = {"ms": lambda: ops.ssd(*x, chunk=64),
           "plain_ms": lambda: ops.plain_ssd(*x, chunk=64)}
    t = {key: graph_ms(f, calls=10, replays=10) for key, f in fns.items()}
    t.update({key.replace("ms", "eager_ms"): time_ms(f, iters=20, warmup=3)
              for key, f in fns.items()})
    t["fp32_ms"] = graph_ms(lambda: ops.ssd(*xf, chunk=64), calls=10,
                            replays=10)
    t["bound_ms"], t["bound_by"] = ssd_bound(*x)
    t["fp32_bound_ms"], _ = ssd_bound(*xf)
    t["library_ms"] = None             # no single PyTorch call computes SSD
    t["sass_mma"] = {kind: sorted(cs) for kind, cs in short.items()}
    print(f"ssd prefill (B,T,H,P,N)=({B},{T},{H},{P},{N}) bf16, B and C "
          f"broadcast, chunk 64: device time per call (CUDA graph) kernel "
          f"{t['ms']:.6f} ms, plain {t['plain_ms']:.6f} ms; eager per call "
          f"kernel {t['eager_ms']:.6f} ms, plain {t['plain_eager_ms']:.6f} "
          f"ms; bound {t['bound_ms']:.6f} ms ({t['bound_by']}); no library "
          f"call computes SSD; the fp32 instance (off the serving path) "
          f"{t['fp32_ms']:.6f} ms, bound {t['fp32_bound_ms']:.6f} ms [{smi}]")
    return worst, t


# ---------------------------------------------------------------------------
# 11. the Jamba serving path: the one-card cut of jamba-1.5-large
# ---------------------------------------------------------------------------


def phase_jamba(smi):
    cfg = get_arch(JAMBA_ARCH).model.replace(**ONE_CARD_CUT)
    groups = cfg.num_layers // 8
    n_ssd, n_attn = 7 * groups, groups
    max_seq = LM_PROMPT + LM_GEN
    model = model_zoo.build_model(cfg, max_seq=max_seq)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED),
                        device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for t in cmte.tree_leaves(params))
    eng = ServeEngine(model, params, max_seq=max_seq, batch=LM_BATCH,
                      device="cuda")
    prompt = np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT)).astype(np.int32)
    r0 = _reserved_gib()
    # warm-up, not counted: captures the prefill and the decode graph
    eng.generate({"tokens": prompt}, max_new_tokens=2)
    reserved = (r0, _reserved_gib())
    torch.cuda.reset_peak_memory_stats()

    ssd_kernel.launches = 0                      # main path starts here
    fa_kernel.launches = 0
    fa_kernel.launches_tiled = fa_kernel.launches_split = 0
    res = eng.generate({"tokens": prompt}, max_new_tokens=LM_GEN)
    launches, fa_launches = ssd_kernel.launches, fa_kernel.launches
    fa_paths = (fa_kernel.launches_tiled, fa_kernel.launches_split)
    peak = torch.cuda.max_memory_allocated()
    if launches != n_ssd or fa_launches != n_attn * LM_GEN:
        raise AssertionError(
            f"ssd launches {launches} != {n_ssd} Mamba layers x 1 prefill, "
            f"or flash_attention launches {fa_launches} != {n_attn} "
            f"attention layers x (1 prefill + {LM_GEN - 1} decode steps)")
    if fa_paths != (n_attn, n_attn * (LM_GEN - 1)):
        raise AssertionError(f"flash_attention (tiled, split) launches "
                             f"{fa_paths}: every prefill call must be tiled "
                             f"and every decode call split")
    toks = res.tokens
    if toks.shape != (LM_BATCH, max_seq) or \
            not np.array_equal(toks[:, :LM_PROMPT], prompt) or \
            toks.min() < 0 or toks.max() >= cfg.padded_vocab:
        raise AssertionError(f"generated tokens misshapen or out of range: "
                             f"{toks.shape}")
    print(f"Jamba serving {JAMBA_ARCH} one-card cut ({cfg.num_layers} "
          f"layers, {cfg.moe_num_experts} experts top-{cfg.moe_top_k}; d "
          f"{cfg.d_model}, d_ff {cfg.d_ff}, {cfg.num_heads} heads over "
          f"{cfg.num_kv_heads} kv, {cfg.mamba_num_heads} SSD heads of P "
          f"{cfg.mamba_head_dim}, N {cfg.mamba_d_state}, vocab "
          f"{cfg.vocab_size}; {n_params} params fp32, {cfg.dtype} "
          f"activations), init {t_init:.2f} s: B={LM_BATCH} prompt "
          f"{LM_PROMPT} + {LM_GEN} new tokens: prefill "
          f"{res.prefill_seconds:.4f} s, decode {res.decode_seconds:.4f} s = "
          f"{res.decode_seconds / (LM_GEN - 1) * 1e3:.4f} ms per step, "
          f"{res.decode_tokens_per_s:.1f} tokens/s, peak memory "
          f"{peak / 2**30:.3f} GiB; ssd launches {launches} == {n_ssd} "
          f"Mamba layers x 1 prefill, flash_attention launches "
          f"{fa_launches} == {n_attn} x (1 + {LM_GEN - 1}): {fa_paths[0]} "
          f"tiled (prefill), {fa_paths[1]} split (decode), counted by "
          f"replay [{smi}]")
    _captured_against_eager(f"Jamba serving {JAMBA_ARCH}", eng,
                            {"tokens": prompt}, res, reserved, smi)

    # a separate prefill launches each kernel once per layer; a decode
    # step launches flash_attention only
    prompt_t = torch.from_numpy(prompt).to("cuda")
    gen_t = torch.from_numpy(toks[:, LM_PROMPT:].astype(np.int32)).to("cuda")
    cache = model.init_cache(LM_BATCH, max_seq, device="cuda")
    counts = []
    for step in (lambda: model.prefill(eng.params, prompt_t, cache),
                 lambda: model.decode_step(eng.params, gen_t[:, :1], cache,
                                           LM_PROMPT)):
        before = (ssd_kernel.launches, fa_kernel.launches)
        step()
        counts.append((ssd_kernel.launches - before[0],
                       fa_kernel.launches - before[1]))
    if counts != [(n_ssd, n_attn), (0, n_attn)]:
        raise AssertionError(f"(ssd, flash_attention) launches in a prefill "
                             f"and a decode step: {counts}")
    del cache

    # teacher-forced runs over the generated tokens, on the card
    lk = teacher_forced(model, eng.params, prompt_t, gen_t, max_seq)
    if not torch.isfinite(lk).all():
        raise AssertionError("kernel path: non-finite logits")
    scale = float(lk.abs().max())
    checked, total = _margin_tokens_agree(gen_t, lk, 1e-3 * scale,
                                          "generate vs its own replay")

    # every ssd and attention call of the plain path (7 ssd calls in the
    # prefill; one attention call per prefill and decode step), on the
    # model's own activations, also through the kernels
    plain = model_zoo.build_model(cfg, impl="plain")
    n = {"ssd": 0, "fa": 0}
    worst = {"y": 0.0, "s": 0.0, "fa": 0.0}
    plain_ssd, plain_attention = ops.plain_ssd, ops.plain_attention

    def shadow_ssd(x, a, Bm, Cm, state=None, *, chunk=64, state_out=None):
        # the kernel first: the plain version overwrites the aliased state
        y_k, s_k = ssd_kernel.ssd(x, a, Bm, Cm, state, chunk=chunk,
                                  device=x.device)
        y, s = plain_ssd(x, a, Bm, Cm, state, chunk=chunk,
                         state_out=state_out)
        rtol, atol = SSD_TOL[x.dtype]
        worst["y"] = max(worst["y"], _max_err(y_k.float(), y.float(), rtol,
                                              atol, f"ssd call {n['ssd']} y"))
        worst["s"] = max(worst["s"], _max_err(s_k, s, rtol, atol,
                                              f"ssd call {n['ssd']} state"))
        n["ssd"] += 1
        return y, s

    def shadow_attention(q, k, v, **kw):
        out = plain_attention(q, k, v, **kw)
        kw.pop("q_chunk", None)
        got = fa_kernel.flash_attention(q, k, v, device=q.device, **kw)
        tol = FA_TOL[q.dtype]
        worst["fa"] = max(worst["fa"], _max_err(
            got.float(), out.float(), tol, tol, f"attention call {n['fa']}"))
        n["fa"] += 1
        return out

    ops.plain_ssd, ops.plain_attention = shadow_ssd, shadow_attention
    try:
        lp = teacher_forced(plain, eng.params, prompt_t, gen_t, max_seq)
    finally:
        ops.plain_ssd, ops.plain_attention = plain_ssd, plain_attention
    if (n["ssd"], n["fa"]) != (n_ssd, n_attn * LM_GEN):
        raise AssertionError(f"{n} calls shadowed, not ssd {n_ssd} and "
                             f"attention {n_attn * LM_GEN}")
    p_scale = float(lp.abs().max())
    drift = float((lk - lp).abs().max()) / p_scale
    rtol, atol = SSD_TOL[torch.bfloat16]
    print(f"Jamba serving: the kernels == their plain versions on every "
          f"call of a teacher-forced plain run over the generated tokens "
          f"(the model's own bf16 activations): ssd on all {n['ssd']} "
          f"prefill calls (worst |err| y {worst['y']:.4e}, state "
          f"{worst['s']:.4e} at rtol {rtol} atol {atol}), flash_attention "
          f"(hd {cfg.resolved_head_dim}, {cfg.num_heads // cfg.num_kv_heads}"
          f" q heads per kv head) on all {n['fa']} calls (worst |err| "
          f"{worst['fa']:.4e} at rtol = atol = {FA_TOL[torch.bfloat16]}); "
          f"generate's tokens == the argmax of its own teacher-forced replay "
          f"at {checked} of {total} positions whose top-2 margin exceeds "
          f"1e-3 x max|logit|; end-to-end logit drift of the kernel path "
          f"from the plain path (not gated; max |err| / max|logit| "
          f"{p_scale:.4e}): {drift:.4e}")
    del lk, lp, eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches, fa_launches, fa_paths


# ---------------------------------------------------------------------------
# 13-15. the rest of the LM zoo through ServeEngine.generate
# ---------------------------------------------------------------------------

MOE_ARCH = "qwen2-moe-a2.7b"
# whisper-small: 64 prompt tokens, the published 448-token text context
WHISPER_ARCH, WHISPER_PROMPT, WHISPER_MAX_SEQ = "whisper-small", 64, 448
# internvl2-2b: 256 patch embeddings + 512 prompt tokens + 64 new ones
INTERNVL_ARCH = "internvl2-2b"
# the four archs served last: danube's prompt passes its 4096-token window
DANUBE_ARCH, DANUBE_PROMPT = "h2o-danube-3-4b", 4608
MINICPM_ARCH, NEMO_ARCH = "minicpm-2b", "mistral-nemo-12b"
QWEN3_ARCH = "qwen3-moe-235b-a22b"


def serve_family(label, cfg, prompt_len, max_seq, want_paths, smi):
    """``ServeEngine.generate`` on ``cfg`` (random weights from the seed;
    the prefill's frame or patch embeddings from ``prefill_extras``), 8
    prompts of ``prompt_len`` tokens, 64 new ones, greedy: the flash
    launches of the generate must be exactly ``want_paths`` (tiled,
    split), and every attention call of a teacher-forced plain run over
    the generated tokens must match the kernel on the model's own
    activations.  Returns the phase's numbers."""
    n_prefix = cfg.vision_tokens if cfg.family == "vlm" else 0
    model = model_zoo.build_model(cfg, max_seq=max_seq)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED),
                        device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for t in cmte.tree_leaves(params))
    eng = ServeEngine(model, params, max_seq=max_seq, batch=LM_BATCH,
                      device="cuda")
    prompt = np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (LM_BATCH, prompt_len)).astype(np.int32)
    extras = prefill_extras(cfg, LM_BATCH, SEED)
    batch = dict(tokens=prompt, **extras)
    r0 = _reserved_gib()
    # warm-up, not counted: captures the prefill and the decode graph
    eng.generate(batch, max_new_tokens=2)
    reserved = (r0, _reserved_gib())
    torch.cuda.reset_peak_memory_stats()

    fa_kernel.launches = 0                       # main path starts here
    fa_kernel.launches_tiled = fa_kernel.launches_split = 0
    res = eng.generate(batch, max_new_tokens=LM_GEN)
    launches = fa_kernel.launches
    paths = (fa_kernel.launches_tiled, fa_kernel.launches_split)
    peak = torch.cuda.max_memory_allocated()
    if paths != tuple(want_paths) or launches != sum(want_paths):
        raise AssertionError(f"{label}: flash_attention (tiled, split) "
                             f"launches {paths} (total {launches}), "
                             f"expected {tuple(want_paths)}")
    toks = res.tokens
    if toks.shape != (LM_BATCH, prompt_len + LM_GEN) or \
            not np.array_equal(toks[:, :prompt_len], prompt) or \
            toks.min() < 0 or toks.max() >= cfg.padded_vocab:
        raise AssertionError(f"{label}: generated tokens misshapen or out "
                             f"of range: {toks.shape}")
    step_ms = res.decode_seconds / (LM_GEN - 1) * 1e3
    extra_note = "".join(f", {k} {v.shape}" for k, v in extras.items())
    print(f"{label} ({cfg.num_layers} layers, d {cfg.d_model}, "
          f"{cfg.num_heads} heads over {cfg.num_kv_heads} kv of "
          f"{cfg.resolved_head_dim}, vocab {cfg.vocab_size}; {n_params} "
          f"params fp32, {cfg.dtype} activations), init {t_init:.2f} s: "
          f"B={LM_BATCH} prompt {prompt_len}{extra_note} + {LM_GEN} new "
          f"tokens, max_seq {max_seq}: prefill {res.prefill_seconds:.4f} s, "
          f"decode {res.decode_seconds:.4f} s = {step_ms:.4f} ms per step, "
          f"{res.decode_tokens_per_s:.1f} tokens/s, peak memory "
          f"{peak / 2**30:.3f} GiB; flash_attention launches {launches}: "
          f"{paths[0]} tiled, {paths[1]} split, counted by replay [{smi}]")
    out = {"launches": launches, "paths": paths,
           "prefill_s": res.prefill_seconds, "step_ms": step_ms,
           "tokens_per_s": res.decode_tokens_per_s,
           "peak_gib": peak / 2**30,
           "captured": _captured_against_eager(label, eng, batch, res,
                                               reserved, smi)}

    # teacher-forced runs over the generated tokens, on the card
    prompt_t = torch.from_numpy(prompt).to("cuda")
    gen_t = torch.from_numpy(toks[:, prompt_len:].astype(np.int32)).to(
        "cuda")
    ex_t = {k: torch.from_numpy(v).to("cuda") for k, v in extras.items()}
    lk = teacher_forced(model, eng.params, prompt_t, gen_t, max_seq,
                        n_prefix, **ex_t)
    if not torch.isfinite(lk).all():
        raise AssertionError(f"{label}: kernel path: non-finite logits")
    scale = float(lk.abs().max())
    checked, total = _margin_tokens_agree(gen_t, lk, 1e-3 * scale,
                                          f"{label}: generate vs its own "
                                          f"replay")

    # every attention call of the plain path, on the model's own
    # activations, also through the kernel, held against the kernel's plain
    # version ``ref.attention_ref`` (the model's plain path takes the
    # reference's query-chunked form past 1024 queries, the Whisper
    # encoder's 1500 and danube's 4608, which rounds P to the activation
    # dtype before P.V; there the gate takes ``ref.attention_ref`` by query
    # rows, ``attention_ref_rows``)
    plain = model_zoo.build_model(cfg, impl="plain", max_seq=max_seq)
    calls, chunked, worst, cut = 0, 0, 0.0, 0
    plain_attention = ops.plain_attention

    def shadowed(q, k, v, **kw):
        nonlocal calls, chunked, worst, cut
        out = plain_attention(q, k, v, **kw)
        kw.pop("q_chunk", None)
        window = kw.get("window")       # keys cut: the last query sees
        if window is not None and \
                int(kw.get("q_offset", 0)) + q.shape[1] > window:
            cut += 1                     # fewer than all before it
        got = fa_kernel.flash_attention(q, k, v, device=q.device, **kw)
        want = out
        if q.shape[1] > 1024 and kw.get("kv_len") is None:
            want = attention_ref_rows(q, k, v, **kw)
            chunked += 1
        tol = FA_TOL[q.dtype]
        try:
            err = _max_err(got.float(), want.float(), tol, tol,
                           f"{label}: attention call {calls}")
        except AssertionError as e:      # say how far each is from exact
            f64 = attention_ref_rows(q, k, v, fn=_attention_f64,
                                     **kw).double()
            raise AssertionError(
                f"{e}; max |kernel - float64| "
                f"{float((got.double() - f64).abs().max()):.3e}, max |plain "
                f"- float64| {float((want.double() - f64).abs().max()):.3e}"
            ) from e
        worst = max(worst, err)
        calls += 1
        return out

    ops.plain_attention = shadowed
    try:
        lp = teacher_forced(plain, eng.params, prompt_t, gen_t, max_seq,
                            n_prefix, **ex_t)
    finally:
        ops.plain_attention = plain_attention
    if calls != launches:
        raise AssertionError(f"{label}: {calls} attention calls shadowed, "
                             f"not {launches}")
    p_scale = float(lp.abs().max())
    drift = float((lk - lp).abs().max()) / p_scale
    out["window_cut_calls"] = cut
    cut_note = (f", {cut} of them with the window of {cfg.sliding_window} "
                f"cutting keys" if cfg.sliding_window else "")
    print(f"{label}: the kernel == plain attention (ref.attention_ref, by "
          f"query rows of {GATE_ROWS} on the {chunked} calls the plain path "
          f"chunked) on all {calls} attention calls{cut_note} of a "
          f"teacher-forced plain run over the generated "
          f"tokens (the model's own bf16 activations; worst |err| "
          f"{worst:.4e} at rtol = atol = {FA_TOL[torch.bfloat16]}); "
          f"generate's tokens == "
          f"the argmax of its own teacher-forced replay at {checked} of "
          f"{total} positions whose top-2 margin exceeds 1e-3 x "
          f"max|logit|; end-to-end logit drift of the kernel path from the "
          f"plain path (not gated; max |err| / max|logit| {p_scale:.4e}): "
          f"{drift:.4e}")
    if cfg.family == "encdec":                   # the encoder alone
        enc = ex_t["enc_embeds"]
        model.encode(eng.params, enc)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            model.encode(eng.params, enc)
        end.record()
        end.synchronize()
        out["encoder_ms"] = start.elapsed_time(end) / 5
        print(f"{label}: encoder ({cfg.encoder_layers} layers over "
              f"{tuple(enc.shape)} frames) {out['encoder_ms']:.4f} ms per "
              f"call (CUDA events, mean of 5) [{smi}]")
    del lk, lp, eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_moe(smi):
    """qwen2-moe-a2.7b at its one-card cut: 16 tiled + 63 x 16 split."""
    from repro_torch.configs import qwen2_moe_a2p7b

    cfg = get_arch(MOE_ARCH).model.replace(**qwen2_moe_a2p7b.ONE_CARD_CUT)
    L = cfg.num_layers
    return serve_family(
        f"MoE serving {MOE_ARCH} one-card cut ({cfg.moe_num_experts} "
        f"experts top-{cfg.moe_top_k} + {cfg.moe_num_shared_experts} "
        f"shared)", cfg, LM_PROMPT, LM_PROMPT + LM_GEN,
        (L, (LM_GEN - 1) * L), smi)


def phase_whisper(smi):
    """whisper-small uncut: the encoder's 12 and the decoder prefill's 12
    self + 12 cross calls tiled, then 63 x 24 split."""
    cfg = get_arch(WHISPER_ARCH).model
    L, E = cfg.num_layers, cfg.encoder_layers
    return serve_family(f"Whisper serving {WHISPER_ARCH} uncut", cfg,
                        WHISPER_PROMPT, WHISPER_MAX_SEQ,
                        (E + 2 * L, (LM_GEN - 1) * 2 * L), smi)


def phase_internvl(smi):
    """internvl2-2b uncut: 256 patches + 512 prompt tokens in one tiled
    call per layer, then 63 x 24 split."""
    cfg = get_arch(INTERNVL_ARCH).model
    L = cfg.num_layers
    return serve_family(f"InternVL serving {INTERNVL_ARCH} uncut", cfg,
                        LM_PROMPT, cfg.vision_tokens + LM_PROMPT + LM_GEN,
                        (L, (LM_GEN - 1) * L), smi)


def phase_danube(smi):
    """h2o-danube-3-4b uncut on prompts of 4608 tokens, past its 4096-token
    window: 24 tiled (the window cutting keys from query 4096 on) + 63 x
    24 split (every step's window starting past key 0)."""
    cfg = get_arch(DANUBE_ARCH).model
    L = cfg.num_layers
    out = serve_family(
        f"Danube serving {DANUBE_ARCH} uncut (window "
        f"{cfg.sliding_window})", cfg, DANUBE_PROMPT, DANUBE_PROMPT + LM_GEN,
        (L, (LM_GEN - 1) * L), smi)
    if out["window_cut_calls"] != out["launches"]:
        raise AssertionError(f"danube: the window cut keys in "
                             f"{out['window_cut_calls']} of the "
                             f"{out['launches']} attention calls, not all")
    return out


def phase_minicpm(smi):
    """minicpm-2b uncut (36 MHA heads, tied embeddings, vocab 122753
    padded to 122880): 40 tiled + 63 x 40 split."""
    cfg = get_arch(MINICPM_ARCH).model
    L = cfg.num_layers
    return serve_family(f"MiniCPM serving {MINICPM_ARCH} uncut", cfg,
                        LM_PROMPT, LM_PROMPT + LM_GEN,
                        (L, (LM_GEN - 1) * L), smi)


def phase_nemo(smi):
    """mistral-nemo-12b uncut (32 heads of 128 over d_model 5120): 40
    tiled + 63 x 40 split."""
    cfg = get_arch(NEMO_ARCH).model
    L = cfg.num_layers
    return serve_family(f"Nemo serving {NEMO_ARCH} uncut", cfg, LM_PROMPT,
                        LM_PROMPT + LM_GEN, (L, (LM_GEN - 1) * L), smi)


def phase_qwen3_moe(smi):
    """qwen3-moe-235b-a22b at its one-card cut: 64 heads over 4 kv heads
    (G = 16) put every decode step on the tiled path, 4 + 63 x 4 tiled and
    none split."""
    from repro_torch.configs import qwen3_moe_235b_a22b

    cfg = get_arch(QWEN3_ARCH).model.replace(
        **qwen3_moe_235b_a22b.ONE_CARD_CUT)
    L = cfg.num_layers
    return serve_family(
        f"MoE serving {QWEN3_ARCH} one-card cut ({cfg.moe_num_experts} "
        f"experts top-{cfg.moe_top_k}, qk-norm)", cfg, LM_PROMPT,
        LM_PROMPT + LM_GEN, (L + (LM_GEN - 1) * L, 0), smi)


def serve_rest(smi=None):
    """Phase 15b: each of the four archs served last, then its fp32 2-layer
    cut at full width against the CPU; {key: serving numbers}.  Alone on
    the card (after building the kernels): ``PYTHONPATH=src python -c
    "import chip_smoke as c; c.serve_rest()"``."""
    if smi is None:
        smi = _timed("describe and build", phase_describe)["nvidia_smi"]
    rest = {}
    for key, arch, phase, sharp in (
            ("danube", DANUBE_ARCH, phase_danube, True),
            ("minicpm", MINICPM_ARCH, phase_minicpm, False),
            ("nemo", NEMO_ARCH, phase_nemo, True),
            ("qwen3_moe", QWEN3_ARCH, phase_qwen3_moe, False)):
        gc.collect()
        torch.cuda.empty_cache()
        rest[key] = _timed(f"{key} serving", phase, smi)
        _timed(f"{key} card vs CPU", phase_card_vs_cpu, arch,
               two_layers(arch), (fa_kernel,), sharp)
    return rest


# ---------------------------------------------------------------------------
# 16. PAL at LM scale: the lm_active_distill twin on the card
# ---------------------------------------------------------------------------

DISTILL_TIMEOUT = 60.0            # the reference's is 120 s; its stop: 120


class EagerTeacherOracle(distill_ex.TeacherOracle):
    """The distill teacher without capture: ``relabel`` op by op on
    the caller's stream, the labels read back with ``.cpu()``: the
    "before" of the captured teacher."""

    def _relabel_program(self, tokens):
        return self.relabel(tokens.to(self.device)).cpu()


def phase_distill(smi):
    """``repro_torch.examples.lm_active_distill`` as the reference
    configures it, stopped at 120 labelled sequences or after 60 s: each
    student-engine dispatch one replay of a captured bucket graph through
    ``committee_uq``, the teacher's attention through the flash kernel, the
    students retrained by the captured trainer and handed back device to
    device."""
    import tempfile

    from repro_torch.examples import lm_active_distill as distill

    with tempfile.TemporaryDirectory() as tmp:
        pal = distill.make_pal(tmp, "cuda")
        cuq_kernel.launches = 0                  # this path starts here
        fa_kernel.launches = 0
        fa_kernel.launches_tiled = fa_kernel.launches_split = 0
        with _ReplaySpans() as spans:
            stopped_by, wall = distill.run_until(pal, DISTILL_TIMEOUT)
        cuq_launches, fa_launches = cuq_kernel.launches, fa_kernel.launches
        busy = spans.busy_share()
        rep = pal.report()
        c = rep["counters"]
        eng, tr = pal.engine, pal.committee_trainer
        teacher = pal.monitor.timer("oracle.run_calc")
        bad = {k: c.get(k, 0) for k in ("runtime.thread_crashes",
                                        "runtime.unjoined_threads")}
        if any(bad.values()):
            raise AssertionError(f"distill: {bad}")
        if rep["labeled_total"] <= 0 or rep["device_weight_refreshes"] < 1:
            raise AssertionError(f"distill: {rep['labeled_total']} labels, "
                                 f"{rep['device_weight_refreshes']} "
                                 f"refreshes")
        warm = 2 * len(eng.trace_counts)
        if cuq_launches != eng.dispatches + warm or eng.dispatches == 0:
            raise AssertionError(f"distill: committee_uq launches "
                                 f"{cuq_launches} != engine dispatches "
                                 f"{eng.dispatches} + {warm} warm-up "
                                 f"launches")
        layers = distill.TEACHER.num_layers
        # each teacher worker captures its relabel at its first label: two
        # eager warm-up forwards, then one replay per label
        t_caps = [o.captures for o in pal._oracle_instances.values()]
        forwards = teacher.count + 2 * sum(t_caps)
        if fa_launches != forwards * layers or teacher.count == 0 or \
                any(c != 1 for c in t_caps):
            raise AssertionError(f"distill: flash_attention launches "
                                 f"{fa_launches} != ({teacher.count} teacher "
                                 f"forwards + 2 x {sum(t_caps)} captures "
                                 f"{t_caps}) x {layers} layers")
        if any(v != 1 for v in eng.trace_counts.values()) or \
                tr.captures != 1 or tr.graph_replays != tr.steps_done:
            raise AssertionError(f"distill: captures {eng.trace_counts}, "
                                 f"trainer {tr.captures} captures, "
                                 f"{tr.graph_replays} replays for "
                                 f"{tr.steps_done} steps")
        snap = tr.snapshot_cparams()
        for a, b in zip(cmte.tree_leaves(eng.cparams),
                        cmte.tree_leaves(snap)):
            if not torch.equal(a, b):
                raise AssertionError("distill: engine weights != the "
                                     "trainer's")
        it = c.get("exchange.iterations", 0)
        sel_frac = rep["labeled_total"] / max(it * pal.cfg.gene_process, 1)
        share, n_replays, window_ms = busy
        # the teacher alone, after the run: ms per label on an idle card,
        # captured and eager
        prompts = [distill.PromptGene(r, tmp).generate_new_data(None)[1]
                   for r in range(20)]
        alone = {}
        for name, cls in (("captured", distill.TeacherOracle),
                          ("eager", EagerTeacherOracle)):
            oracle = cls(0, tmp, device="cuda")
            labels = [oracle.run_calc(x)[1] for x in prompts[:2]]
            t0 = time.perf_counter()
            for x in prompts:
                oracle.run_calc(x)
            alone[name] = ((time.perf_counter() - t0) * 1e3 / len(prompts),
                           labels)
        if not all(np.array_equal(a, b) for a, b in zip(
                alone["captured"][1], alone["eager"][1])):
            raise AssertionError("distill: the captured teacher's labels "
                                 "differ from the eager teacher's")
        teacher_alone_ms = alone["captured"][0]
        print(f"distill (PAL at LM scale, examples/lm_active_distill's "
              f"configuration: 8 prompt generators, 3 students of 2 layers, "
              f"2 teacher oracles of 4 layers): stopped by {stopped_by} "
              f"after {wall:.4f} s (stop at {distill.TARGET_LABELS} labels "
              f"or {DISTILL_TIMEOUT:.0f} s); {it} exchange rounds = "
              f"{it / wall:.2f} it/s, {rep['labeled_total']} labels = "
              f"{rep['labeled_total'] / wall:.2f} labels/s, selection "
              f"fraction {sel_frac:.3f}; {c.get('train.retrains', 0)} "
              f"retrains, {rep['train_fused_steps']} fused train steps, "
              f"{rep['device_weight_refreshes']} device weight refreshes; "
              f"teacher (captured) {1e3 * teacher.mean:.4f} ms per label "
              f"over {teacher.count} in the run (the workers' captures "
              f"included), {teacher_alone_ms:.4f} ms alone after it (mean "
              f"of 20; eager {alone['eager'][0]:.4f} ms, labels equal bit "
              f"for bit) [{smi}]")
        print(f"distill device busy share (the union of the engine's, the "
              f"trainer's and the teachers' graph replays by CUDA events; "
              f"the copies not counted) over "
              f"{window_ms:.1f} ms from the first replay to the last: "
              + (f"{100 * share:.2f} % ({n_replays} replays)"
                 if share is not None else "not measured (no replay)")
              + f" [{smi}]")
        print(f"distill checks: 0 crashes, 0 unjoined threads; committee_uq "
              f"launches {cuq_launches} == engine dispatches "
              f"{eng.dispatches} + {warm} warm-up launches; flash_attention "
              f"launches {fa_launches} == ({teacher.count} teacher replays + "
              f"2 x {sum(t_caps)} warm-up forwards) x {layers} layers; one "
              f"capture per bucket {eng.trace_counts}, one for the trainer "
              f"and one per teacher worker; engine weights == the trainer's "
              f"bit for bit")

        # the same loop with the eager teacher: the "before" in the loop
        pal_e = distill.make_pal(tempfile.mkdtemp(dir=tmp), "cuda",
                                 oracle=EagerTeacherOracle)
        stopped_e, wall_e = distill.run_until(pal_e, DISTILL_TIMEOUT)
        rep_e = pal_e.report()
        bad_e = {k: rep_e["counters"].get(k, 0) for k in (
            "runtime.thread_crashes", "runtime.unjoined_threads")}
        if any(bad_e.values()) or rep_e["labeled_total"] <= 0:
            raise AssertionError(f"distill, eager teacher: {bad_e}, "
                                 f"{rep_e['labeled_total']} labels")
        teacher_e = pal_e.monitor.timer("oracle.run_calc")
        print(f"distill teacher in the loop, before and after: eager "
              f"{1e3 * teacher_e.mean:.4f} ms per label over "
              f"{teacher_e.count} (stopped by {stopped_e} after "
              f"{wall_e:.4f} s, {rep_e['labeled_total'] / wall_e:.2f} "
              f"labels/s), captured {1e3 * teacher.mean:.4f} ms over "
              f"{teacher.count} ({rep['labeled_total'] / wall:.2f} "
              f"labels/s); alone: eager {alone['eager'][0]:.4f} ms, "
              f"captured {teacher_alone_ms:.4f} ms per label [{smi}]")
        del pal_e
    return {"cuq_launches": cuq_launches, "fa_launches": fa_launches,
            "stopped_by": stopped_by, "iterations_per_s": it / wall,
            "labels_per_s": rep["labeled_total"] / wall,
            "retrains": c.get("train.retrains", 0),
            "train_steps": rep["train_fused_steps"],
            "refreshes": rep["device_weight_refreshes"],
            "selection_fraction": sel_frac, "busy_share": share,
            "teacher_ms": 1e3 * teacher.mean,
            "teacher_alone_ms": teacher_alone_ms,
            "teacher_eager_ms": 1e3 * teacher_e.mean,
            "teacher_eager_alone_ms": alone["eager"][0]}


# ---------------------------------------------------------------------------
# 17. LM training through launch/train.py
# ---------------------------------------------------------------------------

LM_TRAIN_SMOKE = (4, 64, 5)       # batch, seq, steps at --preset smoke
LM_TRAIN_FULL = (8, 512, 30)      # llama3.2-1b uncut: batch, seq, steps
LM_TRAIN_CUT = (2, 128, 3)        # 2 fp32 layers at full width, vs the CPU
LM_TRAIN_RESUME_AT = 20
# card vs CPU, the CPU tests' tolerances (tests/test_torch_lm_train.py):
# free running (each from one state), lr and losses at every step;
# teacher-forced (the card's captured step loaded with the CPU's state
# before each step), losses and moe_aux rtol 1e-5, grad norms rtol 1e-3
LM_TRAIN_LOSS_RTOL = {"whisper-small": 1e-3}
LM_TRAIN_LOSS_RTOL_DEFAULT = 1e-4
LM_TRAIN_LR_RTOL = 1e-6
LM_TRAIN_TF_RTOL = {"loss": 1e-5, "moe_aux": 1e-5, "grad_norm": 1e-3}


def _kernel_launches():
    return (cuq_kernel.launches, fa_kernel.launches, wkv_kernel.launches,
            ssd_kernel.launches)


def _reset_kernel_launches():
    cuq_kernel.launches = fa_kernel.launches = 0
    fa_kernel.launches_tiled = fa_kernel.launches_split = 0
    wkv_kernel.launches = ssd_kernel.launches = 0


def _train_state(arch, cfg, steps, seq):
    """A fresh ``TrainState`` of ``cfg`` on the CPU from ``SEED``; each run
    of a comparison starts from a copy of it."""
    from repro_torch.launch import train as lm_train
    from repro_torch.training import make_train_state

    model = model_zoo.build_model(cfg, impl="plain", max_seq=seq)
    params = model.init(torch.Generator().manual_seed(SEED), device="cpu")
    return make_train_state(params, lm_train.train_config(arch, steps, 3e-4))


def _rel(g, w):
    return abs(g - w) / max(abs(w), 1e-30)


def _hold_free_running(what, got, want, loss_rtol):
    """``got`` (card) against ``want`` (CPU), each run free from one state:
    lr and losses at every step; returns the worst relative loss
    difference."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        for key, rtol in (("lr", LM_TRAIN_LR_RTOL), ("loss", loss_rtol)):
            if not np.isfinite(g[key]) or _rel(g[key], w[key]) > rtol:
                raise AssertionError(f"{what}: step {i + 1} {key} "
                                     f"{g[key]!r} vs CPU {w[key]!r}")
        worst = max(worst, _rel(g["loss"], w["loss"]))
    return worst


def _teacher_forced(arch, cfg, batch, seq, steps, state0):
    """The CPU's step run free from ``state0`` on ``train``'s stream (what
    ``train(device="cpu", init_state=state0)`` runs), and beside it the
    card's captured step, loaded before each step with the CPU's state
    before it: loss, ``moe_aux`` and grad norm held at every step at
    ``LM_TRAIN_TF_RTOL``.  Returns the CPU's per-step metrics and the
    worst relative difference of each held metric."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.synthetic import SyntheticTokenStream
    from repro_torch.launch import train as lm_train
    from repro_torch.training import CapturedTrainStep

    loss_fn = model_zoo.make_loss_fn(
        model_zoo.build_model(cfg, impl="plain", max_seq=seq))
    tcfg = lm_train.train_config(arch, steps, 3e-4)
    cpu = CapturedTrainStep(loss_fn, tcfg, torch.utils._pytree.tree_map(
        lambda t: t.clone(), state0))
    card = CapturedTrainStep(loss_fn, tcfg, torch.utils._pytree.tree_map(
        lambda t: t.to("cuda", copy=True), state0))
    stream = SyntheticTokenStream(
        cfg, ShapeConfig("cli", seq, batch, "train"), seed=SEED)
    want, worst = [], {}
    for i in range(steps):
        host = {k: torch.from_numpy(v) for k, v in next(stream).items()}
        card.load_state_(cpu.state)
        g = {k: float(v) for k, v in card(
            {k: v.pin_memory() for k, v in host.items()}).items()}
        w = {k: float(v) for k, v in cpu(host).items()}
        for key, rtol in LM_TRAIN_TF_RTOL.items():
            if key not in w:
                continue
            rel = _rel(g[key], w[key])
            if not np.isfinite(g[key]) or rel > rtol:
                raise AssertionError(f"{arch}: teacher-forced step {i + 1} "
                                     f"{key} {g[key]!r} vs CPU {w[key]!r}")
            worst[key] = max(worst.get(key, 0.0), rel)
        want.append(w)
    if (card.captures, card.replays) != (1, steps):
        raise AssertionError(f"{arch}: teacher-forced captures "
                             f"{card.captures}, replays {card.replays}")
    return want, worst


def _tf_text(worst):
    return ", ".join(f"{k} {v:.3e}" for k, v in worst.items())


def _same_state(a, b, what):
    for x, y in zip(torch.utils._pytree.tree_leaves(a),
                    torch.utils._pytree.tree_leaves(b)):
        if not torch.equal(x.cpu(), y.cpu()):
            raise AssertionError(f"{what}: final states differ")


def _lm_train_smoke():
    """(a) every arch at --preset smoke: captured == eager on the card bit
    for bit (metrics and final state), one capture, the card == the CPU
    (free running and teacher-forced)."""
    from repro_torch.configs import list_archs
    from repro_torch.launch import train as lm_train

    batch, seq, steps = LM_TRAIN_SMOKE
    rows = []
    for arch in list_archs():
        cfg = lm_train.reduced_config(get_arch(arch).model, "smoke")
        if cfg.remat != "dots":
            raise AssertionError(f"{arch}: the smoke preset trains under "
                                 f"remat={cfg.remat!r}, not the reference's "
                                 f"'dots'")
        state0 = _train_state(arch, cfg, steps, seq)
        kw = dict(steps=steps, batch=batch, seq=seq, init_state=state0)
        with contextlib.redirect_stdout(io.StringIO()):
            cap = lm_train.train(arch, "smoke", device="cuda", **kw)
            eager = lm_train.train(arch, "smoke", device="cuda",
                                   capture=False, **kw)
        cpu, tf = _teacher_forced(arch, cfg, batch, seq, steps, state0)
        if (cap["captures"], cap["replays"], eager["captures"]) != (
                1, steps, 0):
            raise AssertionError(f"{arch}: captures {cap['captures']}, "
                                 f"replays {cap['replays']}")
        if cap["metrics"] != eager["metrics"]:
            raise AssertionError(f"{arch}: captured metrics != eager: "
                                 f"{cap['metrics']} vs {eager['metrics']}")
        _same_state(cap["step"].state, eager["step"].state, arch)
        wl = _hold_free_running(
            arch, cap["metrics"], cpu,
            LM_TRAIN_LOSS_RTOL.get(arch, LM_TRAIN_LOSS_RTOL_DEFAULT))
        ms = float(np.mean(cap["step_ms"][1:]))
        rows.append(arch)
        print(f"  {arch} (remat {cfg.remat}): {steps} steps, captured == "
              f"eager bit for bit, 1 capture; card vs CPU free running: "
              f"worst loss rel "
              f"{wl:.3e}; teacher-forced, worst rel: {_tf_text(tf)}; "
              f"{ms:.3f} ms a captured step, "
              f"{float(np.mean(eager['step_ms'][1:])):.3f} eager")
    return rows


def _top_kernels(fn, calls, n=8):
    """The ``n`` device operations of ``calls`` calls of ``fn`` that take
    the most device time, by ``torch.profiler`` (one thread, nothing else
    on the card): (name, device ms per call, count per call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        rows.append((ev.key, us / 1e3 / calls, ev.count / calls))
    return sorted(rows, key=lambda r: -r[1])[:n]


def _eager_step_for_the_planner(step, cfg, batch, seq):
    """One more eager step of the live llama state, for ``phase_planner``:
    its FLOPs by ``FlopCounterMode`` and its peak memory over what was
    allocated before it (the state and what earlier phases left)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.synthetic import SyntheticTokenStream

    stream = SyntheticTokenStream(
        cfg, ShapeConfig("cli", seq, batch, "train"), seed=SEED)
    host = {k: torch.from_numpy(v).pin_memory()
            for k, v in next(stream).items()}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc:
        step(host)
    torch.cuda.synchronize()
    return {"eager_flops": fc.get_total_flops(), "base_bytes": base,
            "eager_step_peak_bytes": torch.cuda.max_memory_allocated()}


def _functional_steps(cfg, batch, seq, steps=2):
    """``steps`` eager steps of ``cfg`` through ``make_train_step(
    functional=True)``, the ``torch.func`` gradient path (the LM step's
    before it took ``torch.autograd.grad``; it needs ``remat="none"``):
    ms a step by CUDA events around each step, and the peak allocated
    from before the init."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.synthetic import SyntheticTokenStream
    from repro_torch.launch import train as lm_train
    from repro_torch.training import make_train_state, make_train_step

    model = model_zoo.build_model(cfg, impl="plain", max_seq=seq)
    tcfg = lm_train.train_config(LM_ARCH, steps, 3e-4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = make_train_state(model.init(
        torch.Generator("cuda").manual_seed(SEED), device="cuda"), tcfg)
    step = make_train_step(model_zoo.make_loss_fn(model), tcfg,
                           functional=True)
    stream = SyntheticTokenStream(
        cfg, ShapeConfig("cli", seq, batch, "train"), seed=SEED)
    ms = []
    for _ in range(steps):
        b = {k: torch.from_numpy(v).cuda() for k, v in next(stream).items()}
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        state, _ = step(state, b)
        t1.record()
        torch.cuda.synchronize()
        ms.append(t0.elapsed_time(t1))
    return {"eager_step_ms": ms,
            "eager_peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def _lm_train_full(smi):
    """(b) llama3.2-1b uncut through ``main(argv)``, under the arch's
    ``"dots"``: 30 captured steps with a checkpoint every 10; 3 eager
    steps before them (and one more for ``phase_planner``); a resume from
    step 20 reproducing steps 21-30.  First, 2 eager steps of the same
    model under ``remat="none"`` (and one more for ``phase_planner``):
    the same process's before, whose peak must lie above the "dots"
    one's; then 2 eager "none" steps through the ``torch.func`` gradient
    path."""
    import os
    import shutil
    import tempfile

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.synthetic import SyntheticTokenStream
    from repro_torch.launch import train as lm_train

    batch, seq, steps = LM_TRAIN_FULL
    cfg = get_arch(LM_ARCH).model
    if cfg.remat != "dots":
        raise AssertionError(f"{LM_ARCH} trains under remat={cfg.remat!r}")
    flops = roofline.analytic_model_flops(
        cfg, ShapeConfig("train", seq, batch, "train"))
    # the same model without remat, eagerly, in this process
    none_cfg = cfg.replace(remat="none")
    with contextlib.redirect_stdout(io.StringIO()):
        base = lm_train.train(LM_ARCH, "full", steps=2, batch=batch, seq=seq,
                              capture=False, model_cfg=none_cfg)
    none = {"eager_step_ms": base["step_ms"],
            "eager_peak_gib": base["peak_bytes"] / 2**30,
            "plan_probe": _eager_step_for_the_planner(base["step"], none_cfg,
                                                      batch, seq)}
    del base
    gc.collect()
    torch.cuda.empty_cache()
    none["functional"] = _functional_steps(none_cfg, batch, seq)
    gc.collect()
    torch.cuda.empty_cache()
    # eager first: its activations leave the card before a graph's pool
    # takes its own
    with contextlib.redirect_stdout(io.StringIO()):
        eager = lm_train.train(LM_ARCH, "full", steps=3, batch=batch,
                               seq=seq, capture=False)
    eager_ms, eager_peak = eager["step_ms"], eager["peak_bytes"]
    if not eager_peak / 2**30 < none["eager_peak_gib"]:
        raise AssertionError(f"remat 'dots' peaks at "
                             f"{eager_peak / 2**30:.3f} GiB, not below "
                             f"'none''s {none['eager_peak_gib']:.3f} GiB")
    ckpt_bytes = sum(t.nbytes for t in
                     torch.utils._pytree.tree_leaves(eager["step"].state))
    plan_probe = _eager_step_for_the_planner(eager["step"], cfg, batch, seq)
    plan_probe["state_bytes"] = ckpt_bytes
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    argv = ["--arch", LM_ARCH, "--preset", "full", "--batch", str(batch),
            "--seq", str(seq), "--steps", str(steps), "--ckpt-every", "10",
            "--log-every", "10"]
    with tempfile.TemporaryDirectory() as tmp:
        # the run keeps its last 3 checkpoints (AsyncCheckpointer's keep)
        free, need = shutil.disk_usage(tmp).free, 3 * ckpt_bytes + 2**30
        print(f"  checkpoints in {tmp}: {free / 2**30:.1f} GiB free, "
              f"{ckpt_bytes / 1e9:.2f} GB a checkpoint")
        if free < need:
            raise AssertionError(
                f"checkpoints: {free / 2**30:.1f} GiB free in {tmp}, the run "
                f"needs {need / 2**30:.1f} GiB (3 checkpoints of "
                f"{ckpt_bytes / 2**30:.1f} GiB); point TMPDIR at a larger "
                f"disk")
        run, again = os.path.join(tmp, "run"), os.path.join(tmp, "resume")
        out = lm_train.main(argv + ["--ckpt-dir", run])
        losses = [m["loss"] for m in out["metrics"]]
        if len(losses) != steps or not all(np.isfinite(losses)) \
                or not losses[-1] < losses[0]:
            raise AssertionError(f"full-width losses: {losses}")
        if (out["captures"], out["replays"]) != (1, steps):
            raise AssertionError(f"full width: captures {out['captures']}, "
                                 f"replays {out['replays']}")
        step_ms = float(np.mean(out["step_ms"][1:]))
        stream = SyntheticTokenStream(
            cfg, ShapeConfig("cli", seq, batch, "train"), seed=SEED,
            step=steps)
        host = {k: torch.from_numpy(v).pin_memory()
                for k, v in next(stream).items()}
        kernels, copies, device_us = _device_profile(
            lambda: out["step"](host), 2)
        top = _top_kernels(lambda: out["step"](host), 2)
        # steps 2-10: after the capture, before the first checkpoint
        starts, ms = out["step_start_ms"], out["step_ms"]
        window = sum(ms[1:10]) / (starts[9] + ms[9] - starts[1])
        result = {
            "step_ms": step_ms, "eager_step_ms": eager_ms,
            "first_step_ms": out["step_ms"][0],
            "tokens_per_second": batch * seq / (step_ms / 1e3),
            "run_tokens_per_second": out["tokens_per_second"],
            "mfu": flops / (step_ms / 1e3 * roofline.PEAK_FLOPS),
            "model_tflop": flops / 1e12, "kernels": kernels,
            "copies": copies, "device_ms": device_us / 1e3,
            "busy_share": out["busy_share"], "busy_share_2_10": window,
            "top": top,
            "peak_gib": out["peak_bytes"] / 2**30, "plan_probe": plan_probe,
            "eager_peak_gib": eager_peak / 2**30, "none": none,
            "run_seconds": out["seconds"], "losses": losses}
        first = out["metrics"]
        del out, host
        gc.collect()
        torch.cuda.empty_cache()
        os.makedirs(again)
        name = f"ckpt_{LM_TRAIN_RESUME_AT:08d}.pkl"
        os.replace(os.path.join(run, name), os.path.join(again, name))
        shutil.rmtree(run)
        res = lm_train.main(argv + ["--ckpt-dir", again, "--resume"])
        if res["start_step"] != LM_TRAIN_RESUME_AT or len(res["metrics"]) != \
                steps - LM_TRAIN_RESUME_AT:
            raise AssertionError(f"resume: start {res['start_step']}, "
                                 f"{len(res['metrics'])} steps")
        want = first[LM_TRAIN_RESUME_AT:]
        result["resume_bitwise"] = res["metrics"] == want
        result["resume_worst_rel"] = max(
            abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
            for g, w in zip(res["metrics"], want) for k in w)
        if not result["resume_bitwise"]:
            raise AssertionError(
                f"resume from step {LM_TRAIN_RESUME_AT}: steps "
                f"{LM_TRAIN_RESUME_AT + 1}-{steps} differ from the straight "
                f"run (worst relative {result['resume_worst_rel']:.3e})")
        del res
    gc.collect()
    torch.cuda.empty_cache()
    return result


def _lm_train_cut():
    """(c) llama3.2-1b at full width cut to 2 fp32 layers: the card
    against the CPU from one state, free running and teacher-forced."""
    from repro_torch.launch import train as lm_train

    batch, seq, steps = LM_TRAIN_CUT
    cfg = two_layers(LM_ARCH)
    state0 = _train_state(LM_ARCH, cfg, steps, seq)
    with contextlib.redirect_stdout(io.StringIO()):
        card = lm_train.train(LM_ARCH, "full", device="cuda", model_cfg=cfg,
                              steps=steps, batch=batch, seq=seq,
                              init_state=state0)
    del card["step"]
    gc.collect()
    torch.cuda.empty_cache()
    cpu, tf = _teacher_forced(LM_ARCH, cfg, batch, seq, steps, state0)
    return _hold_free_running("2-layer fp32 cut", card["metrics"], cpu,
                              LM_TRAIN_LOSS_RTOL_DEFAULT), tf


def _lm_train_refusal():
    """(d) each kernel wrapper refuses an input that requires grad on the
    card, before it launches."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    n_valid = torch.tensor([64], dtype=torch.int32, device="cuda")
    calls = {
        "flash_attention": (lambda q, k, v: fa_kernel.flash_attention(
            q, k, v), [rand(1, 64, 4, 64), rand(1, 64, 2, 64),
                       rand(1, 64, 2, 64)]),
        "wkv6": (lambda r, k, v, w, u: wkv_kernel.wkv6(r, k, v, w, u)[0],
                 [rand(1, 64, 2, 64), rand(1, 64, 2, 64), rand(1, 64, 2, 64),
                  torch.sigmoid(rand(1, 64, 2, 64)), rand(2, 64)]),
        "ssd": (lambda x, a, b, c: ssd_kernel.ssd(x, a, b, c)[0],
                [rand(1, 64, 2, 32), torch.sigmoid(rand(1, 64, 2)),
                 rand(1, 64, 2, 16), rand(1, 64, 2, 16)]),
        "committee_uq": (lambda p: cuq_kernel.committee_uq(p, 0.1)[0],
                         [rand(4, 64, 24)]),
        "committee_uq_packed": (lambda p: cuq_kernel.committee_uq_packed(
            p, 0.1, n_valid), [rand(4, 64, 24)])}
    before = _kernel_launches()
    for name, (fn, xs) in calls.items():
        for i in range(len(xs)):
            args = [x.clone().requires_grad_(j == i)
                    for j, x in enumerate(xs)]
            try:
                fn(*args).float().sum().backward()
            except RuntimeError as e:
                if "has no backward" not in str(e):
                    raise
            else:
                raise AssertionError(f"{name}: input {i} requires grad and "
                                     f"the wrapper did not refuse it")
        with torch.no_grad():
            fn(*[x.clone().requires_grad_() for x in xs])
    torch.cuda.synchronize()
    launched = [a - b for a, b in zip(_kernel_launches(), before)]
    if launched != [2, 1, 1, 1]:
        raise AssertionError(f"refusal: launches {launched}, want one "
                             f"no-grad call each (2 for committee_uq)")
    return len(calls)


def phase_lm_train(smi):
    """LM training through ``repro_torch.launch.train`` on the card, the
    loop of the reference's ``launch/train.py`` with its step one captured
    CUDA graph per batch shape (the plain attention and scans: the step
    launches no kernel of its own): (a) every arch at ``--preset smoke``
    (batch 4, seq 64, 5 steps, fp32, TF32 off), captured == eager bit for
    bit, one capture, the card == the CPU free running and teacher-forced;
    (b) llama3.2-1b uncut (1.236 B params,
    fp32 params, bf16 compute), batch 8, seq 512, 30 steps through
    ``main(argv)`` with a checkpoint every 10 steps: finite losses, the
    last below the first, captured and eager ms a step, tokens/s, MFU by
    ``roofline.analytic_model_flops``, kernels a step, the busy share by
    CUDA events around the steps, peak memory, and a resume from step 20
    reproducing steps 21-30 bit for bit; (c) 2 fp32 layers at full width,
    the card against the CPU for 3 steps, free running and teacher-forced;
    (d) every kernel wrapper refuses
    a gradient-tracked input on the card."""
    _reset_kernel_launches()
    archs = _lm_train_smoke()
    full = _lm_train_full(smi)
    launched = _kernel_launches()
    if any(launched):
        raise AssertionError(f"LM training launched kernels {launched}: it "
                             f"runs the plain path")
    fnl = full["none"]["functional"]
    print(f"  llama3.2-1b full width, batch {LM_TRAIN_FULL[0]}, seq "
          f"{LM_TRAIN_FULL[1]}: {full['step_ms']:.4f} ms a captured step "
          f"(first, with the capture: {full['first_step_ms']:.1f} ms), "
          f"eager {', '.join(f'{x:.4f}' for x in full['eager_step_ms'])} "
          f"ms; {full['tokens_per_second']:.1f} tokens/s in the steps "
          f"({full['run_tokens_per_second']:.1f} over the run's "
          f"{full['run_seconds']:.2f} s with its checkpoints); MFU "
          f"{full['mfu']:.4f} ({full['model_tflop']:.3f} TFLOP a step over "
          f"989 TFLOP/s); {full['kernels']:.0f} kernels and "
          f"{full['copies']:.0f} copies a step, {full['device_ms']:.4f} ms "
          f"device a step by the profiler; busy share "
          f"{100 * full['busy_share']:.2f} % over the run, "
          f"{100 * full['busy_share_2_10']:.2f} % over steps 2-10 (CUDA "
          f"events around the steps); "
          f"peak {full['peak_gib']:.3f} GiB captured, "
          f"{full['eager_peak_gib']:.3f} GiB eager, under remat 'dots'; "
          f"remat 'none' in this process: eager "
          f"{', '.join(f'{x:.4f}' for x in full['none']['eager_step_ms'])} "
          f"ms, peak {full['none']['eager_peak_gib']:.3f} GiB eager "
          f"(held: 'dots' peaks lower), and through the torch.func "
          f"gradient path: eager "
          f"{', '.join(f'{x:.4f}' for x in fnl['eager_step_ms'])} ms, "
          f"peak {fnl['eager_peak_gib']:.3f} GiB; losses "
          f"{full['losses'][0]:.4f} -> {full['losses'][-1]:.4f}; resume "
          f"from step {LM_TRAIN_RESUME_AT}: steps {LM_TRAIN_RESUME_AT + 1}-"
          f"{LM_TRAIN_FULL[2]} bit for bit; {smi}")
    for name, ms, count in full["top"]:
        print(f"    {ms:9.4f} ms a step, {count:5.0f} calls: {name[:110]}")
    wl, tf = _lm_train_cut()
    print(f"  2 fp32 layers at full width, card vs CPU over "
          f"{LM_TRAIN_CUT[2]} steps: free running, worst loss rel {wl:.3e} "
          f"(rtol {LM_TRAIN_LOSS_RTOL_DEFAULT}); teacher-forced, worst rel "
          f"{_tf_text(tf)} (rtol {LM_TRAIN_TF_RTOL})")
    n = _lm_train_refusal()
    print(f"  {n} kernel entries refuse a gradient-tracked input on the "
          f"card; {len(archs)} archs trained at the smoke preset; no kernel "
          f"launched by training")
    return full


PLAN_FLOPS_RTOL = 1e-9


def _planner_cli():
    """(a) ``python -m repro_torch.launch.dryrun`` on one cell of the
    production mesh, in a subprocess, tracing on fake CUDA tensors."""
    import os
    import subprocess
    import tempfile

    root = Path(__file__).resolve().parent
    cell = "decode_32k"
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=str(root / "src"))
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             LM_ARCH, "--shape", cell, "--out", tmp],
            capture_output=True, text=True, timeout=600, env=env,
            cwd=str(root))
        if out.returncode != 0:
            raise AssertionError(f"dryrun CLI: rc {out.returncode}\n"
                                 f"{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
        with open(os.path.join(tmp, f"{LM_ARCH}_{cell}_singlepod.json")) as f:
            rep = json.load(f)
    if rep.get("traced") is not True or rep.get("mesh") != {
            "data": 16, "model": 16} or not rep.get(
            "resident_gib_per_device", 0) > 0 or \
            not str(rep.get("device")).startswith("cuda"):
        raise AssertionError(f"dryrun CLI report: {rep}")
    return rep


def _probe_line_temp(cfg, shape, tcfg, mesh):
    """``cfg``'s step temp at full depth from the line through its depth-2
    and depth-3 traces, as ``roofline_cell`` fits a training cell's
    peak."""
    from repro_torch.launch import dryrun

    temps = [dryrun.lower_shape(LM_ARCH, shape, mesh,
                                cfg=cfg.replace(num_layers=d),
                                train_cfg=tcfg, device="cuda")
             ["memory"]["temp_size_in_bytes"] for d in (2, 3)]
    c0, c1, _ = roofline._fit((2, 3), temps)
    return c0 + c1 * cfg.num_layers


def phase_planner(smi, lm_full):
    """The planners (``launch/dryrun.py``, ``launch/roofline.py``): (a) the
    dry-run CLI on llama3.2-1b ``decode_32k`` under the 16 x 16 production
    mesh (traced on fake CUDA tensors), then ``roofline_cell``'s rows for
    llama3.2-1b ``train_4k`` and qwen3-moe-235b-a22b ``decode_32k``; (b)
    the plan of ``phase_lm_train``'s full-width llama step (batch 8, seq
    512, its ``TrainConfig``) on the host mesh against the steps that
    phase ran: the planned resident bytes == the live ``TrainState``'s
    exactly, the traced FLOPs == ``FlopCounterMode`` around one real eager
    step (rel 1e-9), and the roofline's lower bound <= the measured
    captured step; the planned peak (resident + temp) printed beside the
    eager step's ``max_memory_allocated``.  The plan runs the arch's
    remat policy, "dots"; (c) the same shape under ``remat="none"``
    beside that phase's "none" eager step (printed, not gated), and for
    each policy the temp from the line through its depth-2 and depth-3
    traces beside its full-depth trace.  No kernel runs."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as lm_train
    from repro_torch.launch.mesh import make_host_mesh

    rep = _planner_cli()
    print(f"  (a) dryrun CLI {LM_ARCH} decode_32k on {rep['mesh']}: "
          f"{rep['resident_gib_per_device']} GiB a device resident, "
          f"{rep['flops']:.4e} FLOPs and {rep['bytes_accessed']:.4e} bytes "
          f"a device, temp {rep['memory']['temp_size_in_bytes']} B, "
          f"collectives {rep['collectives']}; traced in "
          f"{rep['trace_seconds']} s on {rep['device']}")
    rows = {}
    for arch, cell in ((LM_ARCH, "train_4k"),
                       ("qwen3-moe-235b-a22b", "decode_32k")):
        rows[(arch, cell)] = r = roofline.roofline_cell(arch, cell)
        print("  " + roofline.fmt_row(r))

    batch, seq, _ = LM_TRAIN_FULL
    probe = lm_full["plan_probe"]
    shape = ShapeConfig("lm_train", seq, batch, "train")
    tcfg = lm_train.train_config(LM_ARCH, 3, 3e-4)
    plan = dryrun.lower_shape(LM_ARCH, shape, make_host_mesh(),
                              train_cfg=tcfg, device="cuda")
    terms = roofline.roofline_terms(plan["flops"], plan["bytes_accessed"],
                                    plan["collective_bytes_per_device"])
    resident = plan["resident_bytes_per_device"]
    if resident != probe["state_bytes"]:
        raise AssertionError(f"planned resident {resident} B != the live "
                             f"TrainState's {probe['state_bytes']} B")
    frel = _rel(plan["flops"], probe["eager_flops"])
    if frel > PLAN_FLOPS_RTOL:
        raise AssertionError(f"traced FLOPs {plan['flops']:.6e} != the "
                             f"eager step's {probe['eager_flops']:.6e} "
                             f"(rel {frel:.3e})")
    bound_ms = terms["step_time_lower_bound_s"] * 1e3
    if not bound_ms <= lm_full["step_ms"]:
        raise AssertionError(f"roofline bound {bound_ms:.4f} ms > the "
                             f"measured captured step "
                             f"{lm_full['step_ms']:.4f} ms")
    temp = plan["memory"]["temp_size_in_bytes"]
    peak = probe["eager_step_peak_bytes"]
    # the eager step's own peak: what it held over what it found allocated
    # besides the state
    own = peak - (probe["base_bytes"] - probe["state_bytes"])
    flops = roofline.analytic_model_flops(
        get_arch(LM_ARCH).model, ShapeConfig("lm_train", seq, batch, "train"))
    print(f"  (b) {LM_ARCH} batch {batch} seq {seq} on the host mesh: "
          f"resident {resident} B == the live TrainState's (held); traced "
          f"{plan['flops']:.6e} FLOPs against the eager step's "
          f"{probe['eager_flops']:.6e} (rel {frel:.3e}, held; analytic "
          f"{flops:.6e}, useful {flops / plan['flops']:.4f}); "
          f"{plan['bytes_accessed']:.6e} bytes, {plan['aten_ops']} ops; "
          f"compute {terms['compute_term_s'] * 1e3:.4f} ms, memory "
          f"{terms['memory_term_s'] * 1e3:.4f} ms -> {terms['bottleneck']} "
          f"bound {bound_ms:.4f} ms <= the captured step "
          f"{lm_full['step_ms']:.4f} ms (held; ratio "
          f"{bound_ms / lm_full['step_ms']:.4f}); planned peak "
          f"{(resident + temp) / 2**30:.3f} GiB (resident "
          f"{resident / 2**30:.3f} + temp {temp / 2**30:.3f}) against the "
          f"eager step's {own / 2**30:.3f} GiB over the rest "
          f"({peak / 2**30:.3f} allocated at its peak; ratio "
          f"{(resident + temp) / own:.4f}); the captured run's peak "
          f"{lm_full['peak_gib']:.3f} GiB; traced in "
          f"{plan['trace_seconds']} s; remat 'dots'; {smi}")

    model = get_arch(LM_ARCH).model
    none_cfg = model.replace(remat="none")
    none_plan = dryrun.lower_shape(LM_ARCH, shape, make_host_mesh(),
                                   cfg=none_cfg, train_cfg=tcfg,
                                   device="cuda")
    nprobe = lm_full["none"]["plan_probe"]
    none_temp = none_plan["memory"]["temp_size_in_bytes"]
    none_peak = nprobe["eager_step_peak_bytes"]
    none_own = none_peak - (nprobe["base_bytes"] - probe["state_bytes"])
    none_frel = _rel(none_plan["flops"], nprobe["eager_flops"])
    line = {"dots": _probe_line_temp(model, shape, tcfg, make_host_mesh()),
            "none": _probe_line_temp(none_cfg, shape, tcfg,
                                     make_host_mesh())}
    full_temp = {"dots": temp, "none": none_temp}
    print(f"  (c) the same step under remat 'none': traced "
          f"{none_plan['flops']:.6e} FLOPs against its eager step's "
          f"{nprobe['eager_flops']:.6e} (rel {none_frel:.3e}); 'dots' "
          f"traces {plan['flops'] / none_plan['flops']:.4f}x the FLOPs and "
          f"{plan['bytes_accessed'] / none_plan['bytes_accessed']:.4f}x the "
          f"bytes; planned peak {(resident + none_temp) / 2**30:.3f} GiB "
          f"(temp {none_temp / 2**30:.3f}) against the eager 'none' step's "
          f"{none_own / 2**30:.3f} GiB over the rest ({none_peak / 2**30:.3f}"
          f" allocated at its peak; ratio "
          f"{(resident + none_temp) / none_own:.4f}); the temp from the "
          f"depth-2/3 line at {model.num_layers} layers: "
          + "; ".join(f"{r} {line[r] / 2**30:.3f} GiB against the full "
                      f"trace's {full_temp[r] / 2**30:.3f} (error "
                      f"{100 * (line[r] / full_temp[r] - 1):+.2f} %)"
                      for r in ("dots", "none"))
          + f"; {smi}")
    return {"cli": rep, "rows": rows, "plan": plan, "terms": terms,
            "none_plan": none_plan, "line_temp": line}


def _timed(name, fn, *args):
    """Run one phase; print its wall time and what it left allocated on
    the card (after a collection)."""
    t0 = time.perf_counter()
    out = fn(*args)
    gc.collect()
    print(f"phase {name}: {time.perf_counter() - t0:.2f} s wall, "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated "
          f"after it")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    info = _timed("describe and build", phase_describe)
    smi = info["nvidia_smi"]
    worst, t = _timed("committee_uq", phase_kernels)
    launches, per_bucket = _timed("committee serving", phase_serving, smi)
    train_launches, train_t = _timed("committee training", phase_training,
                                     smi)
    rt_launches, rt_dispatches, rt = _timed("PAL runtime", phase_runtime,
                                            smi)
    fleet_launches, fleet = _timed("exploration fleet", phase_fleet, smi)
    fa_worst, fa_t = _timed("flash_attention", phase_flash, smi)
    fa_launches, fa_paths = _timed("llama serving", phase_lm, smi)
    _timed("llama card vs CPU", phase_card_vs_cpu, LM_ARCH,
           two_layers(LM_ARCH), (fa_kernel,))
    gc.collect()
    torch.cuda.empty_cache()
    print(f"before the RWKV6 phases: {torch.cuda.memory_allocated() / 2**30:.3f}"
          f" GiB allocated on the card")
    wkv_worst, wt = _timed("wkv6", phase_wkv6, smi)
    wkv_launches = _timed("rwkv6 serving", phase_rwkv, smi)
    _timed("rwkv6 card vs CPU", phase_card_vs_cpu, RWKV_ARCH,
           two_layers(RWKV_ARCH), (wkv_kernel,))
    gc.collect()
    torch.cuda.empty_cache()
    print(f"before the Jamba phases: {torch.cuda.memory_allocated() / 2**30:.3f}"
          f" GiB allocated on the card")
    ssd_worst, st = _timed("ssd", phase_ssd, smi)
    ssd_launches, jamba_fa_launches, jamba_fa_paths = _timed(
        "jamba serving", phase_jamba, smi)
    _timed("jamba card vs CPU", phase_card_vs_cpu, JAMBA_ARCH,
           get_arch(JAMBA_ARCH).model.replace(**JAMBA_NARROW),
           (ssd_kernel, fa_kernel))
    gc.collect()
    torch.cuda.empty_cache()
    print(f"before the MoE phases: {torch.cuda.memory_allocated() / 2**30:.3f}"
          f" GiB allocated on the card")
    moe = _timed("moe serving", phase_moe, smi)
    _timed("moe card vs CPU", phase_card_vs_cpu, MOE_ARCH,
           two_layers(MOE_ARCH), (fa_kernel,))
    whisper = _timed("whisper serving", phase_whisper, smi)
    _timed("whisper card vs CPU", phase_card_vs_cpu, WHISPER_ARCH,
           two_layers(WHISPER_ARCH).replace(encoder_layers=2), (fa_kernel,))
    internvl = _timed("internvl serving", phase_internvl, smi)
    _timed("internvl card vs CPU", phase_card_vs_cpu, INTERNVL_ARCH,
           two_layers(INTERNVL_ARCH), (fa_kernel,))
    rest = serve_rest(smi)
    distill = _timed("lm distill", phase_distill, smi)
    gc.collect()
    torch.cuda.empty_cache()
    lm_full = _timed("lm training", phase_lm_train, smi)
    gc.collect()
    torch.cuda.empty_cache()
    mesh = _timed("multi-device", phase_mesh, smi)
    _timed("planner", phase_planner, smi, lm_full)
    print(f"all phases: {time.perf_counter() - t_start:.2f} s wall")
    fd, fp = fa_t["decode"], fa_t["prefill"]
    jd, jp = fa_t["jamba_decode"], fa_t["jamba_prefill"]
    print(json.dumps({"kernels": [{
        "name": "committee_uq", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/committee_uq.cu",
        "replaces": "src/repro/kernels/committee_uq.py:116",
        "entry": "committee_uq_packed",
        "launches": launches, "max_abs_err": worst,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "eager_ms": t["eager_ms"], "plain_eager_ms": t["plain_eager_ms"],
        "library_eager_ms": t["library_eager_ms"],
        "bf16_ms": t["bf16_ms"],
        "five_output_ms": t["five_output_ms"],
        "five_output_plain_ms": t["five_output_plain_ms"],
        "large_ms": t["large_ms"],
        "large_five_output_ms": t["large_five_output_ms"],
        "large_bound_ms": t["large_bound_ms"],
        "large_five_output_bound_ms": t["large_five_output_bound_ms"],
        "launch_floor_ms": t["launch_floor_ms"],
        "dispatch_ms_by_bucket": per_bucket,
        "training_launches": train_launches,
        "training_step_ms": train_t["step_ms"],
        "training_eager_step_ms": train_t["eager_step_ms"],
        "runtime_launches": rt_launches,
        "runtime_dispatches": rt_dispatches,
        "runtime_iterations_per_s": rt["iterations_per_s"],
        "runtime_labels_per_s": rt["labels_per_s"],
        "runtime_busy_share": rt["busy_share"],
        "runtime_oracle_ms": rt["oracle_ms"],
        "runtime_oracle_eager_ms": rt["oracle_eager_ms"],
        "runtime_oracle_alone_ms": rt["oracle_alone_ms"],
        "runtime_oracle_eager_alone_ms": rt["oracle_eager_alone_ms"],
        "fleet_launches": fleet_launches,
        "fleet_step_ms": fleet["alone16"]["host_ms"],
        "fleet_device_ms": fleet["alone16"]["device_ms"],
        "fleet_proposals_per_s": fleet["alone16"]["proposals_per_s"],
        "fleet64_step_ms": fleet["alone64"]["host_ms"],
        "fleet64_proposals_per_s": fleet["alone64"]["proposals_per_s"],
        "host64_round_ms": fleet["host64"]["host_ms"],
        "host64_proposals_per_s": fleet["host64"]["proposals_per_s"],
        "fleet_runtime_iterations_per_s": fleet["iterations_per_s"],
        "fleet_runtime_labels_per_s": fleet["labels_per_s"],
        "fleet_runtime_busy_share": fleet["busy_share"],
        "distill_launches": distill["cuq_launches"],
        "distill_iterations_per_s": distill["iterations_per_s"],
        "distill_labels_per_s": distill["labels_per_s"],
        "distill_busy_share": distill["busy_share"],
        "mesh_launches": mesh["cuq_launches"],
        "mesh_dispatch_ms_1x1": mesh["a"]["mesh_ms"],
        "mesh_dispatch_ms_1x1_unsharded": mesh["a"]["unsharded_ms"],
        "mesh_dispatch_ms_2x1": [o["engine"]["mesh_ms"]
                                 for o in mesh["b"][(2, 1)]],
        "mesh_dispatch_ms_2x1_unsharded": [
            o["engine"]["unsharded_ms"] for o in mesh["b"][(2, 1)]],
        "mesh_collective_ms_2x1": [o["engine"]["collective_ms"]
                                   for o in mesh["b"][(2, 1)]]}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:108",
        "launches": fa_launches, "launches_tiled": fa_paths[0],
        "launches_split": fa_paths[1], "max_abs_err": fa_worst,
        "ms": fd["ms"], "plain_ms": fd["plain_ms"],
        "bound_ms": fd["bound_ms"], "bound_by": fd["bound_by"],
        "library_ms": fd["library_ms"],
        "library_gqa_ms": fd["library_gqa_ms"], "eager_ms": fd["eager_ms"],
        "plain_eager_ms": fd["plain_eager_ms"],
        "library_eager_ms": fd["library_eager_ms"],
        "decode_device_offset_ms": fa_t["decode_device"]["ms"],
        "decode_device_offset_plain_ms": fa_t["decode_device"]["plain_ms"],
        "decode_device_offset_bound_ms": fa_t["decode_device"]["bound_ms"],
        "prefill_ms": fp["ms"], "prefill_plain_ms": fp["plain_ms"],
        "prefill_bound_ms": fp["bound_ms"],
        "prefill_bound_by": fp["bound_by"],
        "prefill_library_ms": fp["library_ms"],
        "prefill_library_gqa_ms": fp["library_gqa_ms"],
        "prefill_eager_ms": fp["eager_ms"],
        "jamba_launches": jamba_fa_launches,
        "jamba_launches_tiled": jamba_fa_paths[0],
        "jamba_launches_split": jamba_fa_paths[1],
        "jamba_decode_ms": jd["ms"], "jamba_decode_plain_ms": jd["plain_ms"],
        "jamba_decode_bound_ms": jd["bound_ms"],
        "jamba_decode_bound_by": jd["bound_by"],
        "jamba_decode_library_ms": jd["library_ms"],
        "jamba_decode_library_gqa_ms": jd["library_gqa_ms"],
        "jamba_prefill_ms": jp["ms"],
        "jamba_prefill_plain_ms": jp["plain_ms"],
        "jamba_prefill_bound_ms": jp["bound_ms"],
        "jamba_prefill_bound_by": jp["bound_by"],
        "jamba_prefill_library_ms": jp["library_ms"],
        "jamba_prefill_library_gqa_ms": jp["library_gqa_ms"],
        "moe_launches": moe["launches"],
        "whisper_launches": whisper["launches"],
        "internvl_launches": internvl["launches"],
        **{f"{key}_{field}": out[field] for key, out in rest.items()
           for field in ("launches", "paths")},
        "distill_launches": distill["fa_launches"],
        "distill_teacher_ms": distill["teacher_ms"],
        "distill_teacher_eager_ms": distill["teacher_eager_ms"],
        "distill_teacher_alone_ms": distill["teacher_alone_ms"],
        "distill_teacher_eager_alone_ms": distill["teacher_eager_alone_ms"],
        "serving_captured_vs_eager": SERVING,
        **{f"{key}_{field}": fa_t[key][field]
           for key in ("whisper_encoder", "whisper_cross_decode",
                       "internvl_prefill", "moe_prefill", "danube_prefill",
                       "danube_decode", "minicpm_prefill", "minicpm_decode",
                       "nemo_prefill", "nemo_decode", "qwen3_prefill",
                       "qwen3_decode")
           for field in ("ms", "plain_ms", "bound_ms", "bound_by",
                         "library_ms", "library_gqa_ms")},
        "sass_mma": fa_t["sass_mma"]}, *({
        "name": f"flash_attention.{part}", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:108",
        "entry": f"flash_attention_{part}",
        "launches": mesh[f"{part}_launches"],
        "max_abs_err": max(mesh["times"][part]["max_abs_err"],
                           mesh["attn_worst"]),
        **{k: mesh["times"][part][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "split_path_ms": mesh["times"]["split_ms"]}
        for part in ("partials", "combine")), {
        "name": "wkv6", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/wkv6.py:72",
        "launches": wkv_launches, "max_abs_err": wkv_worst,
        "ms": wt["ms"], "plain_ms": wt["plain_ms"],
        "bound_ms": wt["bound_ms"], "bound_by": wt["bound_by"],
        "library_ms": wt["library_ms"], "eager_ms": wt["eager_ms"],
        "plain_eager_ms": wt["plain_eager_ms"], "fp32_ms": wt["fp32_ms"],
        "fp32_bound_ms": wt["fp32_bound_ms"],
        "sass_mma": wt["sass_mma"]}, {
        "name": "ssd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:65",
        "launches": ssd_launches, "max_abs_err": ssd_worst,
        "ms": st["ms"], "plain_ms": st["plain_ms"],
        "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
        "library_ms": st["library_ms"], "eager_ms": st["eager_ms"],
        "plain_eager_ms": st["plain_eager_ms"], "fp32_ms": st["fp32_ms"],
        "fp32_bound_ms": st["fp32_bound_ms"],
        "sass_mma": st["sass_mma"]}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
