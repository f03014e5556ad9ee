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
   graph replay);
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
   activations;
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
   that the decode steps drop tokens), as phase 6.

Each phase prints its wall time.

The last lines are one ``{"kernels": [...]}`` object, the card's name and
power limit from ``nvidia-smi``, and ``{"ok": true, "device": {...}}``.
Without CUDA it exits non-zero and prints no result.
"""
from __future__ import annotations

import ctypes
import gc
import json
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
from repro_torch.launch import platform  # noqa: E402
from repro_torch.launch import train_profile  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import potential as pot  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    CommitteeServer, QueueConfig, ServeEngine, ServingQueue,
)

SEED = 0
# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12           # fp32 outside the tensor cores
PEAK_BF16_PER_S = 989e12          # bf16 tensor cores, dense
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
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_PER_S
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


def _runtime_pal(tmp, chaos=None, resume=False):
    from repro_torch.core import PAL
    from repro_torch.examples import quickstart

    return PAL(
        _runtime_cfg(tmp),
        make_generator=lambda r, d: quickstart.MDGenerator(
            r, d, n_atoms=PCFG.n_atoms, max_steps=RUNTIME_STEPS),
        make_oracle=lambda r, d: quickstart.LJOracle(r, d, device="cuda"),
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
    rep = pal.report()
    c = rep["counters"]
    bad = {k: c.get(k, 0) for k in ("runtime.thread_crashes",
                                    "supervisor.escalations",
                                    "runtime.unjoined_threads")}
    return rep, c, bad, t0, t1


def _oracle_alone_and_queued(tr, rows, n=20):
    """Host ms per LJ label on the card's default stream: alone, and while
    another thread runs a 400-step round on the trainer's own stream (the
    label's read-back waits on the default stream only, so it should not
    wait for the round); and that round's wall ms."""
    from repro_torch.examples import quickstart

    oracle = quickstart.LJOracle(0, "", device="cuda")
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
        print(f"runtime device busy share (the union of the engine's and "
              f"the trainer's graph replays by CUDA events; the oracles' "
              f"kernels and the copies not counted) over run 1's "
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
        lone_ms, queued_ms, round_ms = _oracle_alone_and_queued(tr, probe)
        print(f"runtime oracle on the card's default stream: "
              f"{lone_ms:.4f} ms per label alone, {queued_ms:.4f} ms while "
              f"a 400-step round ({round_ms:.4f} ms wall) runs on the "
              f"trainer's stream [{smi}]")

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
    return launches, dispatches, {
        "iterations_per_s": it / wall,
        "labels_per_s": rep["labeled_total"] / wall,
        "retrains": c["train.retrains"], "round_ms": 1e3 * np.mean(rounds),
        "release_to_yield_ms": float(np.mean(yields)) if yields else None,
        "handoff_ms": 1e3 * float(np.mean(clock.handoffs)),
        "refresh_score_ms": warm_ms, "oracle_ms": 1e3 * oracle.mean,
        "oracle_alone_ms": lone_ms, "oracle_queued_ms": queued_ms,
        "busy_share": share, "mae": (mae0, mae1)}


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
    (and ``path`` when given) by the per-path counts.  Returns the worst
    abs error."""
    q, k, v, kvl = _fa_inputs(B, T, S, H, KV, D, dtype, gen, kv_len,
                              q_scale, v_scale)
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kvl)
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


def fa_bound(B, T, H, KV, D, dtype, causal, kv_len):
    """Least time for the work, in ms: q, o and the visible K/V rows moved
    once (per batch row, ``kv_len`` keys), against the scores and the AV
    product over the visible keys (causal prefill: 2*B*H*T^2*D, half of
    4*B*H*T^2*D), at the peak rate of the inputs' type."""
    esize = torch.tensor([], dtype=dtype).element_size()
    keys = sum(kv_len)                            # summed over the batch
    nbytes = esize * (2 * B * T * H * D + 2 * keys * KV * D)
    flops = (2 * B * H * T * T * D if causal else 4 * H * T * D * keys)
    peak = PEAK_BF16_PER_S if dtype == torch.bfloat16 else PEAK_FP32_PER_S
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _sdpa_inputs(q, k, v, kvl, causal):
    """The same attention for ``scaled_dot_product_attention``: heads
    second, K/V expanded to H heads, a boolean key mask for ``kv_len``."""
    G = q.shape[2] // k.shape[2]
    qs = q.transpose(1, 2).contiguous()
    ks = k.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    vs = v.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    mask = None
    if kvl is not None:
        S = k.shape[1]
        mask = (torch.arange(S, device=q.device)[None, :]
                < kvl[:, None])[:, None, None, :]
    return qs, ks, vs, mask


def _time_fa(name, B, T, S, H, KV, D, dtype, gen, causal, q_offset, kv_len,
             smi):
    q, k, v, kvl = _fa_inputs(B, T, S, H, KV, D, dtype, gen, kv_len)
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kvl)
    qs, ks, vs, mask = _sdpa_inputs(q, k, v, kvl, causal)
    kg, vg = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library():
        return sdpa(qs, ks, vs, attn_mask=mask, is_causal=causal)

    def library_gqa():                  # K/V not expanded (torch >= 2.5)
        return sdpa(qs, kg, vg, attn_mask=mask, is_causal=causal,
                    enable_gqa=True)

    # the yardsticks must compute the same function
    want = ref.attention_ref(q, k, v, **kw).float()
    fns = {"ms": lambda: ops.attention(q, k, v, **kw),
           "plain_ms": lambda: ref.attention_ref(q, k, v, **kw),
           "library_ms": library, "library_gqa_ms": library_gqa}
    for key, f in (("library_ms", library), ("library_gqa_ms", library_gqa)):
        try:
            out = f().transpose(1, 2)
        except TypeError:               # this torch has no enable_gqa
            del fns[key]
            continue
        _max_err(out.float(), want, FA_TOL[dtype], FA_TOL[dtype],
                 f"{name}: sdpa yardstick {key}")
    t = {key: graph_ms(f, calls=10, replays=10) for key, f in fns.items()}
    t.update({key.replace("ms", "eager_ms"): time_ms(f, iters=50)
              for key, f in fns.items()})
    t.setdefault("library_gqa_ms", None)
    keys = kv_len if kv_len is not None else [S] * B
    t["bound_ms"], t["bound_by"] = fa_bound(B, T, H, KV, D, dtype, causal,
                                            keys)
    p = fa_kernel.plan(B, T, S, H, KV)
    t["path"], t["splits"] = p.path, p.splits
    gqa = ("not taken by this torch" if t["library_gqa_ms"] is None
           else f"{t['library_gqa_ms']:.6f} ms")
    print(f"flash_attention {name} (B,T,S,H,KV,D)=({B},{T},{S},{H},{KV},{D}) "
          f"{dtype}, {p.path} path ({p.splits} splits): device time per "
          f"call (CUDA graph) kernel {t['ms']:.6f} ms, plain "
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
        "jamba_prefill": _time_fa("Jamba prefill", 8, 512, 512, 64, 8, 128,
                                  bf16, gen, True, 0, None, smi),
        "jamba_decode": _time_fa("Jamba decode", 8, 1, 576, 64, 8, 128,
                                 bf16, gen, False, 511,
                                 list(range(512, 576, 9)), smi),
    }
    timings["sass_mma"] = {kind: sorted(cs) for kind, cs in short.items()}
    return worst, timings


# ---------------------------------------------------------------------------
# 5. the LM serving path at llama3.2-1b full width
# ---------------------------------------------------------------------------


def teacher_forced(model, params, prompt, gen_tokens, max_seq):
    """Last-position logits (fp32) of a prefill of ``prompt`` and of one
    decode step per token of ``gen_tokens`` but the last, fed those
    tokens: the logits that chose each generated token."""
    B = prompt.shape[0]
    cache = model.init_cache(B, max_seq, device=prompt.device)
    logits, cache = model.prefill(params, prompt, cache)
    out = [logits.float()]
    for i in range(gen_tokens.shape[1] - 1):
        logits, cache = model.decode_step(params, gen_tokens[:, i:i + 1],
                                          cache, prompt.shape[1] + i)
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
    eng.generate({"tokens": prompt}, max_new_tokens=2)   # warm-up, not counted
    torch.cuda.synchronize()
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
          f"(prefill), {paths[1]} split (decode) [{smi}]")

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


def _greedy_logits(model, params, prompt, steps, max_seq):
    """Greedy prefill + ``steps`` decode steps; (tokens (B, steps+1),
    logits (B, steps+1, V) fp32) — the logits that chose each token."""
    cache = model.init_cache(prompt.shape[0], max_seq, device=prompt.device)
    logits, cache = model.prefill(params, prompt, cache)
    toks, outs = [], []
    for i in range(steps + 1):
        outs.append(logits.float())
        toks.append(torch.argmax(logits, dim=-1).to(torch.int32))
        if i == steps:
            break
        logits, cache = model.decode_step(params, toks[-1][:, None], cache,
                                          prompt.shape[1] + i)
    return torch.stack(toks, dim=1), torch.stack(outs, dim=1)


def two_layers(arch):
    """``arch`` at full width cut to 2 layers, in fp32."""
    return get_arch(arch).model.replace(num_layers=2, dtype="float32")


class _DropCounter:
    """Counts the MoE choices dropped past their expert's capacity, by
    wrapping ``moe.route`` (each count syncs the host)."""

    def __init__(self):
        self.dropped, self.chosen = 0, 0
        self._route = moe_mod.route

    def __enter__(self):
        def route(*args, **kw):
            r = self._route(*args, **kw)
            self.dropped += r.dropped
            self.chosen += int(r.sel.sum())
            return r

        moe_mod.route = route
        return self

    def __exit__(self, *exc):
        moe_mod.route = self._route


def phase_card_vs_cpu(name, cfg, kernels):
    """``cfg`` (an fp32 cut of ``name``): greedy prefill + 8 decode steps
    on the card against the CPU plain path, teacher-forced with the card's
    tokens.  ``kernels``: the wrapper modules whose launch counters the CPU
    path must leave alone.  A model with MoE layers must drop the same
    choices on both."""
    B, P, steps = 2, 128, 8
    max_seq = P + steps + 1
    model = model_zoo.build_model(cfg, max_seq=max_seq)
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED + 1),
                        device="cuda")
    prompt = torch.from_numpy(np.random.RandomState(SEED + 1).randint(
        0, cfg.vocab_size, (B, P)).astype(np.int32))
    with _DropCounter() as drops_g:
        toks_g, logits_g = _greedy_logits(model, params, prompt.to("cuda"),
                                          steps, max_seq)
    before = [k.launches for k in kernels]
    params_c = cmte.tree_map(lambda t: t.cpu(), params)
    del params
    torch.cuda.empty_cache()
    # the CPU plain path, teacher-forced with the card's tokens
    with _DropCounter() as drops_c:
        cache = model.init_cache(B, max_seq, device="cpu")
        logits, cache = model.prefill(params_c, prompt, cache)
        outs = [logits]
        for i in range(steps):
            logits, cache = model.decode_step(
                params_c, toks_g[:, i:i + 1].cpu(), cache, P + i)
            outs.append(logits)
    logits_c = torch.stack(outs, dim=1)
    if [k.launches for k in kernels] != before:
        raise AssertionError("the CPU plain path launched a kernel")
    if (drops_g.dropped, drops_g.chosen) != (drops_c.dropped, drops_c.chosen):
        raise AssertionError(f"MoE drops differ: card {drops_g.dropped} of "
                             f"{drops_g.chosen}, CPU {drops_c.dropped} of "
                             f"{drops_c.chosen}")
    err = _max_err(logits_g.cpu(), logits_c, CPU_RTOL, CPU_ATOL,
                   "card vs CPU logits")
    checked, total = _margin_tokens_agree(
        toks_g.cpu(), logits_c, CPU_ATOL + CPU_RTOL * float(
            logits_c.abs().max()), "card vs CPU tokens")
    moe_note = (f"; MoE choices dropped past capacity: {drops_c.dropped} of "
                f"{drops_c.chosen} on both" if drops_c.chosen else "")
    print(f"card vs CPU: {name} cut to {cfg.num_layers} layers, d "
          f"{cfg.d_model}, fp32, B={B} prompt {P} + {steps} decode steps: "
          f"logits match (worst |err| {err:.3e} at rtol {CPU_RTOL} atol "
          f"{CPU_ATOL}); greedy tokens identical at {checked} of {total} "
          f"positions whose margin allows{moe_note}")


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
    peak = PEAK_BF16_PER_S if dtype == torch.bfloat16 else PEAK_FP32_PER_S
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak
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
    eng.generate({"tokens": prompt}, max_new_tokens=2)   # warm-up, not counted
    torch.cuda.synchronize()
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
          f"{launches} == {L} layers x 1 prefill [{smi}]")

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
    peak = PEAK_BF16_PER_S if x.dtype == torch.bfloat16 else PEAK_FP32_PER_S
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak
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
    eng.generate({"tokens": prompt}, max_new_tokens=2)   # warm-up, not counted
    torch.cuda.synchronize()
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
          f"tiled (prefill), {fa_paths[1]} split (decode) [{smi}]")

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


def _timed(name, fn, *args):
    """Run one phase; print its wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.2f} s wall")
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
        "runtime_busy_share": rt["busy_share"]}, {
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
        "sass_mma": fa_t["sass_mma"]}, {
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
