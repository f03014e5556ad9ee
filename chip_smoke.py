#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's committee serving path on one CUDA card.

    PYTHONPATH=src python3 chip_smoke.py

Phases (each raises on a failed check; the script exits non-zero):

1. describe the card and build every CUDA kernel from ``src/repro_torch/
   kernels/csrc`` (one ``nvcc`` per source, all started together);
2. kernel phase: every kernel against its plain PyTorch version on the same
   CUDA tensors, over a sweep of shapes including non-finite members, and
   timed beside its plain version, its bound and the nearest one-call
   PyTorch yardstick;
3. serving phase at ``PotentialConfig()`` full width: a K=4 committee
   behind ``make_engine`` -> ``CommitteeServer`` -> ``ServingQueue``, fed
   by 4 client threads, then the same microbatches replayed through a CPU
   engine with the same weights; the kernel's launch count must equal the
   engine's dispatch count.

The last lines are one ``{"kernels": [...]}`` object, the card's name and
power limit from ``nvidia-smi``, and ``{"ok": true, "device": {...}}``.
Without CUDA it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs.pal_potential import PALRunConfig, PotentialConfig  # noqa: E402
from repro_torch.core import acquisition as acq  # noqa: E402
from repro_torch.core import committee as cmte  # noqa: E402
from repro_torch.core.buffers import OracleInputBuffer  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import committee_uq as cuq_kernel  # noqa: E402
from repro_torch.launch import platform  # noqa: E402
from repro_torch.models import potential as pot  # noqa: E402
from repro_torch.serving import CommitteeServer, QueueConfig, ServingQueue  # noqa: E402

SEED = 0
# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12           # fp32 outside the tensor cores
# the reference's own committee_uq tolerances (tests/test_committee_uq.py)
MEAN_RTOL, MEAN_ATOL = 1e-5, 1e-6
STD_RTOL, STD_ATOL = 1e-4, 1e-6
# forces and engine results, kernel path (card) vs plain path (CPU)
ENGINE_RTOL, ENGINE_ATOL = 1e-4, 1e-5
SERVE_SHAPE = (4, 64, 24)         # K, rows per microbatch, 3 * n_atoms


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


def uq_bound(K, n, d):
    """Least time for the work: each input byte read once, each output
    written once; ~6 fp32 operations per element folded plus the
    finalization, at the published peaks."""
    nbytes = K * n * d * 4 + n * d * 4 + 3 * n * 4 + n
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

    timings = {}
    for shape in (SERVE_SHAPE, (8, 65536, 24), (64, 65536, 24)):
        K, n, d = shape
        preds = _uq_inputs(K, n, d, gen, False)
        fns = {"ms": lambda: ops.committee_uq(preds, 1.0),
               "plain_ms": lambda: ref.committee_uq_ref(preds, 1.0),
               "library_ms": lambda: torch.std_mean(preds, 0, correction=1)}
        t = {k: graph_ms(f) for k, f in fns.items()}
        t.update({k.replace("ms", "eager_ms"): time_ms(f)
                  for k, f in fns.items()})
        t["bound_ms"], t["bound_by"] = uq_bound(K, n, d)
        timings[shape] = t
        print(f"committee_uq K={K} n={n} d={d}: device time per call "
              f"(CUDA graph) kernel {t['ms']:.6f} ms, plain "
              f"{t['plain_ms']:.6f} ms, torch.std_mean "
              f"{t['library_ms']:.6f} ms; eager per call kernel "
              f"{t['eager_ms']:.6f} ms, plain {t['plain_eager_ms']:.6f} ms, "
              f"torch.std_mean {t['library_eager_ms']:.6f} ms; bound "
              f"{t['bound_ms']:.6f} ms ({t['bound_by']})")
    return worst, timings[SERVE_SHAPE]


# ---------------------------------------------------------------------------
# 3. the serving path at PotentialConfig() full width
# ---------------------------------------------------------------------------

PCFG = PotentialConfig()


def member_forces(p, flat_batch):                # (n, 3A) -> (n, 3A)
    """ONE committee member's force field over a batch of flat coords —
    the apply_fn of the CommitteeSpec."""
    def one(flat):
        _, f = pot.energy_forces(p, flat.reshape(PCFG.n_atoms, 3), PCFG)
        return f.reshape(-1)
    return torch.func.vmap(one)(flat_batch)


class _Recorder:
    """Front of a CommitteeServer that keeps every microbatch the queue
    dispatched, and its result, in order (the queue's one dispatcher
    thread is the only caller)."""

    def __init__(self, server):
        self.server = server
        self.batches, self.results = [], []

    def predict(self, rows):
        out = self.server.predict(rows)
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
    for nb in (8, 16, 32, 64):                   # first use of each bucket
        engine.score(rows[:nb], advance=False)
    torch.cuda.synchronize()

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
    lat = (t_done - t_sub) * 1e3
    print(f"serving PotentialConfig() K={PCFG.committee_size} "
          f"in_dim={3 * PCFG.n_atoms}: {len(rows)} requests from "
          f"{n_clients} clients in {wall:.4f} s = {len(rows) / wall:.1f} "
          f"req/s, p50 {np.percentile(lat, 50):.3f} ms, p99 "
          f"{np.percentile(lat, 99):.3f} ms, {queue.dispatches} dispatches, "
          f"{server.routed} rows routed to the oracle buffer "
          f"[{smi}]")

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
          f"{launches} == engine dispatches {dispatches}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    info = phase_describe()
    worst, t = phase_kernels()
    launches = phase_serving(info["nvidia_smi"])
    print(json.dumps({"kernels": [{
        "name": "committee_uq", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/committee_uq.cu",
        "replaces": "src/repro/kernels/committee_uq.py:116",
        "launches": launches, "max_abs_err": worst,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "eager_ms": t["eager_ms"], "plain_eager_ms": t["plain_eager_ms"],
        "library_eager_ms": t["library_eager_ms"]}]}))
    print(info["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
