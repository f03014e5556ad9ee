"""Where one serving dispatch spends its time, on the CUDA card.

    PYTHONPATH=src python -m repro_torch.launch.serving_profile [--out F]

Builds the serving path of ``chip_smoke.py`` (``PotentialConfig()``, K=4,
``make_engine`` with the budget + re-weighting rules) twice: as it serves,
one captured CUDA graph per shape bucket, and with ``capture=False`` (the
same program run eagerly).  It reports, each line with the card's name and
power limit:

* the steady-state host time of ``FusedEngine.score`` per bucket size,
  captured and eager;
* the device time of one graph replay per bucket (CUDA events around the
  replay alone), and the ``committee_uq`` launches each replay makes;
* the same 64-row score with ``DiversityRule`` appended (a 64-step loop
  over the bucket: captured as it stands, or launched step by step);
* ``torch.profiler`` tables of the device kernels of a few 64-row
  dispatches, captured and eager: kernels per dispatch and the device's
  busy share, kernel time per dispatch over the unprofiled dispatch time.

Writes the numbers as JSON to ``--out`` (default
``results/torch_serving_profile.json``).  Needs CUDA.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs.pal_potential import PALRunConfig, PotentialConfig
from repro_torch.core import acquisition as acq
from repro_torch.core.committee import shape_bucket
from repro_torch.launch import platform
from repro_torch.models import potential as pot

PCFG = PotentialConfig()
ROWS = (1, 8, 16, 32, 64, 256, 1024, 4096)


def member_forces(p, flat_batch):
    """One member's force field over a batch of flat coordinates."""
    def one(flat):
        _, f = pot.energy_forces(p, flat.reshape(PCFG.n_atoms, 3), PCFG)
        return f.reshape(-1)
    return torch.func.vmap(one)(flat_batch)


def _rows(n, seed=0):
    rng = np.random.RandomState(seed)
    lattice = np.stack(np.meshgrid([0, 1.3], [0, 1.3], [0, 1.3]),
                       -1).reshape(-1, 3)[:PCFG.n_atoms]
    x = lattice[None] + rng.randn(n, PCFG.n_atoms, 3) * 0.05
    return x.reshape(n, -1).astype(np.float32)


def _host_ms(fn, iters):
    """Mean host milliseconds per call of ``fn`` followed by a device
    synchronize (steady state, after two warm-up calls)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def _engine(rules=None, capture=True):
    run_cfg = PALRunConfig(std_threshold=1.0, oracle_budget=0.2,
                           reweight_buckets=64)
    gen = torch.Generator().manual_seed(0)
    cparams = pot.init_committee(PCFG, gen, device="cuda")
    return acq.make_engine(run_cfg, rules=rules, committee=acq.CommitteeSpec(
        member_forces, cparams), device="cuda", capture=capture)


def _replay_ms(eng, nb, iters):
    """Device milliseconds of one replay of bucket ``nb``'s graph (its
    inputs as the last dispatch staged them), by CUDA events on the
    engine's stream."""
    graph = eng._buckets[nb].graph
    stream = eng._stream
    with torch.cuda.stream(stream):
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        for _ in range(iters):
            graph.replay()
        end.record(stream)
    end.synchronize()
    return start.elapsed_time(end) / iters


def _kernel_profile(eng, x, dispatches=10):
    """Device kernels of ``dispatches`` 64-row dispatches by
    ``torch.profiler``: (rows by kernel, device us and kernels per
    dispatch)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with tprofile(activities=acts) as prof:
        for _ in range(dispatches):
            eng.score(x, advance=False)
        torch.cuda.synchronize()
    rows = []                           # device-side events only: kernels
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        rows.append((ev.key, ev.count, dev_us))
    rows.sort(key=lambda r: -r[2])
    busy_us = sum(r[2] for r in rows) / dispatches
    kernels = sum(r[1] for r in rows) / dispatches
    return rows, busy_us, kernels


def profile(iters: int = 30):
    info = platform.describe()
    platform.set_reference_precision()
    card = info["nvidia_smi"]
    out = {"device": info}
    engines = {"captured": _engine(), "eager": _engine(capture=False)}
    for mode, eng in engines.items():
        out[f"score_ms_by_rows_{mode}"] = ms = {}
        for n in ROWS:
            x = _rows(n)
            ms[n] = _host_ms(lambda: eng.score(x, advance=False), iters)
        print(f"score ms per dispatch, {mode}: "
              + ", ".join(f"{n} rows (bucket {shape_bucket(n)}) {v:.4f}"
                          for n, v in ms.items()) + f" [{card}]")
    graph = engines["captured"]
    out["replay_device_ms_by_bucket"] = {
        nb: _replay_ms(graph, nb, iters) for nb in sorted(graph._buckets)}
    out["committee_uq_launches_per_replay"] = {
        nb: b.launches for nb, b in sorted(graph._buckets.items())}
    print("device ms per graph replay (CUDA events): "
          + ", ".join(f"bucket {nb} {v:.4f}" for nb, v in
                      out["replay_device_ms_by_bucket"].items())
          + "; committee_uq launches per replay "
          + str(out["committee_uq_launches_per_replay"]) + f" [{card}]")

    x = _rows(64)
    rules = (acq.ThresholdRule(1.0), acq.DiversityRule(0.5))
    for mode, capture in (("captured", True), ("eager", False)):
        div = _engine(rules=rules, capture=capture)
        out[f"diversity_score_ms_{mode}"] = _host_ms(
            lambda: div.score(x, advance=False), max(iters // 3, 3))
        print(f"score 64 rows with ThresholdRule + DiversityRule, {mode}: "
              f"{out[f'diversity_score_ms_{mode}']:.4f} ms per dispatch "
              f"[{card}]")
        if capture:
            out["diversity_replay_device_ms"] = _replay_ms(div, 64, iters)
            print(f"  its graph replay: "
                  f"{out['diversity_replay_device_ms']:.4f} ms of device "
                  f"time [{card}]")

    for mode, eng in engines.items():
        rows, busy_us, kernels = _kernel_profile(eng, x)
        score_us = out[f"score_ms_by_rows_{mode}"][64] * 1e3
        out[f"profile_{mode}"] = {
            "dispatches": 10, "device_busy_us_per_dispatch": busy_us,
            "kernels_per_dispatch": kernels,
            "busy_share_of_unprofiled_dispatch": busy_us / score_us,
            "kernels": [{"name": k[:120], "count": c, "device_us": u}
                        for k, c, u in rows[:25]]}
        print(f"profiler, {mode}: per 64-row dispatch {busy_us:.1f} us of "
              f"device kernels ({kernels:.0f} kernels), "
              f"{100 * busy_us / score_us:.2f} % of the unprofiled "
              f"{score_us:.1f} us dispatch [{card}]")
        for k, c, u in rows[:12]:
            print(f"  {u / 10:9.2f} us/dispatch  x{c // 10:<4d} {k[:100]}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="results/torch_serving_profile.json")
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("serving_profile: CUDA is not available", file=sys.stderr)
        return 1
    out = profile(args.iters)
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1, default=str))
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
