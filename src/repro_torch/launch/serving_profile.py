"""Where one serving dispatch spends its time, on the CUDA card.

    PYTHONPATH=src python -m repro_torch.launch.serving_profile [--out F]

Builds the serving path of ``chip_smoke.py`` (``PotentialConfig()``, K=4,
``make_engine`` with the budget + re-weighting rules) and reports, each
line with the card's name and power limit:

* the steady-state host time of ``FusedEngine.score`` per bucket size;
* the stages of one dispatch at the 64-row bucket — upload, committee
  forward (vmapped forces by ``torch.func.grad``), the ``committee_uq``
  kernel, the rest (rules, packing), download — each timed alone with a
  device synchronize around it;
* the same score with ``DiversityRule`` appended (a Python loop over the
  bucket);
* a ``torch.profiler`` table of the device kernels of a few dispatches, and
  the device's busy share: kernel time per dispatch over the unprofiled
  dispatch time.

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
from repro_torch.kernels import ops
from repro_torch.launch import platform
from repro_torch.models import potential as pot

PCFG = PotentialConfig()


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


def _engine(rules=None):
    run_cfg = PALRunConfig(std_threshold=1.0, oracle_budget=0.2,
                           reweight_buckets=64)
    gen = torch.Generator().manual_seed(0)
    cparams = pot.init_committee(PCFG, gen, device="cuda")
    return acq.make_engine(run_cfg, rules=rules, committee=acq.CommitteeSpec(
        member_forces, cparams), device="cuda")


def profile(iters: int = 30):
    info = platform.describe()
    platform.set_reference_precision()
    card = info["nvidia_smi"]
    out = {"device": info, "score_ms_by_rows": {}, "stages_ms": {}}
    eng = _engine()
    for n in (1, 8, 16, 32, 64, 256, 1024, 4096):
        x = _rows(n)
        out["score_ms_by_rows"][n] = _host_ms(
            lambda: eng.score(x, advance=False), iters)
        print(f"score {n} rows (bucket {max(n, 8)}): "
              f"{out['score_ms_by_rows'][n]:.4f} ms per dispatch [{card}]")

    x = _rows(64)
    xd = torch.from_numpy(x).to(eng.device)
    preds = eng.apply(eng.cparams, xd).contiguous()
    uq = ops.committee_uq(preds, 1.0)
    stages = {
        "upload": lambda: torch.from_numpy(x).to(eng.device),
        "forward": lambda: eng.apply(eng.cparams, xd).contiguous(),
        "committee_uq": lambda: ops.committee_uq(preds, 1.0),
        "download": lambda: eng._to_host(*uq),
        "score_total": lambda: eng.score(x, advance=False),
    }
    for name, fn in stages.items():
        out["stages_ms"][name] = _host_ms(fn, iters)
    parts = ("upload", "forward", "committee_uq", "download")
    out["stages_ms"]["rules_and_rest"] = out["stages_ms"]["score_total"] \
        - sum(out["stages_ms"][p] for p in parts)
    print("one 64-row dispatch, host ms per stage (synchronized): "
          + ", ".join(f"{k} {v:.4f}" for k, v in out["stages_ms"].items())
          + f" [{card}]")

    div = _engine(rules=(acq.ThresholdRule(1.0), acq.DiversityRule(0.5)))
    out["diversity_score_ms"] = _host_ms(
        lambda: div.score(x, advance=False), max(iters // 3, 3))
    print(f"score 64 rows with ThresholdRule + DiversityRule: "
          f"{out['diversity_score_ms']:.4f} ms per dispatch [{card}]")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tprofile(activities=acts) as prof:
        for _ in range(10):
            eng.score(x, advance=False)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    rows = []                           # device-side events only: kernels
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        rows.append((ev.key, ev.count, dev_us))
    rows.sort(key=lambda r: -r[2])
    busy_us = sum(r[2] for r in rows) / 10
    score_us = out["stages_ms"]["score_total"] * 1e3
    out["profile"] = {
        "dispatches": 10, "profiled_wall_us": wall_us,
        "device_busy_us_per_dispatch": busy_us,
        "kernels_per_dispatch": sum(r[1] for r in rows) / 10,
        "busy_share_of_unprofiled_dispatch": busy_us / score_us,
        "kernels": [{"name": k[:120], "count": c, "device_us": u}
                    for k, c, u in rows[:25]]}
    print(f"profiler: per 64-row dispatch {busy_us:.1f} us of device "
          f"kernels ({out['profile']['kernels_per_dispatch']:.0f} kernels), "
          f"{100 * busy_us / score_us:.2f} % of the unprofiled "
          f"{score_us:.1f} us dispatch [{card}]")
    for k, c, u in rows[:25]:
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
