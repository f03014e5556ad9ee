"""Where one committee training step spends its time, on the CUDA card.

    PYTHONPATH=src python -m repro_torch.launch.train_profile [--out F]

Builds the training slice of ``chip_smoke.py``: a ``CommitteeTrainer`` at
``PotentialConfig()`` (8 atoms, K=4, hidden (128, 128), 32 RBFs) on the
quickstart's force loss, batch 64, lr 1e-3, a 2048-row ring of random
near-equilibrium lattice geometries labelled by the Lennard-Jones oracle
(as ``examples/potential_md.py``'s random baseline makes them).  It
reports, each line with the card's name and power limit:

* host ms per step over a round, captured (one CUDA graph replay a step)
  and eager (``capture=False``, the same program launched op by op), and
  the device ms of one replay (CUDA events around the replays alone);
* ``torch.profiler`` over a few steps, captured and eager: kernels per
  step and the device's busy share of the unprofiled step;
* the wall time of a 400-step round (the quickstart's ``train_steps``);
* refresh then first score: ``FusedEngine.refresh_from_device`` of the
  trainer's snapshot plus one 64-row captured dispatch;
* the K x policy sweep (K in {8, 32, 64} x fp32/bf16/int8 moments, the
  reference's ``benchmarks/committee_memory.py`` points): ms per captured
  step, the stacked state's buffer bytes beside ``stacked_state_nbytes``,
  and the peak device memory.

Writes the numbers as JSON to ``--out`` (default
``results/torch_train_profile.json``).  Needs CUDA.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.utils._pytree as pytree

from repro_torch.configs.pal_potential import PALRunConfig, PotentialConfig
from repro_torch.core import acquisition as acq
from repro_torch.launch import platform
from repro_torch.models import potential as pot
from repro_torch.optim.memory_policy import MemoryPolicy, stacked_state_nbytes
from repro_torch.training import CommitteeTrainer

PCFG = PotentialConfig()
BATCH, LR, CAPACITY = 64, 1e-3, 2048     # quickstart batch/lr, PALRunConfig ring
SWEEP_K = (8, 32, 64)
SWEEP_POLICIES = ("fp32", "bf16", "int8")


def member_forces(p, flat_batch):                # (n, 3A) -> (n, 3A)
    """ONE committee member's force field over a batch of flat coords —
    the engine's apply_fn and the forward inside the loss."""
    def one(flat):
        _, f = pot.energy_forces(p, flat.reshape(PCFG.n_atoms, 3), PCFG)
        return f.reshape(-1)
    return torch.func.vmap(one)(flat_batch)


def member_force_loss(p, batch):
    """The quickstart's per-member loss: MSE on oracle forces over the
    minibatch ``{"x": coords, "y": forces}``."""
    return torch.mean((member_forces(p, batch["x"]) - batch["y"]) ** 2), {}


def geometries(n: int, seed: int) -> np.ndarray:
    """(n, 3A) random near-equilibrium lattice geometries: the 2x2x2
    lattice at 1.3 spacing plus Gaussian jitter of std U(0.02, 0.08)."""
    rng = np.random.RandomState(seed)
    lattice = np.stack(np.meshgrid([0, 1.3], [0, 1.3], [0, 1.3]),
                       -1).reshape(-1, 3)[:PCFG.n_atoms]
    coords = np.stack([lattice + rng.randn(PCFG.n_atoms, 3)
                       * rng.uniform(0.02, 0.08) for _ in range(n)])
    return coords.reshape(n, -1).astype(np.float32)


def lj_labels(coords: np.ndarray, device="cuda") -> np.ndarray:
    """(n, 3A) Lennard-Jones forces of flat geometries, by the port's
    oracle on ``device``."""
    c = torch.from_numpy(coords).to(device).reshape(len(coords),
                                                    PCFG.n_atoms, 3)
    _, f = torch.func.vmap(pot.lj_energy_forces)(c)
    return f.reshape(len(coords), -1).cpu().numpy()


def committee(k: int = PCFG.committee_size, seed: int = 0):
    """K members at ``PotentialConfig()`` widths, random from a seed, on
    the CPU (each trainer and engine copies them to its device)."""
    return pot.init_committee(PotentialConfig(committee_size=k),
                              torch.Generator().manual_seed(seed),
                              device="cpu")


def make_trainer(cparams, device="cuda", policy="fp32", capture=True,
                 seed=0) -> CommitteeTrainer:
    return CommitteeTrainer(member_force_loss, cparams, batch=BATCH, lr=LR,
                            replay_capacity=CAPACITY, memory_policy=policy,
                            seed=seed, device=device, capture=capture)


def dataset(n: int = CAPACITY, seed: int = 1):
    xs = geometries(n, seed)
    return list(zip(xs, lj_labels(xs)))


def step_ms(tr: CommitteeTrainer, steps: int) -> float:
    """Host ms per step over one round of ``steps`` (the round ends with
    the metrics' one copy to the host, so the device has finished)."""
    t0 = time.perf_counter()
    tr.train(steps=steps)
    return (time.perf_counter() - t0) * 1e3 / steps


def replay_ms(tr: CommitteeTrainer, iters: int) -> float:
    """Device ms of one replay of the trainer's graph, by CUDA events on
    its stream (advances the training ``iters`` steps)."""
    with tr._state_lock, torch.cuda.stream(tr._stream):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(tr._stream)
        for _ in range(iters):
            tr._graph.replay()
        end.record(tr._stream)
        tr.graph_replays += iters
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_profile(tr: CommitteeTrainer, steps: int = 10):
    """Device kernels of ``steps`` steps by ``torch.profiler``: (rows by
    kernel, device us and kernels per step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        tr.train(steps=steps)
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        rows.append((ev.key, ev.count, dev_us))
    rows.sort(key=lambda r: -r[2])
    return (rows, sum(r[2] for r in rows) / steps,
            sum(r[1] for r in rows) / steps)


def state_nbytes(tr: CommitteeTrainer) -> int:
    return sum(t.numel() * t.element_size()
               for t in pytree.tree_leaves(tr.cstate))


def sweep(data, steps: int = 50, ks=SWEEP_K, policies=SWEEP_POLICIES):
    """The K x policy points: ms per captured step, the stacked state's
    buffer bytes and their count from shapes, peak device memory."""
    out = {}
    for k in ks:
        cp = committee(k, seed=k)
        member = {n: v[0] for n, v in cp.items()}
        for policy in policies:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            tr = make_trainer(cp, policy=policy)
            tr.add_blocks(data)
            tr.train(steps=3)                     # capture + warm replays
            ms = step_ms(tr, steps)
            out[f"K{k}_{policy}"] = {
                "k": k, "policy": policy, "ms_per_step": ms,
                "state_bytes": state_nbytes(tr),
                "stacked_state_nbytes": stacked_state_nbytes(
                    member, k, MemoryPolicy.named(policy)),
                "peak_bytes": torch.cuda.max_memory_allocated(),
                "captures": tr.captures,
                "finite": bool(np.isfinite(tr.train(steps=1)["loss"]).all()),
            }
            del tr
    return out


def refresh_then_score_ms(tr: CommitteeTrainer, engine, rows, iters=20):
    """Host ms of ``refresh_from_device(snapshot_cparams())`` plus one
    captured dispatch of ``rows`` (the score waits for its answer), warm:
    the mean of ``iters`` after one untimed handoff."""
    engine.refresh_from_device(tr.snapshot_cparams())
    engine.score(rows, advance=False)
    t0 = time.perf_counter()
    for _ in range(iters):
        engine.refresh_from_device(tr.snapshot_cparams())
        engine.score(rows, advance=False)
    return (time.perf_counter() - t0) * 1e3 / iters


def profile(steps: int = 100):
    info = platform.describe()
    platform.set_reference_precision()
    card = info["nvidia_smi"]
    out = {"device": info}
    data = dataset()
    cp = committee()
    trainers = {"captured": make_trainer(cp),
                "eager": make_trainer(cp, capture=False)}
    for mode, tr in trainers.items():
        tr.add_blocks(data)
        tr.train(steps=3)
        out[f"step_ms_{mode}"] = ms = step_ms(tr, steps)
        print(f"train step ms, {mode}: {ms:.4f} (PotentialConfig(), K=4, "
              f"batch {BATCH}, fp32, {steps} steps a round) [{card}]")
    cap = trainers["captured"]
    out["replay_device_ms"] = replay_ms(cap, steps)
    print(f"device ms per graph replay (CUDA events): "
          f"{out['replay_device_ms']:.4f} [{card}]")
    for mode, tr in trainers.items():
        rows, busy_us, kernels = kernel_profile(tr)
        step_us = out[f"step_ms_{mode}"] * 1e3
        out[f"profile_{mode}"] = {
            "steps": 10, "device_busy_us_per_step": busy_us,
            "kernels_per_step": kernels,
            "busy_share_of_unprofiled_step": busy_us / step_us,
            "kernels": [{"name": k[:120], "count": c, "device_us": u}
                        for k, c, u in rows[:25]]}
        print(f"profiler, {mode}: per step {busy_us:.1f} us of device "
              f"kernels ({kernels:.0f} kernels), {100 * busy_us / step_us:.2f}"
              f" % of the unprofiled {step_us:.1f} us step [{card}]")
        for k, c, u in rows[:12]:
            print(f"  {u / 10:9.2f} us/step  x{c // 10:<4d} {k[:100]}")
    t0 = time.perf_counter()
    cap.train(steps=400)
    out["round_400_s"] = time.perf_counter() - t0
    print(f"400-step round: {out['round_400_s']:.4f} s wall [{card}]")
    engine = acq.make_engine(PALRunConfig(std_threshold=0.3),
                             committee=acq.CommitteeSpec(member_forces, cp),
                             device="cuda")
    rows = geometries(64, 9)
    engine.score(rows, advance=False)            # the bucket's capture
    t0 = time.perf_counter()
    engine.refresh_from_device(cap.snapshot_cparams())
    engine.score(rows, advance=False)
    out["refresh_then_score_first_ms"] = (time.perf_counter() - t0) * 1e3
    out["refresh_then_score_ms"] = refresh_then_score_ms(cap, engine, rows)
    print(f"refresh_from_device + one 64-row captured dispatch: first "
          f"{out['refresh_then_score_first_ms']:.4f} ms, warm "
          f"{out['refresh_then_score_ms']:.4f} ms [{card}]")
    del trainers, cap
    out["sweep"] = sweep(data)
    for name, r in out["sweep"].items():
        print(f"sweep {name}: {r['ms_per_step']:.4f} ms per captured step, "
              f"state {r['state_bytes']} B (stacked_state_nbytes "
              f"{r['stacked_state_nbytes']}), peak "
              f"{r['peak_bytes'] / 2**20:.1f} MiB [{card}]")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="results/torch_train_profile.json")
    ap.add_argument("--steps", type=int, default=100)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_profile: CUDA is not available", file=sys.stderr)
        return 1
    out = profile(args.steps)
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1, default=str))
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
