"""PAL end to end on the port: ML-potential active learning for cluster MD
(paper §3.2/§3.3 analog) WITH accuracy validation.

Protocol:
  1. run PAL on LJ-cluster MD with a committee potential until the oracle
     has labeled a target number of geometries;
  2. freeze the committee and evaluate force-MAE on a held-out test set of
     trajectory geometries;
  3. compare against a RANDOM-selection baseline that labels the same
     number of geometries without uncertainty-driven selection — the AL
     advantage the paper's workflow exists to deliver.

``--oracle-budget F`` switches the run to FIXED-BUDGET exploration: the
static std threshold is replaced by the cross-round oracle-rate controller
(core/budget.BudgetRule via ``PALRunConfig.oracle_budget``), which steers
the effective threshold so that a fraction F of each exchange round's MD
proposals goes to the oracle.  The run prints the realized oracle rate and
the controller's final effective threshold next to the same MAE
validation.

  PYTHONPATH=src python -m repro_torch.examples.potential_md [--budget 160]
  PYTHONPATH=src python -m repro_torch.examples.potential_md \\
      --oracle-budget 0.2 --device cpu

Exploration runs on a device-resident fleet of ``--fleet-walkers`` (16)
MD walkers (``exploration.WalkerFleet``): each exchange round advances,
scores and selects every walker in one fused program, on the card one
captured CUDA graph replay.  ``--fleet-walkers 0`` runs the quickstart's
host ``MDGenerator``s instead.  ``--device`` defaults to the CUDA card.
"""
from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs.pal_potential import PALRunConfig
from repro_torch.core import PAL
from repro_torch.examples.quickstart import (
    LJOracle, MDGenerator, PCFG, lattice, make_committee_spec,
    member_force_loss,
)
from repro_torch.launch.platform import resolve_device
from repro_torch.models import potential as pot
from repro_torch.training import CommitteeTrainer


def lj_forces(coords: np.ndarray, device) -> np.ndarray:
    """(n, A, 3) Lennard-Jones forces of ``coords`` on ``device``."""
    c = torch.from_numpy(np.asarray(coords, np.float32)).to(device)
    _, f = torch.func.vmap(pot.lj_energy_forces)(c)
    return f.cpu().numpy()


def make_test_set(device, n_traj=16, steps=60, seed=123):
    """Held-out geometries FROM TRAJECTORIES: the domain the generators
    explore is where reliability matters (paper §2.2) — run ground-truth
    LJ dynamics with the same integrator and sample states."""
    rng = np.random.RandomState(seed)
    coords_list = []
    for t in range(n_traj):
        x = lattice() + rng.randn(PCFG.n_atoms, 3) * 0.05
        for s in range(steps):
            f = np.clip(lj_forces(x[None], device)[0], -20, 20)
            x = x + 0.002 * f + rng.randn(*x.shape) * 0.01
            if s % 10 == 9:
                coords_list.append(x.copy())
    coords = np.stack(coords_list).astype(np.float32)
    f = lj_forces(coords, device)
    # drop exploding-force outliers (atom overlap): they would dominate MAE
    keep = np.abs(f).max(axis=(1, 2)) < 50.0
    return coords[keep], f[keep]


def force_mae(cparams, coords, forces_true) -> float:
    dev = next(iter(cparams.values())).device
    _, f = pot.batched_committee_energy_forces(
        cparams, torch.from_numpy(coords).to(dev), PCFG)
    f_mean = f.mean(dim=1)
    return float((f_mean - torch.from_numpy(forces_true).to(dev)).abs()
                 .mean())


def seed_set(n: int, device, seed: int = 7):
    """Foundational near-equilibrium dataset (paper §3.3: 'We begin by
    pre-training these ML models on a foundational dataset')."""
    rng = np.random.RandomState(seed)
    coords = np.stack([lattice() + rng.randn(PCFG.n_atoms, 3)
                       * rng.uniform(0.02, 0.08) for _ in range(n)])
    labels = lj_forces(coords, device).reshape(n, -1)
    return list(zip(coords.reshape(n, -1).astype(np.float32), labels))


SEED_N = 48
WARM_STEPS = 600        # pre-training budget on the foundational set
FINAL_STEPS = 1600      # consolidation budget after the run freezes


def run_al(budget: int, device, seed: int = 0, oracle_budget: float = 0.0,
           fleet_walkers: int = 16):
    cfg = PALRunConfig(
        result_dir=tempfile.mkdtemp(prefix="pal_md_"),
        gene_process=8, orcl_process=4, pred_process=4, ml_process=4,
        retrain_size=16, std_threshold=0.3, patience=5,
        weight_sync_every=1,
        train_steps=400, train_batch=64, train_lr=1e-3,
        # device-resident exploration fleet (exploration/fleet.py): N
        # stacked MD walkers advanced + scored + selected in ONE fused
        # program per exchange iteration, with the Euler sampler matching
        # the MDGenerator update (dt=0.002, clip=20, noise=0.01) — trusted
        # restart states come from the MDGenerator lattice initializations.
        # fleet_walkers=0 falls back to the gene_process host generators.
        fleet_walkers=fleet_walkers,
        # >0: cross-round PI control of the effective threshold toward
        # oracle_budget selected-per-round (fixed labeling cost; the
        # static threshold above only seeds the controller)
        oracle_budget=oracle_budget, budget_horizon=16)
    pal = PAL(cfg, make_generator=MDGenerator,
              make_oracle=lambda r, d: LJOracle(r, d, device=device),
              committee=make_committee_spec(PCFG.committee_size),
              loss_fn=member_force_loss, device=device)
    # warm start (paper §3.3: foundational pre-training): the SHARED
    # committee trainer fits all K members on the seed set, then hands
    # weights to the engine device-to-device
    trainer = pal.committee_trainer
    trainer.add_blocks(seed_set(SEED_N, device))
    trainer.train(steps=WARM_STEPS)
    pal.engine.refresh_from_device(trainer.snapshot_cparams())
    pal.start()
    t0 = time.time()
    while pal.train_buffer.total_labeled < budget and time.time() - t0 < 240:
        time.sleep(0.2)
    pal.shutdown()

    # consolidation: the run froze mid-stream; absorb any blocks still in
    # the trainer channel and finish training the committee on its final
    # set (same step budget as the baseline)
    while pal.trainer_channels[0].poll():
        trainer.add_blocks(pal.trainer_channels[0].recv())
    trainer.train(steps=FINAL_STEPS)
    labeled = pal.train_buffer.total_labeled
    rep = pal.report()
    if oracle_budget > 0:
        # surface what the controller actually did with the budget
        state = pal.engine.state_dict()
        ctrl = state[-1] if state else {}
        rep["budget_controller"] = {
            k: float(np.asarray(v)) for k, v in dict(ctrl).items()}
    return trainer.snapshot_cparams(), labeled, rep


def run_random_baseline(budget: int, device, seed: int = 1):
    """Same TOTAL label budget (incl. the seed set), random near-equilibrium
    geometries — no uncertainty selection, no exploration guidance.  Runs
    on the SAME shared CommitteeTrainer subsystem as the AL path, so the
    comparison isolates selection, not the optimizer."""
    rng = np.random.RandomState(seed)
    coords = np.stack([lattice() + rng.randn(PCFG.n_atoms, 3)
                       * rng.uniform(0.02, 0.08)          # near-eq only:
                       for _ in range(budget)])           # no AL guidance
    labels = lj_forces(coords, device).reshape(budget, -1)
    trainer = CommitteeTrainer(
        member_force_loss,
        make_committee_spec(PCFG.committee_size, seed_offset=1000).cparams,
        batch=64, lr=1e-3, replay_capacity=2048, seed=seed, device=device)
    trainer.add_blocks(seed_set(SEED_N, device))
    trainer.add_blocks(list(zip(coords.reshape(budget, -1)
                                .astype(np.float32), labels)))
    trainer.train(steps=WARM_STEPS + FINAL_STEPS)
    return trainer.snapshot_cparams()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--budget", type=int, default=160,
                    help="total oracle-call budget (run stop criterion)")
    ap.add_argument("--oracle-budget", type=float, default=0.0,
                    help=">0: per-round selected fraction held by the "
                         "cross-round budget controller (fixed-rate "
                         "exploration instead of a static threshold)")
    ap.add_argument("--fleet-walkers", type=int, default=16,
                    help="device-resident exploration-fleet size; 0 runs "
                         "the host-generator path")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch path; default: the "
                         "CUDA card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    coords_test, forces_test = make_test_set(dev)
    print(f"label budget: {args.budget} oracle calls on {dev}"
          + (f", controlled at {args.oracle_budget:.0%}/round"
             if args.oracle_budget > 0 else ""))

    cparams_al, labeled, rep = run_al(args.budget, dev,
                                      oracle_budget=args.oracle_budget,
                                      fleet_walkers=args.fleet_walkers)
    mae_al = force_mae(cparams_al, coords_test, forces_test)
    print(f"[PAL active learning] labeled={labeled} "
          f"force MAE={mae_al:.4f}")
    if "fleet" in rep:
        fl = rep["fleet"]
        print(f"[exploration fleet ] {fl['walkers']} walkers, "
              f"{fl['steps']} fused steps, {fl['restarts']} restarts, "
              f"{fl['nan_resets']} nan resets")
    if args.oracle_budget > 0:
        ctrl = rep.get("budget_controller", {})
        print(f"[budget controller ] realized rate="
              f"{rep.get('oracle_rate') or 0:.3f} "
              f"(target {args.oracle_budget}), "
              f"effective threshold={ctrl.get('threshold', 0):.4f} "
              f"(seed 0.3), rounds={int(ctrl.get('rounds', 0))}")

    cparams_rnd = run_random_baseline(labeled or args.budget, dev)
    mae_rnd = force_mae(cparams_rnd, coords_test, forces_test)
    print(f"[random baseline   ] labeled={labeled} "
          f"force MAE={mae_rnd:.4f}")
    print(f"AL improvement: {mae_rnd / max(mae_al, 1e-9):.2f}x lower MAE")
    print(f"exchange iterations: "
          f"{rep['counters'].get('exchange.iterations')}, "
          f"retrains: {rep['counters'].get('train.retrains')}")
    return {"mae_al": mae_al, "mae_random": mae_rnd, "labeled": labeled,
            "report": rep}


if __name__ == "__main__":
    main()
