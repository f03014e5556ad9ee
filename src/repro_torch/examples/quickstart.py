"""PAL quickstart — the paper's workflow (photodynamics-style, §3.1) on the
port: a committee of MLP potentials drives parallel MD-like generators;
uncertain geometries go to an analytic 'DFT' oracle; the fused committee
trainer continuously refits; weights flow back to the prediction committee.
Patience policy included (§2.2).

Prediction runs on the unified acquisition engine: a ``CommitteeSpec``
hands PAL the per-member forward + stacked params, and the committee
forward, uncertainty statistics (the ``committee_uq`` kernel on the card)
and selection rules run as ONE program per exchange iteration — on the
card one replay of the bucket's captured CUDA graph.

Training is the same story: ``loss_fn=`` turns on the shared
``training/committee_trainer.CommitteeTrainer`` — all K members advance in
one step program (one graph replay on the card) on per-member bootstrap
minibatches drawn from a device-resident replay ring, and refreshed
weights are copied into the engine device-to-device (no packed host round
trip).

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--timeout 45]
  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

``--device`` defaults to the CUDA card (and fails without one).
"""
from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from repro_torch.configs.pal_potential import PALRunConfig, PotentialConfig
from repro_torch.core import PAL, CommitteeSpec, UserGene, UserOracle
from repro_torch.core import committee as cmte
from repro_torch.launch.platform import resolve_device
from repro_torch.models import potential as pot

PCFG = PotentialConfig(n_atoms=6, committee_size=4, hidden=(64, 64), n_rbf=24)


def lattice(n_atoms: int = PCFG.n_atoms) -> np.ndarray:
    """The 2x2x2 lattice at 1.3 spacing, first ``n_atoms`` sites."""
    return np.stack(np.meshgrid([0, 1.3], [0, 1.3], [0, 1.3]),
                    -1).reshape(-1, 3)[:n_atoms]


class MDGenerator(UserGene):
    """One MD trajectory: Euler steps on committee-mean forces; restarts to
    the last trusted geometry when the controller flags high uncertainty
    past patience (it then receives data_to_gene=None).  ``max_steps``
    proposals, then the generator's stop criterion."""

    def __init__(self, rank, result_dir, n_atoms: int = PCFG.n_atoms,
                 max_steps: int = 200_000):
        super().__init__(rank, result_dir)
        rng = np.random.RandomState(rank)
        self.n_atoms = n_atoms
        self.max_steps = max_steps
        self.x0 = (lattice(n_atoms) + rng.randn(n_atoms, 3) * 0.05).astype(
            np.float32)
        self.x = self.x0.copy()
        self.rng = rng
        self.steps = 0
        self.restarts = 0

    def generate_new_data(self, data_to_gene):
        self.steps += 1
        if self.steps > self.max_steps:     # default: timeout-bounded
            return True, self.x.reshape(-1)
        if data_to_gene is None and self.steps > 1:
            self.x = self.x0.copy()              # patience exceeded: restart
            self.restarts += 1
        elif data_to_gene is not None:
            forces = np.clip(data_to_gene.reshape(self.n_atoms, 3), -20, 20)
            self.x = self.x + 0.002 * forces \
                + self.rng.randn(*self.x.shape).astype(np.float32) * 0.01
        return False, self.x.reshape(-1).astype(np.float32)


class LJOracle(UserOracle):
    """Analytic Lennard-Jones cluster = the 'DFT' ground truth stand-in,
    ``models/potential.lj_energy_forces`` on ``device``."""

    def __init__(self, rank, result_dir, device="cpu"):
        super().__init__(rank, result_dir)
        self.device = torch.device(device)

    def run_calc(self, input_for_orcl):
        coords = torch.from_numpy(np.asarray(
            input_for_orcl, np.float32).reshape(-1, 3)).to(self.device)
        _, f = pot.lj_energy_forces(coords)
        return input_for_orcl, f.reshape(-1).cpu().numpy()


def member_forces(p, flat_batch):                # (n, 3A) -> (n, 3A)
    """ONE committee member's force field over a batch of flat coords —
    the apply_fn of the CommitteeSpec AND the forward inside the loss."""
    def one(flat):
        _, f = pot.energy_forces(p, flat.reshape(PCFG.n_atoms, 3), PCFG)
        return f.reshape(-1)
    return torch.func.vmap(one)(flat_batch)


def member_force_loss(p, batch):
    """Per-member training loss for the fused committee trainer: MSE on
    oracle forces over the minibatch ``{"x": coords, "y": forces}``."""
    pred = member_forces(p, batch["x"])
    return torch.mean((pred - batch["y"]) ** 2), {}


def make_committee_spec(n_members: int, seed_offset: int = 0
                        ) -> CommitteeSpec:
    """Fused-engine committee on the CPU (PAL copies it to its device):
    member i drawn from a generator seeded ``i + seed_offset``."""
    cparams = cmte.stack_members([
        pot.init(PCFG, torch.Generator().manual_seed(i + seed_offset),
                 device="cpu")
        for i in range(n_members)])
    return CommitteeSpec(member_forces, cparams)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--timeout", type=float, default=45.0,
                    help="run budget in seconds")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch path; default: the "
                         "CUDA card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = PALRunConfig(
        result_dir=tempfile.mkdtemp(prefix="pal_quickstart_"),
        gene_process=8, orcl_process=4, pred_process=4, ml_process=4,
        retrain_size=16, std_threshold=0.25, patience=5,
        weight_sync_every=1, checkpoint_every=10.0,
        train_steps=400, train_batch=64, train_lr=1e-3)
    pal = PAL(cfg, make_generator=MDGenerator,
              make_oracle=lambda r, d: LJOracle(r, d, device=dev),
              committee=make_committee_spec(PCFG.committee_size),
              loss_fn=member_force_loss, device=dev)
    print(f"running PAL on {dev} (8 MD generators, 4-NN committee, 4 LJ "
          f"oracles, fused acquisition engine, fused committee trainer)...")
    token = pal.run(timeout=args.timeout)
    rep = pal.report()
    print(f"stopped by: {token}")
    print(f"exchange iterations : {rep['counters'].get('exchange.iterations')}")
    print(f"labeled by oracle   : {rep['labeled_total']}")
    print(f"retrain rounds      : {rep['counters'].get('train.retrains')}")
    print(f"fused train steps   : {rep['train_fused_steps']}")
    print(f"device weight hands : {rep['device_weight_refreshes']} "
          f"(packed host bytes: {pal.engine.refresh_host_bytes})")
    print(f"generator restarts  : "
          f"{sum(g.restarts for g in pal.generators)}")
    print(f"AL checkpoints      : {pal.checkpointer.saves}")
    if not (rep["labeled_total"] > 0 and rep["device_weight_refreshes"] > 0
            and pal.engine.refresh_host_bytes == 0):
        raise RuntimeError(f"the quickstart did not label, retrain and "
                           f"refresh: {rep['labeled_total']} labels, "
                           f"{rep['device_weight_refreshes']} refreshes")
    print("OK")
    return rep


if __name__ == "__main__":
    main()
