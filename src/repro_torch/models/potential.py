"""The paper's own domain: committee MLP potentials on radial-basis
descriptors (PAL §3.1–3.3).

Energy model: Behler-style per-atom MLP over symmetric radial-basis features
of pairwise distances; total energy = sum of atomic energies; forces =
-grad_R E by ``torch.func.grad``, so they compose with ``torch.func.vmap``
(the committee axis and the batch axis) and come out the same inside
``torch.no_grad()`` or ``torch.inference_mode()``.

The analytic oracles (Lennard-Jones, Morse; forces by ``torch.func.grad``)
label training data, and ``potential_loss`` is the energy + force fit the
committee trainer runs: its force term differentiates through
``energy_forces``, a double backward that composes with ``torch.func.grad``
over the params and ``torch.func.vmap`` over the committee and the batch.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch.func import grad_and_value, vmap

from repro_torch.configs.pal_potential import PotentialConfig
from repro_torch.launch.platform import DeviceLike, resolve_device
from repro_torch.models.common import ParamSpec, init_params

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Descriptors
# ---------------------------------------------------------------------------


def _pair_distances(coords: torch.Tensor) -> torch.Tensor:
    """coords (A, 3) -> (A, A) distances with safe diagonal."""
    diff = coords[:, None, :] - coords[None, :, :]
    d2 = torch.sum(diff * diff, dim=-1)
    a = coords.shape[0]
    eye = torch.eye(a, dtype=coords.dtype, device=coords.device)
    d2 = d2 + eye * 1e6                 # mask self-distance out of the RBFs
    return torch.sqrt(d2 + 1e-12)


def descriptors(coords: torch.Tensor, cfg: PotentialConfig) -> torch.Tensor:
    """(A, 3) -> (A, n_rbf) summed Gaussian RBFs with cosine cutoff."""
    d = _pair_distances(coords)                       # (A, A)
    centers = torch.linspace(0.5, cfg.r_cut, cfg.n_rbf, dtype=coords.dtype,
                             device=coords.device)
    gamma = (cfg.n_rbf / cfg.r_cut) ** 2
    rbf = torch.exp(-gamma * (d[..., None] - centers) ** 2)   # (A, A, n_rbf)
    fcut = 0.5 * (torch.cos(math.pi * torch.clamp(d / cfg.r_cut, 0, 1))
                  + 1.0)
    return torch.sum(rbf * fcut[..., None], dim=1)    # (A, n_rbf)


# ---------------------------------------------------------------------------
# MLP potential
# ---------------------------------------------------------------------------


def param_specs(cfg: PotentialConfig) -> Dict[str, ParamSpec]:
    dims = (cfg.n_rbf,) + tuple(cfg.hidden) + (1,)
    s: Dict[str, ParamSpec] = {}
    for i in range(len(dims) - 1):
        s[f"w{i}"] = ParamSpec((dims[i], dims[i + 1]), (None, None))
        s[f"b{i}"] = ParamSpec((dims[i + 1],), (None,), init="zeros")
    return s


def init(cfg: PotentialConfig, generator: torch.Generator,
         device: DeviceLike = None) -> Params:
    return init_params(param_specs(cfg), generator,
                       resolve_device(device))


def init_committee(cfg: PotentialConfig, generator: torch.Generator,
                   device: DeviceLike = None) -> Params:
    """K members drawn one after another from ``generator``, stacked on a
    leading committee axis."""
    members = [init(cfg, generator, device)
               for _ in range(cfg.committee_size)]
    return {k: torch.stack([m[k] for m in members]) for k in members[0]}


def energy(params: Params, coords: torch.Tensor, cfg: PotentialConfig):
    """(A, 3) -> scalar energy."""
    h = descriptors(coords, cfg)
    n = len([k for k in params if k.startswith("w")])
    for i in range(n):
        h = h @ params[f"w{i}"] + params[f"b{i}"]
        if i < n - 1:
            h = torch.tanh(h)
    return torch.sum(h)


def energy_forces(params: Params, coords: torch.Tensor,
                  cfg: PotentialConfig):
    """(A, 3) -> (E scalar, F (A, 3)), F = -dE/dR."""
    g, e = grad_and_value(energy, argnums=1)(params, coords, cfg)
    return e, -g


def committee_energy_forces(cparams: Params, coords: torch.Tensor,
                            cfg: PotentialConfig):
    """Stacked params (K, ...) -> (E (K,), F (K, A, 3))."""
    return vmap(lambda p: energy_forces(p, coords, cfg))(cparams)


def batched_committee_energy_forces(cparams: Params, coords: torch.Tensor,
                                    cfg: PotentialConfig):
    """coords (B, A, 3) -> (E (B, K), F (B, K, A, 3))."""
    def one(c):
        return committee_energy_forces(cparams, c, cfg)
    return vmap(one)(coords)


# ---------------------------------------------------------------------------
# Analytic oracles (ground-truth stand-ins for DFT)
# ---------------------------------------------------------------------------


def lennard_jones(coords: torch.Tensor, eps: float = 1.0,
                  sigma: float = 1.0):
    d = _pair_distances(coords)
    a = coords.shape[0]
    mask = 1.0 - torch.eye(a, dtype=coords.dtype, device=coords.device)
    sr6 = (sigma / d) ** 6
    return 0.5 * torch.sum(mask * 4.0 * eps * (sr6 ** 2 - sr6))


def lj_energy_forces(coords: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    g, e = grad_and_value(lennard_jones)(coords)
    return e, -g


def morse(coords: torch.Tensor, de: float = 1.0, a: float = 1.2,
          r0: float = 1.2):
    d = _pair_distances(coords)
    n = coords.shape[0]
    mask = 1.0 - torch.eye(n, dtype=coords.dtype, device=coords.device)
    return 0.5 * torch.sum(mask * de * (1.0 - torch.exp(-a * (d - r0))) ** 2)


def morse_energy_forces(coords: torch.Tensor):
    g, e = grad_and_value(morse)(coords)
    return e, -g


# ---------------------------------------------------------------------------
# Training-side loss (energy + force matching)
# ---------------------------------------------------------------------------


def potential_loss(params: Params, batch, cfg: PotentialConfig,
                   force_weight: float = 10.0):
    """batch: {"coords": (B,A,3), "energy": (B,), "forces": (B,A,3)}."""
    def one(c):
        return energy_forces(params, c, cfg)

    e, f = vmap(one)(batch["coords"])
    e_loss = torch.mean((e - batch["energy"]) ** 2)
    f_loss = torch.mean((f - batch["forces"]) ** 2)
    return e_loss + force_weight * f_loss, {"e_mse": e_loss, "f_mse": f_loss}
