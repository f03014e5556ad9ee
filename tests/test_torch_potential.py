"""Port parity for the committee MLP potential: descriptors, energies and
forces of ``repro_torch.models.potential`` against ``repro.models.potential``
on the same weights — the reference's ``init_committee`` carried across by
``repro_torch.core.committee.params_from_numpy`` — at a small config and at
the paper's full-width ``PotentialConfig()``.  Forces must also come out the
same inside ``torch.no_grad()`` and ``torch.inference_mode()``.

Tolerance for descriptors, energies and forces: rtol 1e-4, atol 1e-5
(fp32, different summation orders in the two frameworks)."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.pal_potential import PotentialConfig as JPotentialConfig
from repro.models import potential as jpot
from repro_torch.configs.pal_potential import PotentialConfig
from repro_torch.core import committee as tcmte
from repro_torch.models import potential as tpot

TOL = dict(rtol=1e-4, atol=1e-5)
CONFIGS = {
    "small": dict(n_atoms=4, committee_size=3, hidden=(16, 16), n_rbf=8),
    "full": {},                     # PotentialConfig(): 8 atoms, K=4, 128x128
}


def _setup(name, seed=0, batch=3):
    jcfg = JPotentialConfig(**CONFIGS[name])
    tcfg = PotentialConfig(**CONFIGS[name])
    jparams = jax.jit(jpot.init_committee, static_argnums=0)(
        jcfg, jax.random.PRNGKey(seed))
    tparams = tcmte.params_from_numpy(jparams, "cpu")
    rng = np.random.RandomState(seed + 1)
    lattice = np.stack(np.meshgrid([0, 1.3], [0, 1.3], [0, 1.3]),
                       -1).reshape(-1, 3)[:jcfg.n_atoms]
    coords = (lattice[None] + rng.randn(batch, jcfg.n_atoms, 3) * 0.1) \
        .astype(np.float32)
    return jcfg, tcfg, jparams, tparams, coords


def test_config_copy_matches_reference():
    import dataclasses

    from repro.configs.pal_potential import PALRunConfig as JRun
    from repro_torch.configs.pal_potential import PALRunConfig

    assert dataclasses.asdict(PotentialConfig()) == \
        dataclasses.asdict(JPotentialConfig())
    assert dataclasses.asdict(PALRunConfig()) == dataclasses.asdict(JRun())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_params_from_numpy_keeps_keys_shapes_dtypes(name):
    _, tcfg, jparams, tparams, _ = _setup(name)
    assert sorted(tparams) == sorted(jparams)
    for k in jparams:
        assert tuple(tparams[k].shape) == jparams[k].shape
        assert tparams[k].dtype == torch.float32
        np.testing.assert_array_equal(tparams[k].numpy(),
                                      np.asarray(jparams[k]))
    # the port's own init draws the same tree (fan-in scaled normal / zeros)
    own = tpot.init_committee(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in tparams.items()}
    assert (own["b0"] == 0).all()
    w0 = own["w0"].numpy()
    assert abs(w0.std() * np.sqrt(tcfg.n_rbf) - 1.0) < 0.2   # fan-in scale


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_descriptors_match_reference(name):
    jcfg, tcfg, _, _, coords = _setup(name)
    desc = jax.jit(jpot.descriptors, static_argnums=1)
    for c in coords:
        want = np.asarray(desc(jnp.asarray(c), jcfg))
        got = tpot.descriptors(torch.from_numpy(c), tcfg).numpy()
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_energy_forces_match_reference(name):
    jcfg, tcfg, jparams, tparams, coords = _setup(name)
    jp0 = jax.tree.map(lambda a: a[0], jparams)
    tp0 = tcmte.member(tparams, 0)
    ef = jax.jit(jpot.energy_forces, static_argnums=2)
    for c in coords:
        e_j, f_j = ef(jp0, jnp.asarray(c), jcfg)
        e_t, f_t = tpot.energy_forces(tp0, torch.from_numpy(c), tcfg)
        np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), **TOL)
        np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), **TOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_batched_committee_energy_forces_match_reference(name):
    jcfg, tcfg, jparams, tparams, coords = _setup(name)
    e_j, f_j = jax.jit(jpot.batched_committee_energy_forces,
                       static_argnums=2)(jparams, jnp.asarray(coords), jcfg)
    e_t, f_t = tpot.batched_committee_energy_forces(
        tparams, torch.from_numpy(coords), tcfg)
    k = jcfg.committee_size
    assert tuple(e_t.shape) == (len(coords), k)
    assert tuple(f_t.shape) == (len(coords), k, jcfg.n_atoms, 3)
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), **TOL)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), **TOL)
    # the single-configuration committee call agrees with the batched one
    e1, f1 = tpot.committee_energy_forces(tparams, torch.from_numpy(coords[0]),
                                          tcfg)
    np.testing.assert_allclose(e1.numpy(), e_t[0].numpy(), **TOL)
    np.testing.assert_allclose(f1.numpy(), f_t[0].numpy(), **TOL)


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode"])
def test_forces_unchanged_under_no_grad_and_inference_mode(mode):
    """torch.func.grad takes forces w.r.t. the coordinates whatever grad
    mode the caller is in; compared bit for bit with the default mode."""
    _, tcfg, _, tparams, coords = _setup("small")
    x = torch.from_numpy(coords)
    _, want = tpot.batched_committee_energy_forces(tparams, x, tcfg)
    ctx = torch.no_grad() if mode == "no_grad" else torch.inference_mode()
    with ctx:
        _, got = tpot.batched_committee_energy_forces(tparams, x, tcfg)
    assert torch.equal(got, want)
    assert torch.isfinite(got).all() and got.abs().sum() > 0


def test_init_defaults_to_cuda():
    """Entry points run on the card unless the caller asks for the CPU."""
    ctx = contextlib.nullcontext() if torch.cuda.is_available() \
        else pytest.raises(RuntimeError, match="CUDA is not available")
    with ctx:
        tpot.init(PotentialConfig(**CONFIGS["small"]),
                  torch.Generator().manual_seed(0))
