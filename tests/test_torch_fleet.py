"""The port's exploration fleet (``repro_torch.exploration``,
``FusedEngine.score_after``, ``PAL(fleet_walkers > 0)``) on the CPU.

* The reference's own fleet tests (tests/test_exploration_fleet.py), run
  against the port through ``_port_rebind``: the test's code and
  assertions, with the engine, rules, selection, chaos, controller, PAL and
  fleet names the port's (on the CPU) and ``_committee`` a port committee
  built from the same numpy draws.  The reference parametrises some of
  them over its two CPU implementations (``xla``, ``pallas_interpret``);
  the port has one CPU path, so each runs once.
* The reference's ``WalkerFleet`` (``impl="xla"``) against the port's on
  the same weights, at ``noise=0``: 5 walkers over 40 steps, patience 3, on
  the reference test's toy committee (Euler and Langevin) and on a narrow
  ``PotentialConfig`` (4 atoms, 8 RBFs, hidden (16, 16): the RBF, MLP and
  autograd-force path of ``models/potential.py``).  Positions and selected
  rows atol 5e-5; scalar std rtol 1e-4, atol 1e-6; restarts and counts
  exact; masks exact on rows whose std is further than 1e-4 relative from
  the threshold.
* Both packages' ``PAL(fleet_walkers=4)`` stepped synchronously through
  ``pal.exchange.step()``: oracle buffers and fleet state equal (atol 5e-5
  for positions and forces).
* A reference ``PAL`` checkpoint with a fleet at ``noise=0``, resumed by
  the port's ``PAL``, continuing the same trajectory.
* The port's noise (a counter-based hash, not JAX's threefry): mean and
  std of 64 x 24 x 50 Euler increments under a zero committee within 5
  sigma of 0 and ``noise``, walkers uncorrelated, seeds distinct.
"""
import functools
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_exploration_fleet as tef
from _port_rebind import rebind
from repro.configs.pal_potential import PALRunConfig as JRunConfig
from repro.configs.pal_potential import PotentialConfig as JPotentialConfig
from repro.core import PAL as JPAL
from repro.core import acquisition as jacq
from repro.core import committee as jcmte
from repro.exploration import fleet as jfleet
from repro.models import potential as jpot
from repro_torch.configs.pal_potential import PALRunConfig, PotentialConfig
from repro_torch.core import PAL
from repro_torch.core import acquisition as tacq
from repro_torch.core import budget as tbud
from repro_torch.core import buffers as tbuf
from repro_torch.core import chaos as tchaos
from repro_torch.core import committee as tcmte
from repro_torch.core import controller as tctl
from repro_torch.core import selection as tsel
from repro_torch.exploration import fleet as tfleet
from repro_torch.models import potential as tpot

D = tef.D
POS_ATOL = 5e-5
STD_TOL = dict(rtol=1e-4, atol=1e-6)
NEAR = 1e-4                    # relative distance from the threshold


# ---------------------------------------------------------------------------
# the reference's fleet tests on the port
# ---------------------------------------------------------------------------

def _members_np(seed=0, k=4, scale=0.03):
    """The reference test's ``_committee`` draws, as numpy."""
    rng = np.random.RandomState(seed)
    return [{"w": (-0.05 * np.eye(D) + scale * rng.randn(D, D))
             .astype(np.float32),
             "b": (scale * rng.randn(D)).astype(np.float32)}
            for _ in range(k)]


def _committee(seed=0, k=4, scale=0.03):
    """The reference test's ``_committee`` as a port committee."""
    members = [tcmte.params_from_numpy(m, "cpu")
               for m in _members_np(seed, k, scale)]
    return tcmte.stack_members(members), (lambda p, x: x @ p["w"] + p["b"])


def _engine(apply_fn, cparams, threshold, *, impl=None, **kw):
    return tacq.FusedEngine(apply_fn, cparams, threshold, device="cpu", **kw)


ACQ = types.SimpleNamespace(**dict(vars(tacq), FusedEngine=_engine))
JNP = types.SimpleNamespace(
    zeros=lambda n, dtype: torch.zeros(n, dtype=dtype),
    asarray=torch.as_tensor, int32=torch.int32)
NAMES = dict(
    acq=ACQ, jnp=JNP, bud=tbud, cmte=tcmte, sel=tsel,
    PAL=functools.partial(PAL, device="cpu"), PALRunConfig=PALRunConfig,
    OracleInputBuffer=tbuf.OracleInputBuffer,
    ChaosInjector=tchaos.ChaosInjector, FaultEvent=tchaos.FaultEvent,
    FaultPlan=tchaos.FaultPlan, Exchange=tctl.Exchange,
    ExchangeConfig=tctl.ExchangeConfig, PredictionPool=tctl.PredictionPool,
    FleetConfig=tfleet.FleetConfig, PatienceRestart=tfleet.PatienceRestart,
    WalkerFleet=tfleet.WalkerFleet, _committee=_committee)

PLAIN = (
    "test_patience_restart_matches_host_tracker",
    "test_fleet_zero_host_bytes_for_unselected_walkers",
    "test_score_after_keeps_plain_score_cache_clean",
    "test_stop_drain_does_not_advance_rule_state",
    "test_fleet_snapshot_key_mismatch_rejected",
    "test_chaos_nan_walker_resets_not_crashes",
    "test_acceptance_plan_fleet_event_is_opt_in",
    "test_exchange_fleet_path_counters_and_stop",
    "test_legacy_gather_buffer_reused_and_timed",
    "test_stop_mid_gather_drains_earlier_proposals",
)
WITH_IMPL = (
    "test_fleet_matches_host_generator_trajectory",
    "test_fleet_selection_results_match_engine_score",
    "test_fleet_state_roundtrip_bit_identical",
)
WITH_TMP = (
    "test_pal_builds_and_checkpoints_fleet",
    "test_pal_fleet_requires_fused_engine",
)


@pytest.mark.parametrize("name", PLAIN + WITH_IMPL + WITH_TMP)
def test_reference_fleet_test_on_the_port(name, tmp_path):
    fn = rebind(tef, name, **NAMES)
    if name in WITH_IMPL:
        fn("xla")
    elif name in WITH_TMP:
        fn(tmp_path)
    else:
        fn()


# ---------------------------------------------------------------------------
# the reference's WalkerFleet against the port's
# ---------------------------------------------------------------------------

def _toy(sampler="euler"):
    members = _members_np()
    jcp = jcmte.stack_members([{k: jnp.asarray(v) for k, v in m.items()}
                               for m in members])
    x0 = np.stack([np.full(D, 0.5 + 0.15 * i, np.float32)
                   for i in range(5)])
    return (jcp, lambda p, x: x @ p["w"] + p["b"],
            tcmte.params_from_numpy(jcp, "cpu"),
            lambda p, x: x @ p["w"] + p["b"], x0, 0.012,
            dict(sampler=sampler))


NARROW = dict(n_atoms=4, committee_size=4, hidden=(16, 16), n_rbf=8)


def _narrow_potential():
    jcfg, tcfg = JPotentialConfig(**NARROW), PotentialConfig(**NARROW)
    jcp = jax.jit(jpot.init_committee, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    a = jcfg.n_atoms

    def japply(p, xb):
        return jax.vmap(lambda x: jpot.energy_forces(
            p, x.reshape(a, 3), jcfg)[1].reshape(-1))(xb)

    def tapply(p, xb):
        return torch.func.vmap(lambda x: tpot.energy_forces(
            p, x.reshape(a, 3), tcfg)[1].reshape(-1))(xb)

    rng = np.random.RandomState(3)
    lattice = np.stack(np.meshgrid([0, 1.3], [0, 1.3], [0, 1.3]),
                       -1).reshape(-1, 3)[:a]
    x0 = (lattice[None] + rng.randn(5, a, 3) * 0.05).reshape(5, -1) \
        .astype(np.float32)
    return (jcp, japply, tcmte.params_from_numpy(jcp, "cpu"), tapply, x0,
            None, {})


def _away(std, thr):
    return np.abs(std - np.float32(thr)) > NEAR * abs(thr)


CROSS = {"toy": _toy, "toy-langevin": functools.partial(_toy, "langevin"),
         "narrow-potential": _narrow_potential}


@pytest.mark.parametrize("case", sorted(CROSS))
def test_fleet_matches_the_reference_fleet(case):
    jcp, japply, tcp, tapply, x0, thr, kw = CROSS[case]()
    steps, patience = 40, 3
    if thr is None:
        # the potential's committee: a threshold inside its std range, so
        # that walkers are both selected and restarted
        probe = jacq.FusedEngine(japply, jcp, 0.0, impl="xla").score(
            list(x0))
        thr = float(np.quantile(probe.scalar_std, 0.4))
    cfg = dict(dt=tef.DT, clip=tef.CLIP, noise=0.0, patience=patience,
               **kw)
    jf = jfleet.WalkerFleet(jacq.FusedEngine(japply, jcp, thr, impl="xla"),
                            x0, jfleet.FleetConfig(**cfg))
    tf = tfleet.WalkerFleet(tacq.FusedEngine(tapply, tcp, thr,
                                             device="cpu"),
                            x0, tfleet.FleetConfig(**cfg))
    n, selected = len(x0), 0
    for step in range(steps):
        jo, to = jf.step(), tf.step()
        np.testing.assert_allclose(tf.positions(), jf.positions(),
                                   atol=POS_ATOL, rtol=0,
                                   err_msg=f"step {step}")
        jstd = np.asarray(jo.scalar_std)[:n]
        np.testing.assert_allclose(to.scalar_std.numpy()[:n], jstd,
                                   **STD_TOL)
        away = _away(jstd, thr)
        jmask = np.asarray(jo.mask)[:n]
        assert np.array_equal(to.mask.numpy()[:n][away], jmask[away])
        assert to.n_selected == jo.n_selected
        np.testing.assert_allclose(to.selected, jo.selected,
                                   atol=POS_ATOL, rtol=0)
        js, ts = jf.state_dict(), tf.state_dict()
        for k in ("counts", "restarts", "flag", "step", "nan_resets"):
            assert np.array_equal(ts[k][:n] if ts[k].ndim else ts[k],
                                  js[k][:n] if js[k].ndim else js[k]), k
        selected += to.n_selected
    assert tf.stats() == jf.stats()
    assert selected > 0 and tf.stats()["restarts"] > 0   # both exercised


# ---------------------------------------------------------------------------
# PAL with a fleet, in both packages
# ---------------------------------------------------------------------------

def _pal(pkg, tmp, **kw):
    """The reference test's ``_fleet_pal`` for either package."""
    if pkg == "jax":
        cfg = JRunConfig(**tef._fleet_cfg(tmp).__dict__)
        jcp, apply_fn = tef._committee()
        return JPAL(cfg, make_generator=tef._mk_gen,
                    make_model=lambda r, rd, d, m: tef._NullModel(),
                    make_oracle=tef._FleetOracle,
                    committee=jacq.CommitteeSpec(apply_fn, jcp), **kw)
    cfg = PALRunConfig(**tef._fleet_cfg(tmp).__dict__)
    tcp, apply_fn = _committee()
    return PAL(cfg, make_generator=tef._mk_gen,
               make_model=lambda r, rd, d, m: tef._NullModel(),
               make_oracle=tef._FleetOracle,
               committee=tacq.CommitteeSpec(apply_fn, tcp), device="cpu",
               **kw)


def _fleet_states_equal(got, want, exact_keys):
    assert sorted(got) == sorted(want)
    for k in ("x", "x0", "f", "v"):
        np.testing.assert_allclose(got[k], want[k], atol=POS_ATOL, rtol=0,
                                   err_msg=k)
    for k in exact_keys:
        assert np.array_equal(got[k], want[k]), k


EXACT = ("counts", "restarts", "flag", "step", "nan_resets")


def test_pal_fleet_exchange_steps_match_the_reference():
    jp = _pal("jax", tempfile.mkdtemp())
    tp = _pal("torch", tempfile.mkdtemp())
    assert tp.generators == [] and tp.exchange.fleet is tp.fleet
    for i in range(6):                 # fleet_max_steps=6 stops the 6th
        jt, tt = jp.exchange.step(), tp.exchange.step()
        if i < 5:
            assert jt is None and tt is None
        else:
            assert (tt.origin, tt.reason) == (jt.origin, jt.reason)
    jq, tq = jp.oracle_buffer.snapshot(), tp.oracle_buffer.snapshot()
    assert len(tq) == len(jq) > 0
    for a, b in zip(tq, jq):
        np.testing.assert_allclose(a, np.asarray(b), atol=POS_ATOL, rtol=0)
    _fleet_states_equal(tp.fleet.state_dict(), jp.fleet.state_dict(), EXACT)
    assert tp.report()["fleet"] == jp.report()["fleet"]
    jc, tc = jp.report()["counters"], tp.report()["counters"]
    for k in ("exchange.iterations", "exchange.proposals",
              "exchange.queued_to_oracle"):
        assert tc[k] == jc[k], k


def test_reference_fleet_checkpoint_resumes_in_the_port():
    tmp = tempfile.mkdtemp()
    jp = _pal("jax", tmp)
    for _ in range(4):
        jp.exchange.step()
    jp.checkpoint()
    tp = _pal("torch", tmp, resume=True)
    assert tp.monitor.count("runtime.restores") == 1
    assert tp.exchange.iteration == 4
    # every key, the reference's uint32 noise keys included, comes back
    _fleet_states_equal(tp.fleet.state_dict(), jp.fleet.state_dict(),
                        EXACT + ("key",))
    # and the same trajectory continues (noise=0: the keys draw nothing)
    for _ in range(2):
        jp.exchange.step()
        tp.exchange.step()
    _fleet_states_equal(tp.fleet.state_dict(), jp.fleet.state_dict(),
                        EXACT)
    jq, tq = jp.oracle_buffer.snapshot(), tp.oracle_buffer.snapshot()
    assert len(tq) == len(jq) > 0
    for a, b in zip(tq, jq):
        np.testing.assert_allclose(a, np.asarray(b), atol=POS_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the port's noise
# ---------------------------------------------------------------------------

NOISE = 0.01


def _increments(seed, walkers=64, dim=24, steps=50):
    """(walkers, steps * dim) Euler increments under a zero committee (no
    force, nothing selected): ``noise`` times the port's N(0, 1) draws."""
    cp = tcmte.params_from_numpy(
        {"w": np.zeros((4, dim, dim), np.float32)}, "cpu")
    eng = tacq.FusedEngine(lambda p, x: x @ p["w"], cp, 1.0, device="cpu")
    x0 = np.random.RandomState(seed).randn(walkers, dim).astype(np.float64)
    fl = tfleet.WalkerFleet(eng, x0, tfleet.FleetConfig(
        noise=NOISE, seed=seed, patience=10 ** 6))
    fl.step()                                   # the first step proposes x0
    pos = [fl.positions().astype(np.float64)]
    for _ in range(steps):
        assert fl.step().n_selected == 0
        pos.append(fl.positions().astype(np.float64))
    inc = np.diff(np.stack(pos), axis=0)        # (steps, walkers, dim)
    return inc.transpose(1, 0, 2).reshape(walkers, -1)


def test_fleet_noise_statistics():
    inc = _increments(seed=0)
    n = inc.size
    assert abs(inc.mean()) < 5 * NOISE / np.sqrt(n)
    assert abs(inc.std() - NOISE) < 5 * NOISE / np.sqrt(2 * n)
    # walkers are uncorrelated: every pair's correlation within 5 sigma
    r = np.corrcoef(inc)
    off = r[~np.eye(len(r), dtype=bool)]
    assert np.abs(off).max() < 5 / np.sqrt(inc.shape[1])
    # another seed draws another stream
    other = _increments(seed=1)
    assert not np.allclose(inc, other)
    assert abs(np.corrcoef(inc.ravel(), other.ravel())[0, 1]) < 5 / np.sqrt(n)


def test_normal_draws_are_a_function_of_the_counters():
    key = tfleet.stream_keys(7, 16)
    a = tfleet.normal_draws(key, 24)
    assert a.dtype == torch.float32 and a.shape == (16, 24)
    assert torch.equal(a, tfleet.normal_draws(key.clone(), 24))
    nxt = tfleet.next_keys(key)
    assert torch.equal(nxt[:, 0], key[:, 0])
    assert torch.equal(nxt[:, 1], key[:, 1] + 1)
    assert not torch.equal(a, tfleet.normal_draws(nxt, 24))
    # the counter wraps at 2**32, as the reference's uint32 keys would
    top = key.clone()
    top[:, 1] = 2 ** 32 - 1
    assert torch.equal(tfleet.next_keys(top)[:, 1], torch.zeros(16).long())
