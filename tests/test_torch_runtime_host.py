"""The port's runtime host modules against the reference, single-threaded
and without the card.

* Drift guard: each host module the port copies (transport, fault,
  supervisor, chaos, al_checkpoint, speedup, selection, api, controller,
  weight_sync, buffers, monitor) is the reference's source with its
  ``repro.`` imports rewritten to ``repro_torch.``, apart from the
  differences listed in ``INTENDED``.
* The reference's transport, buffer, selection, speedup, weight-store,
  fault-primitive, injector and supervisor tests, run against the port's
  modules (``_port_rebind.rebind``: the reference test's own code and
  assertions).
* ``LegacyEngine`` against the reference's on the same ``predict_all``:
  statistics equal (float64, degraded K included), masks exact (a row
  between ``threshold`` and ``float32(threshold)`` included), stateful rule
  state rtol 1e-5 atol 1e-7.
* ``FusedEngine.refresh_from(store)`` against the reference's: the 0/1
  return sequence and ``refresh_host_bytes`` equal, scores rtol 1e-4 atol
  1e-5, no new bucket program.
* 20 single-threaded ``Exchange.step()`` + ``Manager.step()`` rounds in
  both packages with seeded generators, the same weights and a synchronous
  oracle: oracle-buffer contents, released blocks, patience state and the
  iteration count equal.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_chaos
import test_core
import test_fault_primitives
import test_pal_runtime
from _port_rebind import rebind
from repro.core import acquisition as jacq
from repro.core import budget as jbud
from repro.core import controller as jctl
from repro.core import weight_sync as jws
from repro.core.buffers import OracleInputBuffer as JOracleInputBuffer
from repro.core.buffers import TrainingDataBuffer as JTrainingDataBuffer
from repro.core.transport import Channel as JChannel
from repro_torch.core import acquisition as tacq
from repro_torch.core import budget as tbud
from repro_torch.core import buffers as tbuf
from repro_torch.core import chaos as tchaos
from repro_torch.core import committee as tcmte
from repro_torch.core import controller as tctl
from repro_torch.core import fault as tfault
from repro_torch.core import selection as tsel
from repro_torch.core import speedup as tsp
from repro_torch.core import supervisor as tsup
from repro_torch.core import transport as ttr
from repro_torch.core import weight_sync as tws

ROOT = Path(__file__).resolve().parents[1]
STATE_TOL = dict(rtol=1e-5, atol=1e-7)
SCORE_TOL = dict(rtol=1e-4, atol=1e-5)

# ---------------------------------------------------------------------------
# drift guard
# ---------------------------------------------------------------------------

COPIED = ("transport", "fault", "supervisor", "chaos", "al_checkpoint",
          "speedup", "selection", "api", "controller", "weight_sync",
          "buffers", "monitor")
# (first, last reference line, 1-based; the port's lines in their place):
# wording about the project's history, a docstring about the reference's
# device placement, and the reference's lazy ``import jax`` that
# ``WeightStore.pull_all`` never used
INTENDED = {
    "supervisor": [
        (1, 1, ['"""Supervised execution of the PAL kernel loops.']),
        (56, 56, ["                          to a StopToken.  1 == "
                  "fail-stop."]),
        (256, 256, ["    crash escalates, reproducing fail-stop behavior "
                    "through"]),
    ],
    "chaos": [(91, 91, ['        """The acceptance plan: 3 transient oracle '
                        'failures, 1'])],
    "weight_sync": [
        (14, 15, ["copy into the engine's own buffers, zero packed host "
                  "bytes), so the",
                  "steady-state trainer->prediction hop never packs at "
                  "all."]),
        (125, 126, []),
    ],
}


@pytest.mark.parametrize("name", COPIED)
def test_copied_module_matches_the_reference(name):
    ref = (ROOT / "src" / "repro" / "core" / f"{name}.py").read_text()
    port = (ROOT / "src" / "repro_torch" / "core" / f"{name}.py").read_text()
    want = re.sub(r"\brepro\.", "repro_torch.", ref).splitlines()
    for first, last, lines in sorted(INTENDED.get(name, ()), reverse=True):
        want[first - 1:last] = lines
    assert port.splitlines() == want, \
        f"core/{name}.py drifted from the reference"
    assert port.endswith("\n")


# ---------------------------------------------------------------------------
# the reference's host tests on the port's modules
# ---------------------------------------------------------------------------

CORE_NAMES = dict(
    Channel=ttr.Channel, Communicator=ttr.Communicator,
    TransportError=ttr.TransportError, sel=tsel, sp=tsp,
    OracleInputBuffer=tbuf.OracleInputBuffer,
    RollingTrainingBuffer=tbuf.RollingTrainingBuffer,
    TrainingDataBuffer=tbuf.TrainingDataBuffer, WeightStore=tws.WeightStore)
CORE_TESTS = (
    "test_channel_isend_irecv_roundtrip", "test_channel_send_before_recv",
    "test_channel_recv_timeout",
    "test_request_test_mirrors_mpi_capitalization",
    "test_channel_cross_thread", "test_fixed_size_data_enforced",
    "test_communicator_gather_scatter_order",
    "test_recv_timeout_does_not_eat_next_message",
    "test_oracle_buffer_fifo_and_adjust",
    "test_oracle_buffer_bounded_drops_oldest",
    "test_prediction_check_selects_above_threshold",
    "test_adjust_input_for_oracle_sorts_and_prunes",
    "test_patience_tracker_restarts_after_budget",
    "test_diversity_filter_drops_near_duplicates",
    "test_weight_store_versioning",
    "test_use_case_1_balanced_dft_gnn_approaches_2",
    "test_use_case_2_training_bound_approaches_1",
    "test_use_case_3_all_balanced_is_3", "test_speedup_eq7_formula",
    "test_workload_rejects_p_greater_than_n",
)
FAULT_NAMES = dict(
    OracleInputBuffer=tbuf.OracleInputBuffer,
    TrainingDataBuffer=tbuf.TrainingDataBuffer, Manager=tctl.Manager,
    ManagerConfig=tctl.ManagerConfig,
    OracleTaskFailure=tctl.OracleTaskFailure, _payload_fp=tctl._payload_fp,
    ElasticPool=tfault.ElasticPool, Heartbeat=tfault.Heartbeat,
    TaskLedger=tfault.TaskLedger, Channel=ttr.Channel)
PAL_FAULT_NAMES = dict(
    Manager=tctl.Manager, ManagerConfig=tctl.ManagerConfig,
    OracleEndpoint=tctl.OracleEndpoint,
    OracleInputBuffer=tbuf.OracleInputBuffer,
    TrainingDataBuffer=tbuf.TrainingDataBuffer,
    ElasticPool=tfault.ElasticPool, Heartbeat=tfault.Heartbeat,
    TaskLedger=tfault.TaskLedger, Channel=ttr.Channel)
PAL_FAULT_TESTS = (
    "test_task_ledger_timeout_requeues_then_fails",
    "test_task_ledger_late_result_is_detected",
    "test_heartbeat_marks_dead_and_forgets", "test_elastic_pool_add_remove",
    "test_manager_requeues_work_from_dead_worker",
)
CHAOS_NAMES = dict(
    ChaosCrash=tchaos.ChaosCrash, ChaosFault=tchaos.ChaosFault,
    ChaosInjector=tchaos.ChaosInjector, FaultEvent=tchaos.FaultEvent,
    FaultPlan=tchaos.FaultPlan, FailurePolicy=tsup.FailurePolicy,
    Supervisor=tsup.Supervisor, Channel=ttr.Channel,
    install_chaos=ttr.install_chaos, uninstall_chaos=ttr.uninstall_chaos)
CHAOS_TESTS = (
    "test_injector_fires_deterministically_and_exactly_once",
    "test_injector_counters_survive_restarts",
    "test_injector_nan_label_and_take", "test_injector_delay_sleeps",
    "test_transport_send_chaos_site",
    "test_supervisor_restarts_crashed_loop_in_place",
    "test_supervisor_escalates_past_crash_budget",
    "test_supervisor_max_crashes_one_is_fail_stop",
    "test_supervisor_on_crash_and_should_stop",
    "test_backoff_delay_grows_and_caps",
)
FAULT_TESTS = tuple(n for n in vars(test_fault_primitives)
                    if n.startswith("test_"))
HOST_CASES = (
    [(test_core, n, CORE_NAMES) for n in CORE_TESTS]
    + [(test_fault_primitives, n, FAULT_NAMES) for n in FAULT_TESTS]
    + [(test_pal_runtime, n, PAL_FAULT_NAMES) for n in PAL_FAULT_TESTS]
    + [(test_chaos, n, CHAOS_NAMES) for n in CHAOS_TESTS])


@pytest.mark.parametrize(
    "module,name,names", HOST_CASES,
    ids=[f"{m.__name__}::{n}" for m, n, _ in HOST_CASES])
def test_reference_host_test_on_the_port(module, name, names):
    rebind(module, name, **names)()


# ---------------------------------------------------------------------------
# LegacyEngine
# ---------------------------------------------------------------------------

K, IN_DIM, OUT_DIM = 4, 6, 3
THRESHOLD = 0.1


def _preds_fn(seed=0, nan_rows=(), nan_member=2):
    """A numpy committee: member k maps x to x @ W_k (float64); members
    ``nan_member`` output NaN on rows whose first input is in
    ``nan_rows``."""
    rng = np.random.RandomState(seed)
    ws = rng.randn(K, IN_DIM, OUT_DIM) * 0.3

    def predict_all(list_data):
        x = np.stack([np.asarray(r, np.float64) for r in list_data])
        out = np.einsum("ni,kio->kno", x, ws)
        for r, row in enumerate(x):
            if row[0] in nan_rows:
                out[nan_member, r, 1] = np.nan
        return out
    return predict_all


def _gap_row():
    """Inputs for ``_gap_predict``: one row whose float64 std lies
    strictly between THRESHOLD and float32(THRESHOLD)."""
    return np.full(IN_DIM, 7.0, np.float32)


def _with_gap(predict_all):
    """Members disagree on the gap row by exactly +-c on component 0, so
    the ddof-1 std is 2c/sqrt(3): c puts it just above THRESHOLD."""
    s = THRESHOLD + 5e-10
    c = s * np.sqrt(3.0) / 2.0

    def wrapped(list_data):
        out = predict_all(list_data)
        for r, row in enumerate(list_data):
            if np.all(np.asarray(row) == 7.0):
                out[:, r, :] = 0.0
                out[:, r, 0] = [c, -c, c, -c]
        return out
    return wrapped


def _legacy_rounds(n_rounds=6, n=10, seed=3):
    rng = np.random.RandomState(seed)
    rounds = []
    for r in range(n_rounds):
        rows = [(rng.randn(IN_DIM) * (0.5 + 0.3 * r)).astype(np.float32)
                for _ in range(n)]
        rows[r % n] = rows[r % n].copy()
        rows[r % n][0] = 99.0                  # a degraded-K row
        rows.append(_gap_row())
        rounds.append(rows)
    return rounds


def _rule_pairs():
    yield "default", None, None
    yield "budget", (jbud.BudgetRule(target=0.3, thr_init=THRESHOLD),), \
        (tbud.BudgetRule(target=0.3, thr_init=THRESHOLD),)
    yield "reweight+budget", (
        jbud.RollingReweightRule(n_buckets=16),
        jbud.BudgetRule(target=0.3, thr_init=THRESHOLD)), (
        tbud.RollingReweightRule(n_buckets=16),
        tbud.BudgetRule(target=0.3, thr_init=THRESHOLD))
    yield "topfrac+diversity", (
        jacq.ThresholdRule(THRESHOLD), jacq.TopFractionRule(0.5),
        jacq.DiversityRule(0.5)), (
        tacq.ThresholdRule(THRESHOLD), tacq.TopFractionRule(0.5),
        tacq.DiversityRule(0.5))


RULE_CASES = list(_rule_pairs())


def _assert_state(t_state, j_state, what):
    for ts, js in zip(t_state, j_state):
        assert sorted(ts) == sorted(js), what
        for key in ts:
            np.testing.assert_allclose(np.asarray(ts[key], np.float64),
                                       np.asarray(js[key], np.float64),
                                       err_msg=f"{what} {key}", **STATE_TOL)


@pytest.mark.parametrize("case,jrules,trules", RULE_CASES,
                         ids=[c[0] for c in RULE_CASES])
def test_legacy_engine_matches_reference(case, jrules, trules):
    predict_all = _with_gap(_preds_fn(nan_rows=(99.0,)))
    jeng = jacq.LegacyEngine(predict_all, THRESHOLD, rules=jrules)
    teng = tacq.LegacyEngine(predict_all, THRESHOLD, rules=trules)
    assert teng.uses_models and teng.refresh_from(None) == 0
    for r, rows in enumerate(_legacy_rounds()):
        for advance in (False, True):
            want = jeng.score(rows, advance=advance)
            got = teng.score(rows, advance=advance)
            for key in ("mean", "scalar_std", "component_std"):
                a, b = getattr(got, key), getattr(want, key)
                assert a.dtype == np.float64 == b.dtype
                np.testing.assert_array_equal(a, b, err_msg=f"r{r} {key}")
            np.testing.assert_array_equal(got.finite_members,
                                          want.finite_members)
            np.testing.assert_array_equal(got.mask, want.mask,
                                          err_msg=f"round {r}")
            _assert_state(teng.state_dict(), jeng.state_dict(), f"r{r}")
        assert (got.finite_members == K - 1).sum() == 1
    assert teng.last_finite_min == jeng.last_finite_min == K - 1
    assert teng.quarantine_rounds == jeng.quarantine_rounds > 0
    if case == "default":
        gap = got.scalar_std[-1]
        assert THRESHOLD < gap < float(np.float32(THRESHOLD))
        assert got.mask[-1] and want.mask[-1]


def test_threshold_rule_follows_the_statistics_dtype():
    """fp32 statistics compare against float32(threshold) (the fused
    engine's compare, unchanged), float64 against the threshold."""
    rule = tacq.ThresholdRule(THRESHOLD)
    gap = THRESHOLD + 5e-10
    for dtype, want in ((torch.float64, True), (torch.float32, False)):
        stats = tacq.UQStats(
            x=None, mean=None, component_std=None, valid=None,
            n_valid=torch.tensor(1), scalar_std=torch.tensor([gap],
                                                             dtype=dtype))
        assert bool(rule.apply(stats, torch.ones(1, dtype=torch.bool))) \
            is want


def test_legacy_engine_from_make_engine_and_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    predict_all = _preds_fn()
    from repro_torch.configs.pal_potential import PALRunConfig

    eng = tacq.make_engine(PALRunConfig(std_threshold=THRESHOLD),
                           predict_all=predict_all)
    assert isinstance(eng, tacq.LegacyEngine) and eng.device.type == "cpu"
    with pytest.raises(ValueError, match="predict_all"):
        tacq.make_engine(PALRunConfig())
    rows = _legacy_rounds()[0]
    want = jacq.LegacyEngine(predict_all, THRESHOLD).score(rows)
    np.testing.assert_array_equal(eng.score(rows).mask, want.mask)


# ---------------------------------------------------------------------------
# FusedEngine.refresh_from(WeightStore)
# ---------------------------------------------------------------------------

N_STORE = 2                     # trainers publishing; K = 4 members read them


def _apply_t(p, x):
    return torch.tanh(x @ p["w"]) @ p["v"]


def _apply_j(p, x):
    return jnp.tanh(x @ p["w"]) @ p["v"]


def _members_np(seed, k=K):
    rng = np.random.RandomState(seed)
    return [{"w": rng.randn(IN_DIM, 8).astype(np.float32) * 0.5,
             "v": rng.randn(8, OUT_DIM).astype(np.float32) * 0.5}
            for _ in range(k)]


def _stack_np(members):
    return {k: np.stack([m[k] for m in members]) for k in members[0]}


def _packed(member):
    # sorted-key order, the wire format both packages pack
    return np.concatenate([member[k].reshape(-1) for k in sorted(member)])


def test_refresh_from_store_matches_reference():
    c0 = _stack_np(_members_np(0))
    jeng = jacq.FusedEngine(_apply_j, {k: jnp.asarray(v) for k, v in
                                       c0.items()}, 0.2, impl="xla")
    teng = tacq.FusedEngine(_apply_t, tcmte.params_from_numpy(c0, "cpu"),
                            0.2, device="cpu")
    jstore, tstore = jws.WeightStore(N_STORE), tws.WeightStore(N_STORE)
    rows = [np.random.RandomState(9).randn(IN_DIM).astype(np.float32)
            for _ in range(13)]
    teng.score(rows)
    jeng.score(rows)
    programs = dict(teng.trace_counts)
    ptrs = [t.data_ptr() for t in tcmte.tree_leaves(teng.cparams)]
    seq_j, seq_t = [], []

    def step(publish):
        for member, params in publish:
            jstore.publish_packed(member, _packed(params))
            tstore.publish_packed(member, _packed(params))
        seq_j.append(jeng.refresh_from(jstore))
        seq_t.append(teng.refresh_from(tstore))
        want, got = jeng.score(rows), teng.score(rows)
        for key in ("mean", "scalar_std", "component_std"):
            np.testing.assert_allclose(getattr(got, key), getattr(want, key),
                                       **SCORE_TOL)
        np.testing.assert_array_equal(got.mask, want.mask)
        assert teng.refresh_host_bytes == jeng.refresh_host_bytes
        assert teng.version == jeng.version

    fresh = _members_np(1, N_STORE)
    newer = _members_np(2, N_STORE)
    step([])                                   # nothing published
    step([(0, fresh[0])])                      # trainer 1 not yet
    step([(1, fresh[1])])                      # all published: refresh
    step([])                                   # same version
    step([(0, newer[0]), (1, newer[1])])       # newer: refresh
    assert seq_t == seq_j == [0, 0, 1, 0, 1]
    assert teng.refresh_host_bytes > 0
    assert teng.trace_counts == programs       # no new bucket program
    assert [t.data_ptr() for t in tcmte.tree_leaves(teng.cparams)] == ptrs
    # member i replicates trainer i % N_STORE
    for i in range(K):
        np.testing.assert_array_equal(teng.cparams["w"][i].numpy(),
                                      newer[i % N_STORE]["w"])


# ---------------------------------------------------------------------------
# Exchange + Manager, single-threaded, both packages
# ---------------------------------------------------------------------------

class _Gene:
    """A seeded random walk that restarts on ``None`` (patience)."""

    def __init__(self, rank):
        self.rng = np.random.RandomState(100 + rank)
        self.x = self.rng.randn(IN_DIM).astype(np.float32)
        self.restarts = 0

    def generate_new_data(self, data_to_gene):
        if data_to_gene is None:
            self.restarts += 1
        self.x = (self.x * 0.9 + self.rng.randn(IN_DIM) * 0.6).astype(
            np.float32)
        return False, self.x.copy()

    def save_progress(self):
        pass


def _serve_oracle(manager):
    """A synchronous oracle: every dispatched job labelled at once."""
    for ep in list(manager.endpoints.values()):
        while ep.jobs.poll():
            tid, payload = ep.jobs.recv()
            x = np.asarray(payload)
            ep.results.isend((tid, x, np.sin(2 * x[:OUT_DIM])))


def _controller(pkg, eng, buffers, channel_cls):
    obuf, tbuf_ = buffers[0](), buffers[1](retrain_size=6)
    chan = channel_cls("trainer0")
    gens = [_Gene(r) for r in range(5)]
    ex = pkg.Exchange(gens, pkg.PredictionPool([], None, engine=eng), obuf,
                      pkg.ExchangeConfig(std_threshold=0.2, patience=2,
                                         progress_save_interval=1e9))
    mgr = pkg.Manager(obuf, tbuf_, [chan], pkg.ManagerConfig(
        retrain_size=6, std_threshold=0.2),
        fresh_score=lambda items: eng.score(items, advance=False))
    for r in range(2):
        mgr.register_oracle(f"oracle{r}")
    return ex, mgr, obuf, chan


def test_exchange_and_manager_steps_match_reference():
    c0 = _stack_np(_members_np(5))
    jeng = jacq.FusedEngine(_apply_j, {k: jnp.asarray(v) for k, v in
                                       c0.items()}, 0.2, impl="xla",
                            rules=(jbud.BudgetRule(target=0.4,
                                                   thr_init=0.2),))
    teng = tacq.FusedEngine(_apply_t, tcmte.params_from_numpy(c0, "cpu"),
                            0.2, device="cpu",
                            rules=(tbud.BudgetRule(target=0.4,
                                                   thr_init=0.2),))
    jex, jmgr, jobuf, jchan = _controller(
        jctl, jeng, (JOracleInputBuffer, JTrainingDataBuffer), JChannel)
    tex, tmgr, tobuf, tchan = _controller(
        tctl, teng, (tbuf.OracleInputBuffer, tbuf.TrainingDataBuffer),
        ttr.Channel)
    released_j, released_t = [], []
    for step in range(20):
        completions = step // 5           # a retrain lands every 5 rounds
        for ex, mgr, chan, out in ((jex, jmgr, jchan, released_j),
                                   (tex, tmgr, tchan, released_t)):
            assert ex.step() is None
            mgr.step(completions)
            _serve_oracle(mgr)
            mgr.step(completions)
            while chan.poll():
                out.append(chan.recv())
        jb, tb = jobuf.snapshot(), tobuf.snapshot()
        assert len(tb) == len(jb), f"step {step}"
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(a, b)
        assert tex.patience.state_dict().keys() == \
            jex.patience.state_dict().keys()
        for key, val in jex.patience.state_dict().items():
            np.testing.assert_array_equal(tex.patience.state_dict()[key],
                                          val)
        assert [g.restarts for g in tex.generators] == \
            [g.restarts for g in jex.generators]
    assert tex.iteration == jex.iteration == 20
    assert tmgr.releases == jmgr.releases > 0
    assert len(released_t) == len(released_j)
    for bt, bj in zip(released_t, released_j):
        assert len(bt) == len(bj)
        for (xt, yt), (xj, yj) in zip(bt, bj):
            np.testing.assert_array_equal(xt, xj)
            np.testing.assert_array_equal(yt, yj)
    assert tmgr.monitor.count("manager.buffer_adjusts") == \
        jmgr.monitor.count("manager.buffer_adjusts") > 0
    _assert_state(teng.state_dict(), jeng.state_dict(), "budget")
