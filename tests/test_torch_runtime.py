"""The port's ``PAL`` runtime on the CPU (``device="cpu"``), threaded, end
to end.

The reference's runtime tests, run against the port (``_port_rebind``: the
reference test's own code and assertions, with ``PAL`` the port's on the
CPU and the fused committee's apply, loss and members the port's torch
twins of the reference test's jnp ones):

* tests/test_pal_runtime.py — the legacy toy loop, the trainer stop,
  checkpoint and restore with the requeue of in-flight oracle work, the
  elastic oracle resize;
* the PAL half of tests/test_chaos.py — transient oracle faults, oracle
  and trainer crashes, fail-stop, escalation, NaN labels, the acceptance
  plan on the legacy loop and on the fused committee (K-1 finite members,
  every bucket program built once), autosave, restore past corrupt
  snapshots;
* the PAL half of tests/test_committee_trainer.py — the fused trainer loop
  (device handoff, 0 packed host bytes), the CommitteeSpec requirement, a
  checkpoint carrying the full TrainState;
* the PAL tests of tests/test_serving_queue.py and tests/test_budget.py —
  the serving queue and server on PAL's engine, per-stream oracle rates,
  the breaker knobs (and tests/test_serving_tier.py's, restated: the tier
  knobs and the LSH answer cache).

Added here: a reference ``PAL``'s checkpoint resumed by the port's ``PAL``
(trainer state, engine rule state, buffers and iteration equal); the
legacy-engine publish path of the fused trainer; ``PAL()`` without
``device=`` raising without CUDA; ``fleet_walkers > 0`` needing the fused
engine and replacing the host generators; a mesh of more than one process
without a process group raising at construction (the mesh itself:
``tests/test_torch_mesh_pal.py``); the quickstart twin.
"""
import functools
import pickle
import tempfile

import numpy as np
import pytest
import torch

import test_budget
import test_chaos
import test_committee_trainer
import test_pal_runtime
import test_serving_queue
from _port_rebind import rebind
from repro.configs.pal_potential import PALRunConfig as JRunConfig
from repro.core import PAL as JPAL
from repro.core import CommitteeSpec as JCommitteeSpec
from repro.core import committee as jcmte
from repro_torch.configs.pal_potential import PALRunConfig
from repro_torch.core import PAL, CommitteeSpec
from repro_torch.core import acquisition as tacq
from repro_torch.core import chaos as tchaos
from repro_torch.core import committee as tcmte
from repro_torch.examples import quickstart
from repro_torch.training.committee_trainer import (
    _host_leaves, state_dict_from_reference,
)

IN_DIM, HIDDEN, OUT_DIM = (test_committee_trainer.IN_DIM,
                           test_committee_trainer.HIDDEN,
                           test_committee_trainer.OUT_DIM)


def _apply(p, x):
    return torch.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def _loss(p, batch):
    pred = _apply(p, batch["x"])
    return torch.mean((pred - batch["y"]) ** 2), {}


def _members(seed=0, k=test_committee_trainer.K):
    """The reference test's ``_members`` (same numpy draws), as tensors."""
    rng = np.random.RandomState(seed)
    return [tcmte.params_from_numpy({
        "w1": rng.randn(IN_DIM, HIDDEN).astype(np.float32) * .3,
        "b1": rng.randn(HIDDEN).astype(np.float32) * .1,
        "w2": rng.randn(HIDDEN, OUT_DIM).astype(np.float32) * .3,
        "b2": rng.randn(OUT_DIM).astype(np.float32) * .1,
    }, "cpu") for _ in range(k)]


def _linear_committee(seed=0, k=5, in_dim=6, out_dim=3):
    """The reference serving tests' ``_committee`` (same numpy draws), as
    tensors: a linear committee ``x @ w``."""
    rng = np.random.RandomState(seed)
    members = [tcmte.params_from_numpy(
        {"w": rng.randn(in_dim, out_dim).astype(np.float32) * 0.5}, "cpu")
        for _ in range(k)]
    return members, tcmte.stack_members(members), (lambda p, x: x @ p["w"])


PORT = dict(PAL=functools.partial(PAL, device="cpu"),
            PALRunConfig=PALRunConfig)
SERVE = dict(PORT, acq=tacq, _committee=_linear_committee)
FUSED = dict(PORT, CommitteeSpec=CommitteeSpec, cmte=tcmte, _apply=_apply,
             _loss=_loss, _members=_members)
CHAOS = dict(FUSED, FaultPlan=tchaos.FaultPlan, FaultEvent=tchaos.FaultEvent)

CASES = (
    [(test_pal_runtime, n, PORT) for n in (
        "test_pal_full_async_loop", "test_pal_trainer_can_stop_workflow",
        "test_pal_checkpoint_and_restore",
        "test_pal_checkpoint_requeues_inflight_oracle_work",
        "test_pal_elastic_oracle_resize")]
    + [(test_chaos, n, CHAOS) for n in (
        "test_transient_oracle_faults_retry_in_place",
        "test_oracle_crash_restarts_worker_and_run_survives",
        "test_trainer_crash_restarts_and_training_continues",
        "test_supervise_false_reproduces_fail_stop",
        "test_escalation_after_repeated_crashes",
        "test_nan_labels_rejected_and_relabeled",
        "test_acceptance_plan_completes_without_stop_token",
        "test_fused_acceptance_quarantines_member_in_one_dispatch",
        "test_autosave_every_iters",
        "test_kill_during_autosave_restores_latest_intact_snapshot",
        "test_restore_skips_all_corrupt_snapshots_without_dying")]
    + [(test_committee_trainer, n, FUSED) for n in (
        "test_pal_fused_training_loop_end_to_end",
        "test_pal_requires_committee_for_loss_fn",
        "test_pal_checkpoint_restores_full_train_state")]
    + [(test_serving_queue, n, SERVE) for n in (
        "test_pal_builds_serve_queue_and_reports_per_stream_rates",
        "test_pal_without_queue_has_no_serve_queue",
        "test_pal_wires_breaker_knobs_and_reports_serve_health")]
    + [(test_budget, "test_pal_serve_uq_builds_server_on_shared_engine",
        SERVE)])


@pytest.mark.parametrize("module,name,names", CASES,
                         ids=[f"{m.__name__}::{n}" for m, n, _ in CASES])
def test_reference_runtime_test_on_the_port(module, name, names):
    rebind(module, name, **names)()


# ---------------------------------------------------------------------------
# a reference checkpoint resumed by the port
# ---------------------------------------------------------------------------

def _budget_cfg(cls, tmp):
    return cls(result_dir=tmp, gene_process=4, orcl_process=2,
               pred_process=1, ml_process=3, retrain_size=6,
               std_threshold=0.05, patience=3, train_steps=20,
               train_batch=8, train_lr=1e-2, train_replay_capacity=128,
               oracle_budget=0.3, reweight_buckets=8)


def _leaves_equal(a, b) -> bool:
    la, lb = _host_leaves(a), _host_leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(la, lb))


def test_reference_checkpoint_resumes_in_the_port():
    tmp = tempfile.mkdtemp()
    members = [{k: np.asarray(v) for k, v in m.items()}
               for m in test_committee_trainer._members()]
    jpal = JPAL(_budget_cfg(JRunConfig, tmp),
                make_generator=test_committee_trainer._Gene,
                make_oracle=test_committee_trainer._Oracle,
                committee=JCommitteeSpec(
                    test_committee_trainer._apply,
                    jcmte.stack_members(test_committee_trainer._members())),
                loss_fn=test_committee_trainer._loss)
    xs, ys = test_committee_trainer._data(30)
    jpal.committee_trainer.add_blocks(list(zip(xs, ys)))
    jpal.committee_trainer.train(steps=7)
    rng = np.random.RandomState(4)
    for _ in range(3):                          # advance the rule state
        jpal.engine.score([rng.randn(IN_DIM).astype(np.float32)
                           for _ in range(10)])
    jpal.oracle_buffer.put([np.full(IN_DIM, 3.0, np.float32)])
    jpal.manager.ledger.dispatch(np.full(IN_DIM, 4.0, np.float32), "oracle0")
    for x, y in zip(xs[:4], ys[:4]):
        jpal.train_buffer.add(x, y)
    jpal.exchange.iteration = 17
    jpal.checkpoint()

    pal = PAL(_budget_cfg(PALRunConfig, tmp),
              make_generator=test_committee_trainer._Gene,
              make_oracle=test_committee_trainer._Oracle,
              committee=CommitteeSpec(_apply, tcmte.stack_members(
                  [tcmte.params_from_numpy(m, "cpu") for m in members])),
              loss_fn=_loss, resume=True, device="cpu")
    assert pal.monitor.count("runtime.restores") == 1
    assert pal.exchange.iteration == 17
    want = state_dict_from_reference(jpal.committee_trainer.state_dict())
    got = pal.committee_trainer.state_dict()
    assert got["steps_done"] == want["steps_done"] == 7
    assert got["step_seq"] == want["step_seq"]
    assert _leaves_equal(got["cstate"], want["cstate"])
    assert _leaves_equal(got["replay"], want["replay"])
    jstate, tstate = jpal.engine.state_dict(), pal.engine.state_dict()
    assert len(tstate) == len(jstate) == 2
    for a, b in zip(tstate, jstate):
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_array_equal(a[key], np.asarray(b[key]))
    assert sorted(float(x[0]) for x in pal.oracle_buffer.snapshot()) == \
        [3.0, 4.0]
    assert len(pal.train_buffer) == len(jpal.train_buffer) == 4
    # the restored weights reached the engine device to device
    assert pal.engine.device_refreshes == 1
    assert pal.engine.refresh_host_bytes == 0
    for key in members[0]:
        np.testing.assert_array_equal(
            pal.engine.cparams[key].numpy(),
            np.asarray(jpal.committee_trainer.cparams[key]))


def test_fused_trainer_publishes_packed_weights_to_a_legacy_engine():
    tmp = tempfile.mkdtemp()
    cparams = tcmte.stack_members(_members())
    pal = PAL(PALRunConfig(result_dir=tmp, uq_impl="legacy", pred_process=2,
                           train_steps=3, train_batch=4),
              make_generator=test_committee_trainer._Gene,
              make_model=test_pal_runtime.ToyModel,
              make_oracle=test_committee_trainer._Oracle,
              committee=CommitteeSpec(_apply, cparams), loss_fn=_loss,
              device="cpu")
    assert pal.engine.uses_models and pal.store.n_members == 4
    pal._publish_committee()
    assert pal.store.publishes == 4
    for i in range(4):
        packed, _ = pal.store.pull_packed(i)
        np.testing.assert_array_equal(
            packed, tcmte.get_weight(tcmte.member(cparams, i)))
    state = pickle.loads(pickle.dumps(pal.engine.state_dict()))
    assert state == ()


def test_pal_wires_tier_knobs_and_reports_consistently():
    """tests/test_serving_tier.py's test of the same name (its body imports
    the reference's PAL locally, so it is restated here on the port's):
    the tier knobs reach the queue, the LSH answer cache serves a repeated
    request, and report() reads one atomic queue snapshot."""
    rng = np.random.RandomState(60)
    rows = [(rng.randn(6)).astype(np.float32) for _ in range(4)]
    _, cparams, apply_fn = _linear_committee(seed=16)
    cfg = PALRunConfig(
        result_dir=tempfile.mkdtemp(), gene_process=2, orcl_process=0,
        pred_process=1, ml_process=1, std_threshold=1e9,
        serve_uq=True, serve_max_batch=8,
        serve_rate_limit=1e6, serve_rate_burst=1e6,
        serve_latency_target_ms=5.0, serve_wait_min_ms=0.1,
        serve_wait_max_ms=20.0, serve_latency_window=16,
        serve_cache_buckets=128, serve_cache_std_max=100.0)
    pal = PAL(cfg, make_generator=test_pal_runtime.ToyGene,
              make_model=test_pal_runtime.ToyModel,
              make_oracle=test_pal_runtime.ToyOracle,
              committee=CommitteeSpec(apply_fn, cparams), device="cpu")
    try:
        qcfg = pal.serve_queue.cfg
        assert qcfg.rate_limit == 1e6 and qcfg.latency_target_ms == 5.0
        assert qcfg.wait_min_ms == 0.1 and qcfg.wait_max_ms == 20.0
        assert pal.serve_queue.cache is not None
        assert pal.serve_queue.cache.std_max == 100.0
        pal.serve_queue.submit(rows, client="tenant-a").result(timeout=10)
        pal.serve_queue.submit(rows, client="tenant-a").result(timeout=10)
        rep = pal.report()
        qh = rep["serve_queue_health"]
        assert rep["serve_queue_dispatches"] == qh["dispatches"]
        assert rep["serve_queue_batched_requests"] == qh["batched_requests"]
        assert qh["clients"]["tenant-a"]["served"] == 2
        assert qh["clients"]["tenant-a"]["cache_hits"] == 1
        assert qh["cache"]["hits"] == 4
        assert (pal.supervisor.snapshot()["components"]["serve_queue"]
                ["breaker_state"] == "closed")
        assert (rep["supervisor"]["components"]["serve_queue"]
                ["breaker_state"] == "closed")
    finally:
        pal.shutdown()


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _toy_pal(device=None, **kw):
    return PAL(PALRunConfig(result_dir=tempfile.mkdtemp(), **kw),
               make_generator=test_pal_runtime.ToyGene,
               make_model=test_pal_runtime.ToyModel,
               make_oracle=test_pal_runtime.ToyOracle, device=device)


def test_pal_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _toy_pal()


def test_fleet_and_mesh_raise_naming_their_items():
    # the fleet is ported: it needs the fused engine (a legacy toy PAL
    # raises), and with one it replaces the host generators
    with pytest.raises(ValueError, match="fused acquisition engine"):
        _toy_pal(fleet_walkers=4, device="cpu")
    _, cparams, apply_fn = _linear_committee(in_dim=4, out_dim=4)
    pal = PAL(PALRunConfig(result_dir=tempfile.mkdtemp(), fleet_walkers=4),
              make_generator=test_pal_runtime.ToyGene,
              make_model=test_pal_runtime.ToyModel,
              make_oracle=test_pal_runtime.ToyOracle,
              committee=CommitteeSpec(apply_fn, cparams), device="cpu")
    assert pal.generators == [] and pal.fleet.n_walkers == 4
    assert pal.exchange.fleet is pal.fleet
    assert pal.exchange.step() is None
    assert pal.report()["fleet"]["steps"] == 1
    # a mesh of more than one process needs a process group: without one
    # it raises at construction, naming the call that makes one
    from repro_torch.launch.mesh import Mesh

    with pytest.raises(RuntimeError, match="launch/distributed.initialize"):
        PAL(PALRunConfig(result_dir=tempfile.mkdtemp()),
            make_generator=test_pal_runtime.ToyGene,
            make_model=test_pal_runtime.ToyModel,
            make_oracle=test_pal_runtime.ToyOracle,
            mesh=Mesh(np.arange(2).reshape(2, 1), ("data", "model")),
            device="cpu")


def test_quickstart_twin_runs_on_the_cpu(capsys):
    rep = quickstart.main(["--device", "cpu", "--timeout", "8"])
    assert rep["labeled_total"] > 0 and rep["device_weight_refreshes"] > 0
    assert rep["counters"].get("runtime.thread_crashes", 0) == 0
    assert "OK" in capsys.readouterr().out
