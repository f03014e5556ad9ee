"""The reference's serving-tier, budget and acquisition-rule tests, run on
the port's CPU engine through ``_port_rebind``: the reference test's own
code and assertions, with the engine, rules, committee, server and queue
names the port's (``device="cpu"``).

* tests/test_serving_tier.py — the rejection hierarchy, DRR fairness,
  per-client rate limits, the LSH answer cache, ``LatencyController`` and
  the live adaptive deadline, the atomic health snapshot, the
  supervisor's component health;
* tests/test_serving_queue.py — deadlines, request boundaries,
  backpressure, error propagation, drain on close, load shedding and the
  circuit breaker; its ordering-under-concurrency test is restated below
  with the cross-bucket tolerance (rtol 1e-6, atol 1e-6): it compares a microbatch's
  rows against per-call scores in other buckets, and PyTorch's CPU matmul
  may round a row by one ulp differently by batch size;
* tests/test_budget.py — the budget controller's convergence under drift,
  its threshold bound, and concurrent advancing scorers;
* tests/test_acquisition.py — the top-k and diversity rules against their
  host equivalents, and concurrent first scores of one bucket.

Where a reference test imports a class inside its body (the queue's
exceptions, ``Supervisor``), the reference module's attribute is pointed
at the port's class for the test's duration.  The reference's engine
factories take ``impl=``; the port has one CPU path, so a test that builds
one engine per implementation builds the same port engine twice.
"""
import functools
import threading
import types

import numpy as np
import pytest
import torch

import repro.core.supervisor as jsupervisor
import repro.serving.queue as jqueue
import test_acquisition
import test_budget
import test_serving_queue
import test_serving_tier
from _port_rebind import rebind
from repro_torch.core import acquisition as tacq
from repro_torch.core import budget as tbud
from repro_torch.core import committee as tcmte
from repro_torch.core import selection as tsel
from repro_torch.core import supervisor as tsupervisor
from repro_torch.core.buffers import OracleInputBuffer
from repro_torch.serving import cache as tcache
from repro_torch.serving import engine as tengine
from repro_torch.serving import queue as tqueue

K, IN_DIM, OUT_DIM = 5, 6, 3
# a row scored in another bucket: sums of O(1) terms, one ulp apart
ULP = dict(rtol=1e-6, atol=1e-6)


def _committee(seed=0):
    """The reference tests' linear ``_committee`` (same numpy draws), as a
    port committee."""
    rng = np.random.RandomState(seed)
    members = [tcmte.params_from_numpy(
        {"w": rng.randn(IN_DIM, OUT_DIM).astype(np.float32) * 0.5}, "cpu")
        for _ in range(K)]
    return members, tcmte.stack_members(members), (lambda p, x: x @ p["w"])


def _engine(apply_fn, cparams, threshold, *, impl=None, **kw):
    return tacq.FusedEngine(apply_fn, cparams, threshold, device="cpu", **kw)


ACQ = types.SimpleNamespace(**dict(vars(tacq), FusedEngine=_engine))
JNP = types.SimpleNamespace(asarray=torch.as_tensor)
SERVING = dict(
    CommitteeServer=functools.partial(tengine.CommitteeServer, device="cpu"),
    QueueConfig=tqueue.QueueConfig, ServingQueue=tqueue.ServingQueue)
COMMON = dict(acq=ACQ, cmte=tcmte, _committee=_committee)
TIER = dict(COMMON, **SERVING, bud=tbud, jnp=JNP,
            LSHAnswerCache=tcache.LSHAnswerCache,
            CircuitOpen=tqueue.CircuitOpen,
            QueueOverloaded=tqueue.QueueOverloaded,
            RateLimited=tqueue.RateLimited,
            ServingRejected=tqueue.ServingRejected)
QUEUE = dict(COMMON, **SERVING, bud=tbud, sel=tsel,
             OracleInputBuffer=OracleInputBuffer)
BUDGET = dict(COMMON, bud=tbud, OracleInputBuffer=OracleInputBuffer)
ACQUISITION = dict(COMMON, sel=tsel)

# the reference module attributes a test body imports, and the port's
PATCH = ((jqueue, "QueueOverloaded", tqueue.QueueOverloaded),
         (jqueue, "ServingRejected", tqueue.ServingRejected),
         (jqueue, "CircuitOpen", tqueue.CircuitOpen),
         (jsupervisor, "Supervisor", tsupervisor.Supervisor))


def _cases(module, names, tests):
    out = []
    for t in tests:
        name, args = (t, ()) if isinstance(t, str) else (t[0], t[1:])
        out.append(pytest.param(module, name, args, names,
                                id=f"{module.__name__}::{name}"
                                + (f"[{'-'.join(map(str, args))}]"
                                   if args else "")))
    return out


CASES = (
    _cases(test_serving_tier, TIER, (
        "test_rejection_hierarchy",
        "test_drr_bounds_flooding_tenant_to_its_share",
        "test_drr_single_client_degenerates_to_fifo",
        "test_drr_oversized_request_still_dispatched_alone",
        "test_rate_limit_sheds_deterministically",
        "test_rate_limit_is_per_client",
        "test_rate_limit_disabled_by_default",
        "test_cache_hit_bit_identical_to_fresh_dispatch",
        "test_cache_invalidated_on_weight_refresh",
        "test_cache_never_serves_uncertain_rows",
        "test_cache_partial_hit_dispatches_whole_request",
        "test_cache_opt_out_counts_bypass",
        "test_cache_std_gate_and_lru_depth",
        "test_cache_served_while_circuit_open",
        ("test_latency_controller_converges_within_25pct", 40.0),
        ("test_latency_controller_converges_within_25pct", 0.1),
        "test_latency_controller_respects_bounds",
        ("test_queue_adapts_effective_wait", 30.0, "down"),
        ("test_queue_adapts_effective_wait", 0.05, "up"),
        "test_health_snapshot_has_all_keys",
        "test_supervisor_reports_registered_component_health"))
    + _cases(test_serving_queue, QUEUE, (
        "test_queue_deadline_flush",
        "test_queue_request_boundaries_never_split",
        "test_queue_backpressure_bounds_backlog",
        "test_queue_propagates_dispatch_errors_to_futures",
        "test_queue_close_drains_pending_and_rejects_new",
        "test_queue_load_shedding_raises_typed_overload",
        "test_queue_circuit_breaker_opens_probes_and_closes"))
    + _cases(test_budget, BUDGET, (
        "test_budget_rule_converges_to_target_rate_under_drift",
        "test_static_threshold_drifts_where_budget_holds",
        "test_budget_threshold_bounded",
        "test_budget_rate_uses_true_n_not_bucket_padding",
        "test_advance_false_is_read_only",
        "test_concurrent_advancing_scorers_never_lose_rounds"))
    + _cases(test_acquisition, ACQUISITION, (
        [("test_top_fraction_rule_matches_host", f)
         for f in (0.0, 0.1, 0.25, 0.3, 0.5, 0.7, 0.9, 1.0)]
        + ["test_top_fraction_rule_invariant_to_bucket_padding",
           "test_diversity_rule_matches_host_filter",
           "test_diversity_rule_accurate_for_large_norm_inputs"]
        + [("test_top_fraction_rule_k_matches_host_round", n, f)
           for n, f in ((5, 0.1), (5, 0.3), (15, 0.1), (5, 0.5), (45, 0.7),
                        (75, 0.14), (90, 0.35), (100, 0.545))]
        + ["test_top_fraction_rule_exact_count_under_ties",
           "test_fused_engine_concurrent_first_score_traces_once"])))


@pytest.mark.parametrize("module,name,args,names", CASES)
def test_reference_serving_test_on_the_port(module, name, args, names,
                                            monkeypatch):
    for mod, attr, port_cls in PATCH:
        monkeypatch.setattr(mod, attr, port_cls)
    rebind(module, name, **names)(*args)


def test_queue_preserves_per_request_ordering_under_concurrency():
    """tests/test_serving_queue.py's test of the same name, with the
    cross-bucket tolerance: 8 client threads, each request's rows come
    back to their caller in submission order, equal to a per-call score."""
    eng = _engine(*_committee()[1:][::-1], 0.4)
    server = tengine.CommitteeServer(eng, None, device="cpu")
    n_threads, per_thread = 8, 12
    errs = []

    def client(tid):
        rng = np.random.RandomState(100 + tid)
        try:
            for j in range(per_thread):
                sz = 1 + (tid + j) % 3
                rows = [(rng.randn(IN_DIM)).astype(np.float32)
                        for _ in range(sz)]
                mean, uq = q.predict(rows)
                want = eng.score(rows, advance=False)
                np.testing.assert_allclose(mean, want.mean, **ULP)
                np.testing.assert_allclose(uq.scalar_std, want.scalar_std,
                                           **ULP)
                np.testing.assert_array_equal(uq.mask, want.mask)
                assert len(uq.mask) == sz
        except BaseException as e:  # noqa: BLE001
            errs.append((tid, e))

    with tqueue.ServingQueue(server, tqueue.QueueConfig(
            max_batch=16, max_wait_ms=2.0)) as q:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert not errs, errs
    assert q.dispatches < q.batched_requests
    assert q.batched_requests == n_threads * per_thread
