"""Port parity for committee serving: ``repro_torch.serving``
``CommitteeServer`` and ``ServingQueue`` on the port's CPU engine, against
the per-call predict and against the reference's ``CommitteeServer`` on the
same weights (mirrors tests/test_serving_queue.py's empty-batch and
microbatching cases).

Tolerances: served means and stds of the port vs the reference rtol 1e-4,
atol 1e-5; masks and routed rows exact; queue results vs per-call results
bit-identical in the same bucket, rtol 1e-6 across buckets (PyTorch's CPU
matmul may round a row by an ulp differently by batch size)."""
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import acquisition as jacq
from repro.core import budget as jbud
from repro.core.buffers import OracleInputBuffer as JOracleInputBuffer
from repro.serving.engine import CommitteeServer as JCommitteeServer
from repro_torch.core import acquisition as tacq
from repro_torch.core import budget as tbud
from repro_torch.core import committee as tcmte
from repro_torch.core.buffers import OracleInputBuffer
from repro_torch.serving import (
    CommitteeServer, LSHAnswerCache, QueueConfig, ServingQueue,
)

K, IN_DIM, OUT_DIM = 5, 6, 3
TOL = dict(rtol=1e-4, atol=1e-5)


def _weights(seed=0):
    rng = np.random.RandomState(seed)
    return np.stack([rng.randn(IN_DIM, OUT_DIM).astype(np.float32) * 0.5
                     for _ in range(K)])


def _apply(p, x):
    return x @ p["w"]


def _rows(n, seed=1, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(IN_DIM) * scale).astype(np.float32)
            for _ in range(n)]


def _server(threshold=0.4, rules=None, seed=0, **kw):
    eng = tacq.FusedEngine(_apply, tcmte.params_from_numpy(
        {"w": _weights(seed)}, "cpu"), threshold, rules=rules, device="cpu")
    return CommitteeServer(eng, None, device="cpu", **kw), eng


def test_committee_server_empty_predict_short_circuits():
    class _Boom:
        device = torch.device("cpu")

        def score(self, *a, **k):
            raise AssertionError("engine must not be touched")

    obuf = OracleInputBuffer()
    server = CommitteeServer(_Boom(), obuf, device="cpu")
    mean, uq = server.predict([])
    assert mean.shape == (0, 0) and uq.mask.shape == (0,)
    assert uq.scalar_std.shape == (0,) and uq.component_std.shape == (0,)
    assert server.requests == 0 and server.routed == 0 and len(obuf) == 0


def test_committee_server_empty_mean_keeps_width_and_no_round():
    server, eng = _server(
        rules=(tbud.BudgetRule(target=0.25, thr_init=0.4),))
    server.predict([])
    assert int(eng.rule_state[0]["rounds"]) == 0
    server.predict(_rows(3, seed=40))
    mean, _ = server.predict([])
    assert mean.shape == (0, OUT_DIM)
    stacked = np.vstack([server.predict(b)[0]
                         for b in (_rows(2, seed=41), [], _rows(1, seed=42))])
    assert stacked.shape == (3, OUT_DIM)
    assert int(eng.rule_state[0]["rounds"]) == 3


def test_committee_server_routes_like_reference():
    """Same weights, same budget rule, same request batches: the port's
    server routes exactly the rows the reference's server routes."""
    ws = _weights(2)
    jeng = jacq.FusedEngine(
        _apply, {"w": jnp.asarray(ws)}, 0.4, impl="xla",
        rules=(jbud.BudgetRule(target=0.3, thr_init=0.4, horizon=8),))
    jbuf = JOracleInputBuffer()
    jserver = JCommitteeServer(jeng, jbuf)
    tbuf = OracleInputBuffer()
    teng = tacq.FusedEngine(
        _apply, tcmte.params_from_numpy({"w": ws}, "cpu"), 0.4,
        rules=(tbud.BudgetRule(target=0.3, thr_init=0.4, horizon=8),),
        device="cpu")
    tserver = CommitteeServer(teng, tbuf, device="cpu")
    for b in range(8):
        batch = _rows(5 + b, seed=60 + b, scale=0.5 + 0.2 * b)
        jm, juq = jserver.predict(batch)
        tm, tuq = tserver.predict(batch)
        np.testing.assert_allclose(tm, jm, **TOL)
        np.testing.assert_allclose(tuq.scalar_std, juq.scalar_std, **TOL)
        np.testing.assert_array_equal(tuq.mask, juq.mask)
    assert tserver.routed == jserver.routed > 0
    for a, b in zip(tbuf.snapshot(), jbuf.snapshot()):
        np.testing.assert_array_equal(a, b)


def test_committee_server_refuses_engine_on_other_device():
    _, eng = _server()
    ctx = pytest.raises(RuntimeError, match="CUDA is not available") \
        if not torch.cuda.is_available() else pytest.raises(ValueError)
    with ctx:
        CommitteeServer(eng)                 # default device: the card


def test_queue_fuses_requests_and_matches_percall_results():
    server, eng = _server()
    rows = _rows(16, seed=2)
    direct = eng.score(rows, advance=False)
    with ServingQueue(server, QueueConfig(max_batch=16,
                                          max_wait_ms=200.0)) as q:
        outs = [f.result(timeout=10) for f in [q.submit([r]) for r in rows]]
    assert q.dispatches == 1 and q.batched_requests == 16
    assert server.requests == 16 and eng.dispatches == 2
    for i, (mean, uq) in enumerate(outs):
        np.testing.assert_array_equal(mean[0], direct.mean[i])
        np.testing.assert_array_equal(uq.scalar_std[0], direct.scalar_std[i])
        np.testing.assert_array_equal(uq.mask[0], direct.mask[i])


def test_queue_deadline_flush_and_unsplit_requests():
    server, _ = _server()
    with ServingQueue(server, QueueConfig(max_batch=1024,
                                          max_wait_ms=10.0)) as q:
        t0 = time.perf_counter()
        mean, uq = q.predict(_rows(3, seed=3))
        assert time.perf_counter() - t0 < 5.0    # the deadline, not a full batch
    assert mean.shape == (3, OUT_DIM) and q.dispatches == 1
    with ServingQueue(server, QueueConfig(max_batch=4,
                                          max_wait_ms=50.0)) as q:
        mean, uq = q.predict(_rows(11, seed=4))  # larger than max_batch
    assert mean.shape == (11, OUT_DIM) and q.dispatches == 1


def test_queue_preserves_per_request_ordering_under_concurrency():
    server, eng = _server()
    errs = []

    def client(tid):
        rng = np.random.RandomState(100 + tid)
        try:
            for j in range(8):
                rows = [rng.randn(IN_DIM).astype(np.float32)
                        for _ in range(1 + (tid + j) % 3)]
                mean, uq = q.predict(rows, client=f"c{tid}")
                want = eng.score(rows, advance=False)
                # scored in another bucket: PyTorch's CPU matmul may round
                # a row differently by the batch it sits in (1 ulp)
                np.testing.assert_allclose(mean, want.mean, rtol=1e-6,
                                           atol=1e-7)
                np.testing.assert_array_equal(uq.mask, want.mask)
        except BaseException as e:  # noqa: BLE001 — reported below
            errs.append((tid, e))

    with ServingQueue(server, QueueConfig(max_batch=16,
                                          max_wait_ms=2.0)) as q:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    assert q.batched_requests == 48 and q.dispatches <= 48


def test_answer_cache_hit_is_bit_identical_and_invalidates_on_refresh():
    server, eng = _server(threshold=100.0)       # everything confident
    cache = LSHAnswerCache(64, std_max=100.0)
    rows = _rows(4, seed=7)
    with ServingQueue(server, QueueConfig(max_batch=8, max_wait_ms=1.0),
                      cache=cache) as q:
        fresh = q.predict(rows)
        hit = q.predict(rows)
        assert q.cache_hit_requests == 1 and eng.dispatches == 1
        np.testing.assert_array_equal(hit[0], fresh[0])
        eng.refresh_from_device(eng.cparams)     # new weights generation
        q.predict(rows)
        assert eng.dispatches == 2 and cache.invalidations == 1
