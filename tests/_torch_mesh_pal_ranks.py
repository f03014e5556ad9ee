"""``PAL`` on a mesh of several processes: the cases of
``tests/test_torch_mesh_pal.py``, run on every rank of a gloo process group
(``launch/distributed.launch_local``) and, with ``shape=None``, in the test
process as the unsharded answer.  Imports torch and the port only: spawned
ranks never import JAX.

Every rank builds the same ``PAL`` from the same config and numpy weights.
The leader drives it (by hand, or ``run()``); a follower calls ``run()``,
which returns when the leader stops.  Each rank records what its own
engine computed (every ``score`` and ``score_after``, wrapped on the
engine behind the lanes) and returns host numpy.
"""
from __future__ import annotations

import os
import sys
import threading
import time

import numpy as np
import torch

import _torch_mesh_ranks as R
from repro_torch.configs.pal_potential import PALRunConfig
from repro_torch.core import PAL, CommitteeSpec, dispatch
from repro_torch.core.committee import params_from_numpy

D = R.D
THRESHOLD = 0.35
N_GENE = 6           # bucket 8: the 2x1 mesh splits its rows 4 / 4
N_EXCHANGE = 4       # exchange rounds before the labelled block
RETRAIN = 16         # rows of the released block
TRAIN_STEPS = 40     # a round's budget ...
INTERRUPT_AT = 5     # ... and the step at which the leader interrupts it
WALKERS = 12         # bucket 16
RESCORE_ROWS = 13


def label(x):
    return (np.sin(x) - 0.5 * x).astype(np.float32)


class Gene:
    """A host walker: each call moves by a tenth of the committee mean it
    was sent; ``None`` (first call, restart) returns it to its start."""

    def __init__(self, rank, rd, limit=10 ** 9):
        self.x0 = np.random.RandomState(40 + rank).randn(D).astype(
            np.float32)
        self.x, self.n, self.limit = self.x0.copy(), 0, limit

    def generate_new_data(self, data):
        self.n += 1
        if self.n > self.limit:
            return True, self.x
        if data is None:
            self.x = self.x0.copy()
        else:
            self.x = (self.x + 0.1 * np.asarray(data, np.float32).reshape(
                -1)).astype(np.float32)
        return False, self.x.copy()

    def save_progress(self):
        pass

    def stop_run(self):
        pass


class Oracle:
    def __init__(self, rank, rd):
        pass

    def run_calc(self, x):
        x = np.asarray(x, np.float32)
        return x, label(x)

    def stop_run(self):
        pass


def loss_fn(p, batch):
    loss = torch.mean((R.apply(p, batch["x"]) - batch["y"]) ** 2)
    return loss, {"loss": loss}


CFG = dict(gene_process=N_GENE, orcl_process=2, retrain_size=RETRAIN,
           std_threshold=THRESHOLD, oracle_budget=0.3, reweight_buckets=16,
           patience=3, weight_sync_every=1, train_steps=TRAIN_STEPS,
           train_batch=8, train_lr=1e-2, train_bootstrap=False,
           train_replay_capacity=64, seed=3, fleet_sampler="euler",
           fleet_noise=0.0)


def make_pal(tmp, shape, resume=False, chaos=None, **kw):
    mesh = f"{shape[0]}x{shape[1]}" if shape is not None else ""
    cfg = PALRunConfig(result_dir=tmp, uq_mesh=mesh, **dict(CFG, **kw))
    return PAL(cfg, make_generator=Gene, make_oracle=Oracle,
               committee=CommitteeSpec(R.apply,
                                       params_from_numpy(R.weights(), "cpu")),
               loss_fn=loss_fn, resume=resume, chaos=chaos, device="cpu")


class StopAt:
    """An interrupt that fires at its ``k``-th test (after step k)."""

    def __init__(self, k):
        self.k, self.n = k, 0

    def test(self):
        self.n += 1
        return self.n >= self.k


class Record:
    """Every ``score`` and ``score_after`` this rank's engine makes:
    (inputs, advance, UQ fields), (selected count, rows, mean)."""

    def __init__(self, pal):
        eng = dispatch.local(pal.engine)
        self.scores, self.steps = [], []
        score, score_after = eng.score, eng.score_after

        def recorded(list_data, **kw):
            out = score(list_data, **kw)
            self.scores.append((np.asarray(list_data, np.float32).copy(),
                                kw.get("advance", True), R.uq(out)))
            return out

        def recorded_after(*a, **kw):
            carry, out = score_after(*a, **kw)
            self.steps.append((out.n_selected, out.selected.copy(),
                               out.mean.numpy().copy()))
            return carry, out

        eng.score, eng.score_after = recorded, recorded_after


def _numpy(tree):
    return [np.asarray(t.detach().cpu()).copy()
            for t in torch.utils._pytree.tree_leaves(tree)]


def _rank_state(pal, rec):
    """What this rank's own objects hold (read after the lanes closed)."""
    eng = dispatch.local(pal.engine)
    tr = dispatch.local(pal.committee_trainer)
    return {"rank": int(torch.distributed.get_rank())
            if torch.distributed.is_initialized() else 0,
            "leader": pal.leader,
            "scores": rec.scores, "steps": rec.steps,
            "rule_state": eng.state_dict(),
            "members": (eng._members.start, eng._members.stop),
            "params": {k: v.numpy().copy() for k, v in eng.cparams.items()},
            "trainer": _numpy(tr.cstate), "steps_done": tr.steps_done,
            "train_params": {k: v.numpy().copy()
                             for k, v in tr.cparams.items()},
            "refresh": (eng.refresh_host_bytes, eng.device_refreshes),
            "trace_counts": dict(eng.trace_counts),
            "step_trace_counts": dict(eng.step_trace_counts)}


def _token(tok):
    return None if tok is None else (tok.origin, tok.reason)


def _labelled_block(pal):
    rng = np.random.RandomState(21)
    for _ in range(RETRAIN):
        x = rng.randn(D).astype(np.float32)
        pal.train_buffer.add(x, label(x))


def _round_and_handoff(pal):
    """The Manager releases the block, the trainer takes it and runs a
    round the leader interrupts at ``INTERRUPT_AT``, then the handoff."""
    pal.manager.step(0)
    assert pal._trainer_ingest(0, pal.committee_trainer.add_blocks)
    metrics = pal.committee_trainer.train(interrupt=StopAt(INTERRUPT_AT))
    pal._publish_committee()
    return metrics


def _follow(pal):
    """A follower's whole part: wait for the leader's stop."""
    return _token(pal.run())


def stepped(shape, tmp):
    """(a) On the leader, by hand: ``N_EXCHANGE`` exchange rounds (host
    generators), a Manager release, a round interrupted at step
    ``INTERRUPT_AT``, the handoff, the Manager's re-score of the oracle
    buffer and a re-score of fixed rows; then the same with the fleet
    (euler, noise 0); then ``published``.  Returns this rank's
    records."""
    out = {}
    pal = make_pal(os.path.join(tmp, "host"), shape)
    rec = Record(pal)
    if pal.leader:
        try:
            for _ in range(N_EXCHANGE):
                assert pal.exchange.step() is None
            _labelled_block(pal)
            out["metrics"] = _round_and_handoff(pal)
            pal.manager.step(1)          # dynamic_oracle_list: re-score
            rows = np.random.RandomState(22).randn(RESCORE_ROWS, D).astype(
                np.float32)
            pal.engine.score(rows, advance=False)
        finally:
            pal.shutdown()
    else:
        out["token"] = _follow(pal)
    out.update(_rank_state(pal, rec))

    fp = make_pal(os.path.join(tmp, "fleet"), shape, fleet_walkers=WALKERS)
    frec = Record(fp)
    if fp.leader:
        try:
            for _ in range(N_EXCHANGE):
                assert fp.exchange.step() is None
            out["fleet_state"] = fp.fleet.state_dict()
            out["fleet_queued"] = [np.asarray(x).copy()
                                   for x in fp.oracle_buffer.snapshot()]
        finally:
            fp.shutdown()
    else:
        _follow(fp)
    out["fleet_steps"] = frec.steps
    out["fleet_stats"] = fp.report()["fleet"]
    out["fleet_rule_state"] = dispatch.local(fp.engine).state_dict()
    out["published"] = published(shape, os.path.join(tmp, "published"))
    return out


class Trainer:
    """A per-member training kernel that never trains: its weights reach
    the engine through the leader's ``WeightStore``."""

    def __init__(self, rank, rd, dev, mode):
        pass

    def stop_run(self):
        pass


def published_weights():
    """Each member's packed weights (``committee.get_weight``'s order:
    sorted keys), scaled so that they differ from the initial ones."""
    w = R.weights()
    return [np.concatenate([w[k][i].ravel() * 0.5 for k in sorted(w)])
            for i in range(R.K)]


def published(shape, tmp):
    """The fused engine with per-member trainers (no ``loss_fn``): the
    leader publishes every member's packed weights into its store, then
    runs exchange rounds; each round's pull reaches every rank's engine
    (the store's contents travel with the lane call)."""
    mesh = f"{shape[0]}x{shape[1]}" if shape is not None else ""
    pal = PAL(PALRunConfig(result_dir=tmp, uq_mesh=mesh, ml_process=R.K,
                           **CFG),
              make_generator=Gene, make_oracle=Oracle, make_model=Trainer,
              committee=CommitteeSpec(R.apply,
                                      params_from_numpy(R.weights(), "cpu")),
              device="cpu")
    rec = Record(pal)
    if pal.leader:
        try:
            for i, w in enumerate(published_weights()):
                pal.store.publish_packed(i, w)
            for _ in range(N_EXCHANGE):
                assert pal.exchange.step() is None
        finally:
            pal.shutdown()
    else:
        _follow(pal)
    eng = dispatch.local(pal.engine)
    return {"scores": rec.scores, "version": eng.version,
            "members": (eng._members.start, eng._members.stop),
            "params": {k: v.numpy().copy() for k, v in eng.cparams.items()},
            "refresh_host_bytes": eng.refresh_host_bytes}


def free_run(shape, tmp):
    """(b) ``run()`` to its stop with the fleet, the oracles, the trainer
    and ``serve_uq`` with the serving queue (a client thread on the leader
    submits requests), under the acceptance fault plan with the fleet's
    event (on the leader: oracle faults, a trainer-loop crash, a poisoned
    member and a poisoned walker, the last two lane calls).  Returns the
    token, the seconds ``run`` took and this rank's records."""
    from repro_torch.core.chaos import FaultPlan

    pal = make_pal(tmp, shape, fleet_walkers=WALKERS, fleet_max_steps=150,
                   fleet_noise=0.01, retrain_size=8, train_steps=20,
                   serve_uq=True, serve_max_batch=8, serve_max_wait_ms=1.0,
                   chaos=FaultPlan.acceptance(member=1, fleet=True))
    rec = Record(pal)
    served, stop = [], threading.Event()

    def client():
        rng = np.random.RandomState(23)
        while not stop.is_set():
            rows = list(rng.randn(3, D).astype(np.float32))
            try:
                served.append(pal.serve_queue.submit(rows).result(30.0))
            except Exception:  # noqa: BLE001 — the queue closed at the stop
                return

    th = None
    if pal.leader:
        th = threading.Thread(target=client, daemon=True)
        th.start()
    t0 = time.perf_counter()
    try:
        tok = pal.run(timeout=60.0)
    finally:
        stop.set()
        if th is not None:
            th.join(timeout=30.0)
    eng = dispatch.local(pal.engine)
    out = {"token": _token(tok), "seconds": time.perf_counter() - t0,
           "served": len(served), "report": _report(pal),
           "chaos": pal.chaos.summary() if pal.chaos else None,
           "quarantine_rounds": eng.quarantine_rounds,
           "member_ok": dispatch.local(pal.committee_trainer).last_member_ok}
    out.update(_rank_state(pal, rec))
    return out


def _report(pal):
    r = pal.report()
    c = r["counters"]
    return {"labeled_total": r["labeled_total"],
            "retrains": c.get("train.retrains", 0),
            "crashes": c.get("runtime.thread_crashes", 0),
            "unjoined": c.get("runtime.unjoined_threads", 0),
            "restarts": r["thread_restarts"],
            "refreshes": r["device_weight_refreshes"],
            "fleet": r.get("fleet"), "lanes": r.get("lanes")}


def follower_fault(shape, tmp, timeout_s):
    """(c) The follower's engine raises inside its third ``score`` (a lane
    call).  Each rank returns the error ``run()`` raised and when."""
    dispatch.TIMEOUT_S = timeout_s
    pal = make_pal(tmp, shape, orcl_process=1)
    if not pal.leader:
        eng = dispatch.local(pal.engine)
        score, calls = eng.score, []

        def faulty(*a, **kw):
            calls.append(1)
            if len(calls) == 3:
                raise RuntimeError("injected follower fault")
            return score(*a, **kw)

        eng.score = faulty
    t0 = time.perf_counter()
    try:
        tok = pal.run(timeout=4 * timeout_s)
        err = None
    except dispatch.LaneError as e:
        tok, err = None, str(e)
    return {"rank": int(torch.distributed.get_rank()), "error": err,
            "token": _token(tok), "seconds": time.perf_counter() - t0}


def _lane_threads():
    """The names of this process's lane threads (``Lane.start``'s)."""
    return sorted(t.name for t in threading.enumerate()
                  if t.name.startswith("lane-"))


def delayed_follower(shape, tmp, delay_s):
    """(e) The leader records at once and makes ``N_EXCHANGE`` exchange
    rounds straight away; the follower waits until the leader's first
    engine-lane send has begun (a file its patched ``_send`` writes),
    then ``delay_s`` more, then records and calls ``run()``.  Each rank
    returns its lane threads right after construction, its records and,
    on the leader, the lanes' counters."""
    pal = make_pal(tmp, shape)
    out = {"rank": int(torch.distributed.get_rank()), "leader": pal.leader,
           "lane_threads": _lane_threads()}
    marker = os.path.join(tmp, "leader_sending")
    if pal.leader:
        lane = pal._engine_lane
        send = lane._send

        def marked(msg):
            if not os.path.exists(marker):
                open(marker, "w").close()
            return send(msg)

        lane._send = marked
        rec = Record(pal)
        try:
            for _ in range(N_EXCHANGE):
                assert pal.exchange.step() is None
        finally:
            pal.shutdown()
        out["lanes"] = pal.report()["lanes"]
    else:
        deadline = time.monotonic() + 60.0
        while not os.path.exists(marker):
            assert time.monotonic() < deadline, "the leader never sent"
            time.sleep(0.01)
        time.sleep(delay_s)
        rec = Record(pal)
        out["token"] = _follow(pal)
    out["scores"] = rec.scores
    return out


def unstarted_follower(shape, tmp, timeout_s):
    """(f) The follower is shut down without ``run()``; the leader runs
    (lane timeout ``timeout_s``).  Each rank returns its lane threads
    right after construction, the error ``run()`` raised (the leader's)
    and its seconds from construction to return."""
    dispatch.TIMEOUT_S = timeout_s
    pal = make_pal(tmp, shape, orcl_process=1)
    out = {"rank": int(torch.distributed.get_rank()), "leader": pal.leader,
           "lane_threads": _lane_threads(), "error": None}
    t0 = time.perf_counter()
    if pal.leader:
        try:
            pal.run(timeout=4 * timeout_s)
        except dispatch.LaneError as e:
            out["error"] = str(e)
    else:
        pal.shutdown()
    out["seconds"] = time.perf_counter() - t0
    return out


def resume(shape, tmp):
    """(d) The fleet PAL: rounds, a trained and handed-off round, a
    checkpoint, then ``N_EXCHANGE`` rounds and another round (``after``);
    a second PAL resumed from the checkpoint runs the same continuation
    (``resumed``).  The records' last ``N_EXCHANGE`` fleet steps are the
    continuation's."""
    out = {}
    for name, resumed in (("after", False), ("resumed", True)):
        pal = make_pal(tmp, shape, resume=resumed, fleet_walkers=WALKERS)
        rec = Record(pal)
        if pal.leader:
            try:
                if not resumed:
                    for _ in range(N_EXCHANGE):
                        pal.exchange.step()
                    _labelled_block(pal)
                    _round_and_handoff(pal)
                    pal.checkpoint()
                for _ in range(N_EXCHANGE):
                    pal.exchange.step()
                _labelled_block(pal)
                _round_and_handoff(pal)
                out[name + "_fleet"] = pal.fleet.state_dict()
            finally:
                pal.shutdown()
        else:
            _follow(pal)
        out[name] = _rank_state(pal, rec)
    return out


def _live():
    """The process groups and OS threads (gloo's included) this process
    holds."""
    from torch.distributed import distributed_c10d as c10d

    return {"groups": len(c10d._world.pg_map),
            "os_threads": len(os.listdir("/proc/self/task"))}


def _short_loop(pal):
    """(g) One short loop: on the leader ``N_EXCHANGE`` exchange rounds,
    a labelled block, a round interrupted at ``INTERRUPT_AT`` and the
    handoff (both lanes), then ``shutdown``; a follower waits for its
    stop.  Returns the stop token a follower received (the leader's:
    None), the labelled count and what this rank's engine computed."""
    rec = Record(pal)
    token = None
    if pal.leader:
        try:
            for _ in range(N_EXCHANGE):
                assert pal.exchange.step() is None
            _labelled_block(pal)
            _round_and_handoff(pal)
        finally:
            pal.shutdown()
    else:
        token = _follow(pal)
    return {"token": token, "labelled": pal.train_buffer.total_labeled,
            "scores": [s[2] for s in rec.scores]}


def _primed_live(shape):
    """The counts before the first loop, once what every loop shares
    exists: the mesh's DeviceMesh (``make_scaleout_mesh`` caches it for
    the process) and the CPU's thread pool."""
    from repro_torch.launch.mesh import make_scaleout_mesh

    make_scaleout_mesh(*shape)
    torch.ones(64, 64) @ torch.ones(64, 64)
    return _live()


def loops_in_one_process(shape, tmp, loops):
    """(g) ``loops`` short loops one after another in this process, each
    a new ``PAL`` in a result dir of its own.  Returns the counts before
    the first and after each (``_live``), and each loop's
    ``_short_loop``."""
    out = {"before": _primed_live(shape), "after": [], "loops": []}
    for i in range(loops):
        pal = make_pal(os.path.join(tmp, f"loop{i}"), shape)
        out["loops"].append(_short_loop(pal))
        del pal
        out["after"].append(_live())
    return out


def fault_then_loop(shape, tmp, timeout_s):
    """(h) A loop whose follower fault breaks the lanes (``follower_fault``,
    lane timeout ``timeout_s``), then a short loop.  Returns the counts
    before, after the broken loop and after the short one, the broken
    loop's ``follower_fault`` result and the short loop's."""
    before = _primed_live(shape)
    broken = follower_fault(shape, os.path.join(tmp, "broken"), timeout_s)
    after_broken = _live()
    loop = _short_loop(make_pal(os.path.join(tmp, "after"), shape))
    return {"before": before, "after": [after_broken, _live()],
            "broken": broken, "loop": loop}


class _Slow:
    """A lane object whose ``wait`` sleeps: a call that outlives the
    lane's join."""

    def __init__(self):
        self.entered = threading.Event()

    def wait(self, seconds):
        self.entered.set()
        time.sleep(seconds)
        return int(torch.distributed.get_rank())


def straggler_lane(shape, tmp, call_s, timeout_s):
    """(i) A lane of ``shape``'s mesh whose one call sleeps ``call_s``
    seconds, closed while that call runs with ``TIMEOUT_S`` patched to
    ``timeout_s`` (shorter): ``close`` must return with the thread alive
    and the groups kept, the call and the stop token must then go through
    on those groups, and a later ``release`` must destroy them.  Returns
    the counts before the lane, with it, after ``close`` and after the
    later ``release``, both releases' results, whether the lane still
    held its control group at ``close``, and what the lane reported."""
    from torch.distributed import distributed_c10d as c10d

    from repro_torch.launch.mesh import make_scaleout_mesh

    before = _primed_live(shape)
    stops, errors, results = [], [], []
    lane = dispatch.Lane("straggler", make_scaleout_mesh(*shape), "cpu",
                         on_stop=stops.append,
                         on_error=lambda e: errors.append(str(e)))
    slow = _Slow()
    lane.register("slow", slow)
    lane.start()
    with_lane = _live()
    if lane.leader:
        caller = threading.Thread(
            target=lambda: results.append(lane.call("slow", "wait", call_s)))
        caller.start()
    assert slow.entered.wait(30.0)
    saved = dispatch.TIMEOUT_S
    dispatch.TIMEOUT_S = timeout_s
    try:
        t0 = time.perf_counter()
        released = lane.close(("test", "straggler"))
        close_s = time.perf_counter() - t0
        alive = lane._thread.is_alive()
        kept = lane.group in c10d._world.pg_map
        after_close = _live()
        lane._thread.join(4 * call_s)
        if lane.leader:
            caller.join(4 * call_s)
        released_later = lane.release()
    finally:
        dispatch.TIMEOUT_S = saved
    return {"before": before, "with_lane": with_lane,
            "after_close": after_close, "after": [_live()],
            "released": released, "released_later": released_later,
            "alive_at_close": alive, "group_kept": kept,
            "close_s": close_s, "stops": stops, "errors": errors,
            "results": results}


def main(argv) -> int:
    """One rank of a two-process ``PAL`` launched from its config alone
    (``dist_coordinator``, ``dist_processes``, ``dist_process_id``, then
    ``uq_mesh='2x1'``): the fleet loop run to its stop; prints
    ``PAL_OK <leader> <stop origin>``.  Arguments: coordinator, process
    id, result dir."""
    from repro_torch.launch import distributed

    coordinator, pid, tmp = argv
    cfg = PALRunConfig(result_dir=tmp, uq_mesh="2x1",
                       dist_coordinator=coordinator, dist_processes=2,
                       dist_process_id=int(pid),
                       **dict(CFG, fleet_walkers=WALKERS,
                              fleet_max_steps=20))
    distributed.initialize_from_config(cfg)
    try:
        pal = PAL(cfg, make_generator=Gene, make_oracle=Oracle,
                  committee=CommitteeSpec(
                      R.apply, params_from_numpy(R.weights(), "cpu")),
                  loss_fn=loss_fn, device="cpu")
        tok = pal.run(timeout=60.0)
        print(f"PAL_OK {int(pal.leader)} {tok.origin}", flush=True)
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
