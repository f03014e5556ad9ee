"""The port's ``PAL`` on meshes of two processes (gloo ranks on the CPU),
held against the port's unsharded ``PAL`` and the reference's.

The reference runs ``PAL(mesh=...)`` as one single-controller program
(``src/repro/core/runtime.py``, ``src/repro/launch/distributed.py``); the
port runs one process per rank, the leader driving the loop and the
followers making its mesh calls in its order (``core/dispatch.py``).  Each
mesh is one spawn of ranks (``launch/distributed.launch_local``, a
``file://`` store under ``tmp_path``) running the cases of
``tests/_torch_mesh_pal_ranks.py``:

* (a) a hand-stepped sequence on 2x1 and 1x2 — exchange rounds from host
  generators, a Manager release, a trainer round the leader interrupts at
  a set step, the handoff, the Manager's re-score; and exchange rounds of
  the fleet (euler, noise 0) — every rank's UQ results, masks, rule state,
  engine params and trainer state the same bits on every rank and held
  against the port's unsharded ``PAL`` driven by the same steps (the
  trainer and the handed-off params bit for bit on 2x1, rtol 1e-5 atol
  1e-6 on 1x2; UQ at ROADMAP's tolerances, since a row shard may round a
  row by one ulp in PyTorch's CPU matmul), and against the reference's
  unsharded ``PAL`` (``impl='xla'``) at ROADMAP's tolerances: its exchange
  and fleet rounds, and its engine at the port's trained params for the
  re-scores (the trainers' minibatch draws differ: ROADMAP's "RNG
  differs"); and the weights per-member trainers publish on the leader
  reaching every rank's engine;
* (b) ``run()`` to the stop on 2x1 with the fleet, the oracles, the
  trainer and the serving queue: one stop token on every rank;
* (c) a follower whose lane call raises ends both ranks, with its
  traceback;
* (d) a checkpoint written on 1x2 and resumed on 1x2 continues bit for
  bit;
* (e) a follower that waits before its ``run()`` misses none of the
  leader's calls (its lanes start at ``run()``), and (f) one shut down
  without ``run()`` ends both ranks within the lane's timeout;
* (g) three short loops in one process, on 2x1 and 1x2, and (h) a loop
  broken by a follower fault then a short one: after each, every rank
  holds the process groups and OS threads it held before the first (the
  lanes destroy their groups at ``close``); and (i) a lane call that
  outlives ``close``'s join keeps its groups until its thread ends;
* and two processes that join from the config alone
  (``initialize_from_config``) and run ``PAL(uq_mesh='2x1')``.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

import _torch_mesh_pal_ranks as M
import _torch_mesh_ranks as R
from repro.configs.pal_potential import PALRunConfig as JRunConfig
from repro.core import PAL as JPAL
from repro.core import CommitteeSpec as JCommitteeSpec
from repro.core import acquisition as racq
from repro.core.budget import rules_from_config as r_rules_from_config
from repro_torch.launch import distributed

SHAPES = {"data2": (2, 1), "model2": (1, 2)}
TOL = dict(mean=(1e-5, 1e-6), std=(1e-4, 1e-6))     # ROADMAP's
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)               # the committee axis
POS_ATOL = 5e-5          # tests/test_torch_fleet.py's, fleet positions
FAULT_TIMEOUT_S = 5.0
FOLLOWER_DELAY_S = 2.0
LOOPS = 3
THREAD_MARGIN = 2        # OS threads a rank may hold above its count before
STRAGGLER_S = 3.0        # a lane call's seconds, beyond the patched timeout
STRAGGLER_TIMEOUT_S = 0.5


def _spawn(tmp_path_factory, name, fn, shape, *args):
    store = tmp_path_factory.mktemp(name) / "store"
    work = tmp_path_factory.mktemp(name + "_run")
    return distributed.launch_local(2, fn, shape, str(work), *args,
                                    init_method=f"file://{store}",
                                    timeout=300)


@pytest.fixture(scope="module")
def stepped(tmp_path_factory):
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _spawn(tmp_path_factory, name, M.stepped,
                                 SHAPES[name])
        return cache[name]
    return get


@pytest.fixture(scope="module")
def unsharded(tmp_path_factory):
    return M.stepped(None, str(tmp_path_factory.mktemp("unsharded")))


def _jax_apply(p, x):
    return jnp.tanh(x @ p["w1"]) @ p["w2"]


def _jax_loss(p, b):
    loss = jnp.mean((_jax_apply(p, b["x"]) - b["y"]) ** 2)
    return loss, {"loss": loss}


def _jax_cfg(tmp, **kw):
    return JRunConfig(result_dir=str(tmp), uq_impl="xla",
                      **dict(M.CFG, **kw))


def _jax_pal(tmp, **kw):
    return JPAL(_jax_cfg(tmp, **kw), make_generator=M.Gene,
                make_oracle=M.Oracle,
                committee=JCommitteeSpec(
                    _jax_apply,
                    {k: jnp.asarray(v) for k, v in R.weights().items()}),
                loss_fn=_jax_loss)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's unsharded PAL: the same exchange rounds (host
    generators), and the same fleet rounds."""
    jp = _jax_pal(tmp_path_factory.mktemp("jax_host"))
    scores = []
    score = jp.engine.score

    def recorded(list_data, **kw):
        out = score(list_data, **kw)
        scores.append(R.uq(out))
        return out
    jp.engine.score = recorded
    for _ in range(M.N_EXCHANGE):
        assert jp.exchange.step() is None
    fp = _jax_pal(tmp_path_factory.mktemp("jax_fleet"),
                  fleet_walkers=M.WALKERS)
    for _ in range(M.N_EXCHANGE):
        assert fp.exchange.step() is None
    return {"scores": scores,
            "rule_state": R._leaves(jp.engine.state_dict()),
            "fleet_state": fp.fleet.state_dict(),
            "fleet_queued": fp.oracle_buffer.snapshot(),
            "fleet_stats": fp.report()["fleet"],
            "fleet_rule_state": R._leaves(fp.engine.state_dict())}


def _assert_uq_close(got, want):
    mean, sstd, cstd, mask = got
    np.testing.assert_allclose(mean, want[0], *TOL["mean"])
    np.testing.assert_allclose(sstd, want[1], *TOL["std"])
    np.testing.assert_allclose(cstd, want[2], *TOL["std"])
    rtol, atol = TOL["std"]
    far = np.abs(want[1] - M.THRESHOLD) > atol + rtol * np.abs(want[1])
    np.testing.assert_array_equal(mask[far], want[3][far])


def _assert_equal(a, b):
    for x, y in zip(a, b, strict=True):
        np.testing.assert_array_equal(x, y)


def _whole_params(outs):
    """The engines' members of every rank, in member order."""
    outs = sorted({o["members"]: o for o in outs}.values(),
                  key=lambda o: o["members"])
    return {k: np.concatenate([o["params"][k] for o in outs])
            for k in outs[0]["params"]}


def _whole_trainer(outs):
    """The trainers' state leaves (params, moments, steps: the member axis
    leads each) over the whole committee."""
    outs = sorted({o["members"]: o for o in outs}.values(),
                  key=lambda o: o["members"])
    return [np.concatenate([o["trainer"][i] for o in outs])
            for i in range(len(outs[0]["trainer"]))]


# ---------------------------------------------------------------------------
# (a) hand-stepped parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(SHAPES))
def test_stepped_ranks_match_the_unsharded_pal(name, stepped, unsharded):
    """The ranks' scores (exchange rounds, re-scores after the handoff)
    and rule state are the same bits on every rank, and within ROADMAP's
    tolerances of the port's unsharded PAL driven by the same steps (a
    rank's rows of a split bucket go through PyTorch's CPU matmul in a
    smaller batch, which may round a row by one ulp: ROADMAP §C).  The
    trainer state and the engine params after the handoff equal the
    unsharded ones bit for bit on 2x1 (the committee whole on each rank)
    and within rtol 1e-5 atol 1e-6 on 1x2."""
    exact = SHAPES[name][1] == 1
    outs = stepped(name)
    assert [o["leader"] for o in outs] == [True, False]
    lead, follow = outs
    for (xa, adv_a, a), (xb, adv_b, b) in zip(lead["scores"],
                                              follow["scores"],
                                              strict=True):
        np.testing.assert_array_equal(xa, xb)
        assert adv_a == adv_b
        _assert_equal(a, b)
    _assert_equal(R._leaves(lead["rule_state"]),
                  R._leaves(follow["rule_state"]))
    for (x, adv, got), (x0, adv0, want) in zip(lead["scores"],
                                              unsharded["scores"],
                                              strict=True):
        np.testing.assert_allclose(x, x0, *TOL["mean"])
        assert adv == adv0
        _assert_uq_close(got, want)
    for a, b in zip(R._leaves(lead["rule_state"]),
                    R._leaves(unsharded["rule_state"]), strict=True):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    want_p, want_t = unsharded["params"], unsharded["trainer"]
    got_p, got_t = _whole_params(outs), _whole_trainer(outs)
    for k in want_p:
        if exact:
            np.testing.assert_array_equal(got_p[k], want_p[k])
        else:
            np.testing.assert_allclose(got_p[k], want_p[k], **PARAM_TOL)
    for a, b in zip(got_t, want_t, strict=True):
        if exact:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, **PARAM_TOL)


@pytest.mark.parametrize("name", list(SHAPES))
def test_the_leader_decides_the_stop_step_and_the_handoff(name, stepped):
    """The round is interrupted on the leader at step ``INTERRUPT_AT``:
    every rank ran exactly that many steps, and after the handoff every
    rank's engine holds its trainer's params of that step, with 0 host
    bytes; the follower's run() returned the leader's stop."""
    outs = stepped(name)
    for o in outs:
        assert o["steps_done"] == M.INTERRUPT_AT
        assert o["refresh"] == (0, 1)
        for k, v in o["params"].items():
            np.testing.assert_array_equal(v, o["train_params"][k])
    assert outs[1]["token"] == ("runtime", "shutdown")


@pytest.mark.parametrize("name", list(SHAPES))
def test_stepped_ranks_match_the_reference_pal(name, stepped, reference):
    """Against the reference's unsharded PAL (``impl='xla'``): its
    exchange rounds on the same host generators, its rule state, and its
    engine at the port's trained params and rule state for the re-scores
    after the handoff, at ROADMAP's tolerances (masks equal away from the
    threshold)."""
    outs = stepped(name)
    params = _whole_params(outs)
    for o in outs:
        exchange = o["scores"][:M.N_EXCHANGE]
        for (_, adv, got), want in zip(exchange, reference["scores"],
                                       strict=True):
            assert adv
            _assert_uq_close(got, want)
        for a, b in zip(R._leaves(o["rule_state"]),
                        reference["rule_state"], strict=True):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        je = racq.FusedEngine(
            _jax_apply, {k: jnp.asarray(v) for k, v in params.items()},
            M.THRESHOLD, rules=r_rules_from_config(_jax_cfg("")),
            impl="xla")
        je.load_state_dict(o["rule_state"])
        rescores = o["scores"][M.N_EXCHANGE:]
        assert len(rescores) == 2 and not any(a for _, a, _ in rescores)
        for x, _, got in rescores:
            _assert_uq_close(got, R.uq(je.score(list(x), advance=False)))


@pytest.mark.parametrize("name", list(SHAPES))
def test_fleet_rounds_match_unsharded_and_reference(name, stepped,
                                                    unsharded, reference):
    """The fleet's rounds (euler, noise 0): the same bits on every rank,
    within ROADMAP's mean tolerance of the unsharded PAL's (selections
    and means), and the reference's walker states, queued candidates,
    stats and rule state."""
    outs = stepped(name)
    for a, b in zip(outs[0]["fleet_steps"], outs[1]["fleet_steps"],
                    strict=True):
        assert a[0] == b[0]
        _assert_equal(a[1:], b[1:])
    for o in outs:
        for (n, s, m), (n0, s0, m0) in zip(o["fleet_steps"],
                                           unsharded["fleet_steps"],
                                           strict=True):
            assert n == n0
            np.testing.assert_allclose(s, s0, *TOL["mean"])
            np.testing.assert_allclose(m, m0, *TOL["mean"])
        assert o["fleet_stats"] == unsharded["fleet_stats"] == \
            reference["fleet_stats"]
        for a, b in zip(R._leaves(o["fleet_rule_state"]),
                        reference["fleet_rule_state"], strict=True):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    lead = outs[0]
    for k in ("x", "x0", "f", "v"):
        np.testing.assert_allclose(lead["fleet_state"][k],
                                   reference["fleet_state"][k],
                                   atol=POS_ATOL, rtol=0, err_msg=k)
    for k in ("counts", "restarts", "flag", "step", "nan_resets"):
        np.testing.assert_array_equal(lead["fleet_state"][k],
                                      reference["fleet_state"][k])
    assert len(lead["fleet_queued"]) == len(reference["fleet_queued"]) > 0
    for a, b in zip(lead["fleet_queued"], reference["fleet_queued"]):
        np.testing.assert_allclose(a, np.asarray(b), atol=POS_ATOL, rtol=0)


@pytest.mark.parametrize("name", list(SHAPES))
def test_published_weights_reach_every_rank(name, stepped, unsharded):
    """Per-member trainers with the fused engine: the weights the leader's
    store holds are pulled into every rank's engine (its own members),
    through the packed host path it counts, and every rank then scores
    on them as the unsharded PAL does."""
    outs = [o["published"] for o in stepped(name)]
    want = M.published_weights()
    one = unsharded["published"]
    for o in outs:
        assert o["version"] == one["version"] == R.K
        assert o["refresh_host_bytes"] == one["refresh_host_bytes"] > 0
        lo, hi = o["members"]
        for i in range(lo, hi):
            got = np.concatenate([o["params"][k][i - lo].ravel()
                                  for k in sorted(o["params"])])
            np.testing.assert_array_equal(got, want[i])
        for (x, _, got), (x0, _, want_uq) in zip(o["scores"], one["scores"],
                                                 strict=True):
            np.testing.assert_allclose(x, x0, *TOL["mean"])
            _assert_uq_close(got, want_uq)
    for a, b in zip(outs[0]["scores"], outs[1]["scores"], strict=True):
        _assert_equal(a[2], b[2])


# ---------------------------------------------------------------------------
# (b) free run, (c) follower fault, (d) resume
# ---------------------------------------------------------------------------


def test_free_run_stops_every_rank_with_one_token(tmp_path_factory):
    """``run()`` on 2x1 with the fleet (150 steps), two oracle threads'
    labels, trainer rounds, handoffs and served requests, under the
    acceptance fault plan on the leader: every rank returns the fleet's
    stop token within 60 s, with one program per bucket, the same rule
    state, steps and handoffs; the poisoned member and walker (lane calls)
    reach the follower; the two injected loop crashes are absorbed by
    restarts on the leader."""
    outs = _spawn(tmp_path_factory, "free", M.free_run, (2, 1))
    lead, follow = outs
    assert lead["token"] == follow["token"] == \
        ("fleet", "fleet max_steps reached")
    assert all(o["seconds"] < 60.0 for o in outs)
    rep = lead["report"]
    assert rep["crashes"] == rep["restarts"] == 2 and rep["unjoined"] == 0
    assert follow["report"]["crashes"] == 0 and follow["chaos"] is None
    assert {"trainer.nan_member:*:nan_member@1",
            "fleet.step:*:nan_walker@3"} <= set(lead["chaos"])
    assert rep["retrains"] > 0 and rep["refreshes"] > 0
    assert lead["served"] > 0
    assert rep["fleet"]["steps"] == 150 and rep["fleet"]["nan_resets"] == 1
    assert follow["report"]["fleet"] == rep["fleet"]
    assert lead["quarantine_rounds"] == follow["quarantine_rounds"] > 0
    np.testing.assert_array_equal(lead["member_ok"], follow["member_ok"])
    assert not lead["member_ok"][1]
    for o in outs:
        assert all(c == 1 for c in o["trace_counts"].values())
        assert list(o["step_trace_counts"].values()) == [1]
    for k in ("trace_counts", "step_trace_counts", "steps_done", "refresh"):
        assert lead[k] == follow[k], k
    assert lead["report"]["refreshes"] == follow["report"]["refreshes"]
    _assert_equal(R._leaves(lead["rule_state"]),
                  R._leaves(follow["rule_state"]))
    for a, b in zip(lead["scores"], follow["scores"], strict=True):
        _assert_equal(a[2], b[2])
    for a, b in zip(lead["steps"], follow["steps"], strict=True):
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[2], b[2])


def test_a_follower_fault_ends_both_ranks(tmp_path_factory):
    """The follower's engine raises inside a lane call: its run() raises
    its traceback, and the leader's run() raises too (its collective with
    the follower timed out) — both within the lane's timeout, neither
    with a stop token."""
    outs = _spawn(tmp_path_factory, "fault", M.follower_fault, (2, 1),
                  FAULT_TIMEOUT_S)
    lead, follow = sorted(outs, key=lambda o: o["rank"])
    assert "injected follower fault" in follow["error"]
    assert "Traceback" in follow["error"]
    assert lead["error"] is not None and "lane engine on rank 0" in \
        lead["error"]
    for o in outs:
        assert o["token"] is None
        assert o["seconds"] < 3 * FAULT_TIMEOUT_S


def test_a_follower_makes_no_call_before_its_run(tmp_path_factory):
    """The follower sleeps ``FOLLOWER_DELAY_S`` after the leader's first
    engine-lane send began, before its ``run()``, while the leader makes
    its exchange rounds at once: the follower's records hold every one of
    the leader's calls with the same inputs bit for bit, the leader's
    sends took at least the delay (its first call waited for the
    follower), and the follower has no lane thread until ``run()`` (the
    leader has both from construction)."""
    outs = _spawn(tmp_path_factory, "delayed", M.delayed_follower, (2, 1),
                  FOLLOWER_DELAY_S)
    lead, follow = outs
    assert len(lead["scores"]) == M.N_EXCHANGE
    for (xa, adv_a, a), (xb, adv_b, b) in zip(lead["scores"],
                                              follow["scores"],
                                              strict=True):
        np.testing.assert_array_equal(xa, xb)
        assert adv_a == adv_b
        _assert_equal(a, b)
    assert lead["lanes"]["engine"]["send_s"] >= FOLLOWER_DELAY_S
    assert lead["lane_threads"] == ["lane-engine", "lane-trainer"]
    assert follow["lane_threads"] == []
    assert follow["token"] == ("runtime", "shutdown")


def test_a_follower_shut_down_without_run_ends_both_ranks(
        tmp_path_factory):
    """A follower shut down without ``run()`` starts no lane and leaves
    at once; to the leader it is a follower that died: its engine lane
    breaks within the lane's timeout and its run() raises, both ranks
    within three timeouts."""
    outs = _spawn(tmp_path_factory, "unstarted", M.unstarted_follower,
                  (2, 1), FAULT_TIMEOUT_S)
    lead, follow = outs
    assert lead["lane_threads"] == ["lane-engine", "lane-trainer"]
    assert follow["lane_threads"] == [] and follow["error"] is None
    assert lead["error"] is not None and "lane engine on rank 0" in \
        lead["error"]
    for o in outs:
        assert o["seconds"] < 3 * FAULT_TIMEOUT_S


def _assert_back_to_before(o):
    """Each count after a loop: the process groups exactly as before the
    first loop, the OS threads (gloo's: three a group) within
    ``THREAD_MARGIN``."""
    for after in o["after"]:
        assert after["groups"] == o["before"]["groups"], o
        assert 0 <= after["os_threads"] - o["before"]["os_threads"] <= \
            THREAD_MARGIN, o


@pytest.mark.parametrize("name", list(SHAPES))
def test_loop_after_loop_leaves_no_group_or_thread(name, tmp_path_factory):
    """Three short loops (exchange rounds, a labelled block, a trainer
    round, the handoff: both lanes) in one process on every rank: after
    each, the rank holds the process groups it held before the first and
    its OS threads within ``THREAD_MARGIN`` (each loop's lanes made four
    groups, with three gloo threads each); the third loop's stop token,
    labelled count and scores are the first's."""
    outs = _spawn(tmp_path_factory, f"loops_{name}", M.loops_in_one_process,
                  SHAPES[name], LOOPS)
    for o in outs:
        assert len(o["after"]) == LOOPS
        _assert_back_to_before(o)
        first, last = o["loops"][0], o["loops"][-1]
        assert first["token"] == last["token"]
        assert first["labelled"] == last["labelled"]
        assert len(first["scores"]) == len(last["scores"]) > 0
        for a, b in zip(first["scores"], last["scores"]):
            _assert_equal(a, b)
    assert outs[0]["loops"][0]["labelled"] == M.RETRAIN
    assert outs[1]["loops"][0]["token"] == ("runtime", "shutdown")


def test_a_broken_loop_releases_its_groups(tmp_path_factory):
    """A follower fault breaks both ranks' lanes (as in
    ``test_a_follower_fault_ends_both_ranks``): their groups are released
    all the same, within the lane's timeout, and a short loop after it
    runs and leaves nothing behind either."""
    outs = _spawn(tmp_path_factory, "broken_loop", M.fault_then_loop,
                  (2, 1), FAULT_TIMEOUT_S)
    for o in outs:
        assert o["broken"]["error"] is not None
        assert o["broken"]["seconds"] < 3 * FAULT_TIMEOUT_S
        _assert_back_to_before(o)
    assert outs[0]["loop"]["labelled"] == M.RETRAIN
    assert "injected follower fault" in outs[1]["broken"]["error"]
    assert outs[1]["loop"]["token"] == ("runtime", "shutdown")


def test_a_lane_call_outliving_close_keeps_its_groups(tmp_path_factory):
    """A lane call of ``STRAGGLER_S`` seconds, closed on both ranks with
    ``TIMEOUT_S`` patched to ``STRAGGLER_TIMEOUT_S``: ``close`` returns
    False after its join, the thread still in the call, every group still
    held (destroying one under a thread blocked in it, or sending the
    thread's next message on no group, is what it must not do); the call
    then ends, the stop token reaches the follower on the lane's own
    group, and a later ``release`` destroys the groups."""
    outs = _spawn(tmp_path_factory, "straggler", M.straggler_lane, (2, 1),
                  STRAGGLER_S, STRAGGLER_TIMEOUT_S)
    for o in outs:
        assert o["errors"] == [], o
        assert o["alive_at_close"] and o["group_kept"], o
        assert o["released"] is False and o["released_later"] is True, o
        assert o["close_s"] < STRAGGLER_S, o
        assert o["after_close"]["groups"] == o["with_lane"]["groups"] > \
            o["before"]["groups"], o
        _assert_back_to_before(o)
    assert outs[0]["results"] == [0] and outs[0]["stops"] == []
    assert outs[1]["stops"] == [("test", "straggler")]


def test_resume_on_the_model_axis_continues_bit_for_bit(tmp_path_factory):
    """A checkpoint written on 1x2 (the leader writes; the trainer's and
    the fleet's gathers run on their lanes) and resumed on 1x2 (every rank
    reads the same file): the continuation's fleet rounds, trainer state,
    rule state and engine params equal the first run's on every rank."""
    outs = _spawn(tmp_path_factory, "resume", M.resume, (1, 2))
    for o in outs:
        a, b = o["after"], o["resumed"]
        assert a["members"] == b["members"] != (0, R.K)
        cont = a["steps"][-M.N_EXCHANGE:]
        assert len(b["steps"]) == M.N_EXCHANGE
        for x, y in zip(cont, b["steps"], strict=True):
            assert x[0] == y[0]
            np.testing.assert_array_equal(x[1], y[1])
            np.testing.assert_array_equal(x[2], y[2])
        _assert_equal(a["trainer"], b["trainer"])
        _assert_equal(R._leaves(a["rule_state"]), R._leaves(b["rule_state"]))
        for k in a["params"]:
            np.testing.assert_array_equal(a["params"][k], b["params"][k])
        assert a["steps_done"] == b["steps_done"] == 2 * M.INTERRUPT_AT
    lead = outs[0]
    for k, v in lead["after_fleet"].items():
        np.testing.assert_array_equal(v, lead["resumed_fleet"][k], err_msg=k)


def test_two_processes_from_the_config_run_pal(tmp_path):
    """Two processes launched by hand, each joining from its
    ``PALRunConfig`` (a TCP coordinator, ``initialize_from_config``) and
    running ``PAL(uq_mesh='2x1')`` with the fleet to its stop: one leader,
    one follower, the same stop token."""
    tests = Path(__file__).resolve().parent
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", PYTHONPATH=os.pathsep.join(
        [str(tests.parent / "src"), str(tests)]))
    procs = [subprocess.Popen(
        [sys.executable, str(tests / "_torch_mesh_pal_ranks.py"),
         f"127.0.0.1:{port}", str(i), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for i in range(2)]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    lines = []
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{out}\n{err[-3000:]}"
        lines.append([x for x in out.splitlines()
                      if x.startswith("PAL_OK")][0].split())
    assert [x[1] for x in lines] == ["1", "0"]
    assert lines[0][2:] == lines[1][2:] == ["fleet"]
