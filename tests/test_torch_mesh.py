"""The port's mesh paths on real multi-process meshes (gloo ranks on the
CPU), held against the port's unsharded path and the reference's.

Mirrors every case of ``tests/test_mesh_parity.py`` on the meshes 2x1,
1x2 and 2x2 (4 ranks) with K=4 and the K=3 fallback warning, and the
reference's host-mesh cases: ``test_serving_queue.py:286-363``,
``test_committee_trainer.py:140`` and ``test_memory_policy.py:339``.  The
reference's own mesh path cannot run under this JAX (its meshes are made
with Explicit axes, which its sharding constraints refuse: five of its six
failing tests), and its contract is "sharding is a LAYOUT decision, not a
numerics decision" (``test_mesh_parity.py:8-13``), so the port's mesh
paths are held against the unsharded paths: the 1x1 engine against the
reference's ``FusedEngine(impl='xla')`` to ROADMAP's tolerances (mean rtol
1e-5 with atol 1e-6; std rtol 1e-4, atol 1e-6; masks exact on rows further
than that from the threshold), the larger meshes against the port's unsharded engine and
the reference's the same way.  PyTorch's CPU matmul may round a row by one
ulp otherwise in a smaller batch (a row shard), hence tolerances there too;
the rule state, the trainer on the data axis, the fleet's selections and
the queue's answers are compared exactly where the port's results allow.

Each mesh is one spawn of ranks (``launch/distributed.launch_local``,
a ``file://`` store under ``tmp_path``) running every case
(``tests/_torch_mesh_ranks.py``); the test functions read its results.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as R
from repro.core import acquisition as racq
from repro.core.budget import rules_from_config as r_rules_from_config
from repro.configs.pal_potential import PALRunConfig as RCfg
from repro_torch.configs.pal_potential import PALRunConfig
from repro_torch.core import acquisition as tacq
from repro_torch.core import budget as tbud
from repro_torch.core import selection as tsel
from repro_torch.core.committee import params_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch import distributed
from repro_torch.launch.mesh import make_host_mesh

SHAPES = {"data2": (2, 1), "model2": (1, 2), "data2model2": (2, 2)}
# ROADMAP's tolerances; the mean takes the std's atol too: a mean entry
# near 0 differs by ~5e-8 between the frameworks (and between batch sizes
# in PyTorch's CPU matmul), above rtol 1e-5 of itself
TOL = dict(mean=(1e-5, 1e-6), std=(1e-4, 1e-6))


def _inputs():
    r = np.random.RandomState(11)
    B, T, S, H, KV, Dh = 2, 1, 64, 8, 2, 16
    return {"ws": R.weights(),
            "q": r.randn(B, T, H, Dh).astype(np.float32),
            "k": r.randn(B, S, KV, Dh).astype(np.float32),
            "v": r.randn(B, S, KV, Dh).astype(np.float32),
            "kv_len": np.array([40, 63], np.int32)}


@pytest.fixture(scope="module")
def w():
    return _inputs()


@pytest.fixture(scope="module")
def unsharded(w):
    return R.cases(None, w)


@pytest.fixture(scope="module")
def ranks(w, tmp_path_factory):
    """Each mesh's per-rank results, spawned once per mesh at first use."""
    cache = {}

    def get(name):
        if name not in cache:
            shape = SHAPES[name]
            store = tmp_path_factory.mktemp(name) / "store"
            cache[name] = distributed.launch_local(
                shape[0] * shape[1], R.cases, shape, w,
                init_method=f"file://{store}", timeout=300)
        return cache[name]
    return get


def _reference_scores(ws, rounds):
    """The reference's unsharded FusedEngine(impl='xla') over the same
    rounds, with the same budget + re-weighting pipeline."""
    cp = {k: jnp.asarray(v) for k, v in ws.items()}
    rules = r_rules_from_config(RCfg(std_threshold=R.THRESHOLD,
                                     oracle_budget=0.3, reweight_buckets=32))
    e = racq.FusedEngine(lambda p, x: jnp.tanh(x @ p["w1"]) @ p["w2"], cp,
                         R.THRESHOLD, rules=rules, impl="xla")
    return [R.uq(e.score(list(x))) for x in rounds]


def _score_rounds():
    rng = np.random.RandomState(1)
    return [rng.randn(61, R.D).astype(np.float32) for _ in range(4)]


def _assert_uq_close(got, want, thr=R.THRESHOLD):
    mean, sstd, cstd, mask = got
    np.testing.assert_allclose(mean, want[0], *TOL["mean"])
    np.testing.assert_allclose(sstd, want[1], *TOL["std"])
    np.testing.assert_allclose(cstd, want[2], *TOL["std"])
    rtol, atol = TOL["std"]
    far = np.abs(want[1] - thr) > atol + rtol * np.abs(want[1])
    np.testing.assert_array_equal(mask[far], want[3][far])


def _assert_uq_equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# test_mesh_parity.py, on gloo meshes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(SHAPES))
def test_score_bitidentical_with_stateful_rules(name, ranks, unsharded, w):
    """4 advancing rounds: outputs within tolerance of the unsharded
    engine (the port's and the reference's), masks exact off the
    threshold, and the BudgetRule/RollingReweightRule state equal, on
    every rank."""
    ref = _reference_scores(w["ws"], _score_rounds())
    for out in ranks(name):
        for got, want, jwant in zip(out["score"], unsharded["score"], ref):
            _assert_uq_close(got, want)
            _assert_uq_close(got, jwant)
        for a, b in zip(out["score_state"], unsharded["score_state"]):
            np.testing.assert_array_equal(a, b)
        # one program per bucket on every rank
        assert out["trace_counts"] == unsharded["trace_counts"]


@pytest.mark.parametrize("name", list(SHAPES))
def test_score_ndarray_fastpath_matches_list(name, ranks):
    for out in ranks(name):
        _assert_uq_equal(out["fast"], out["listed"])


@pytest.mark.parametrize("name", list(SHAPES))
def test_rule_state_checkpoint_roundtrip_on_mesh(name, ranks):
    """state_dict taken from a mesh engine restores onto a fresh mesh
    engine (replicated) and scoring continues identically."""
    for out in ranks(name):
        _assert_uq_equal(*out["ckpt"])
        for a, b in zip(*out["ckpt_state"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(SHAPES))
def test_zero_extra_host_bytes_on_mesh(name, ranks, unsharded):
    """Every rank moves exactly the unsharded engine's host bytes (the
    batch up, the packed statistics down); gloo on the CPU stages
    nothing."""
    for out in ranks(name):
        assert out["bytes"] == unsharded["bytes"]
        assert out["bytes"][2] == 0


@pytest.mark.parametrize("name", list(SHAPES))
def test_committee_and_rows_split_over_the_mesh(name, ranks):
    """Each rank holds K / model members; the resolved grid forms."""
    shape = SHAPES[name]
    for out in ranks(name):
        assert out["members"] == R.K // shape[1]
        assert out["train_local"] == R.K // shape[1]
        assert out["resolved"] == {
            "scaleout": {"data": shape[0] * shape[1], "model": 1},
            f"{shape[0]}x{shape[1]}": {"data": shape[0],
                                       "model": shape[1]}}


@pytest.mark.parametrize("name", list(SHAPES))
def test_fleet_score_after_and_carry_parity(name, ranks, unsharded):
    """Device-resident fleet: 4 fused advance+score+select steps (a
    poisoned walker on the second rank's rows) and the carry checkpoint
    round trip, against the unsharded fleet."""
    for out in ranks(name):
        for (n0, s0, m0), (n1, s1, m1) in zip(unsharded["fleet"],
                                              out["fleet"]):
            assert n0 == n1
            np.testing.assert_allclose(s1, s0, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(m1, m0, rtol=1e-5, atol=1e-6)
        for k, v in unsharded["fleet_state"].items():
            np.testing.assert_allclose(out["fleet_state"][k], v,
                                       rtol=1e-5, atol=1e-6)
        assert out["fleet_stats"] == unsharded["fleet_stats"]
        assert out["fleet_stats"]["nan_resets"] == 1
        np.testing.assert_allclose(out["fleet_positions"],
                                   unsharded["fleet_positions"],
                                   rtol=1e-5, atol=1e-6)
        # carry restore keeps the rank's rows and continues identically
        np.testing.assert_array_equal(*out["fleet_resumed"])


@pytest.mark.parametrize("name", ["data2"])
def test_trainer_bitidentical_on_data_axis_mesh(name, ranks, unsharded):
    """Losses, params, optimizer state after 3 steps on the (2, 1) mesh
    equal the unsharded trainer's bit for bit; a mesh checkpoint restores
    onto a fresh mesh trainer and the next round stays identical."""
    for out in ranks(name):
        np.testing.assert_array_equal(out["train_loss"],
                                      unsharded["train_loss"])
        for k, v in unsharded["train_params"].items():
            np.testing.assert_array_equal(out["train_params"][k], v)
        la, lb, pa, pb = out["train_resumed"]
        np.testing.assert_array_equal(la, lb)
        np.testing.assert_array_equal(la, unsharded["train_resumed"][0])
        for k in pa:
            np.testing.assert_array_equal(pa[k], pb[k])


@pytest.mark.parametrize("name", ["model2", "data2model2"])
def test_trainer_model_axis_ulp_bounded(name, ranks, unsharded):
    """Committee-axis meshes: each rank trains its own members; losses and
    params within the reference's own bound for this axis (rtol 1e-5,
    atol 1e-6), the gathered whole committee on every rank."""
    for out in ranks(name):
        np.testing.assert_allclose(out["train_loss"],
                                   unsharded["train_loss"], rtol=1e-5)
        for k, v in unsharded["train_params"].items():
            np.testing.assert_allclose(out["train_params"][k], v,
                                       rtol=1e-5, atol=1e-6)
        la, lb, pa, pb = out["train_resumed"]
        np.testing.assert_array_equal(la, lb)
        for k in pa:
            np.testing.assert_array_equal(pa[k], pb[k])


@pytest.mark.parametrize("name", list(SHAPES))
def test_int8_moments_on_mesh_trainer(name, ranks, unsharded):
    """The int8 memory policy's quantized moments gather and restore over
    the committee axis like any leaf (``test_memory_policy.py:339`` on a
    real mesh)."""
    for out in ranks(name):
        for a, b in zip(out["train_int8"], unsharded["train_int8"]):
            np.testing.assert_allclose(np.asarray(a, np.float64),
                                       np.asarray(b, np.float64),
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", list(SHAPES))
def test_serving_queue_parity(name, ranks, unsharded):
    for out in ranks(name):
        for a, b in zip(out["queue"], unsharded["queue"]):
            np.testing.assert_allclose(a, b, rtol=1e-5)


@pytest.mark.parametrize("name", ["model2", "data2model2"])
def test_k3_committee_on_2way_mesh_warns_and_matches(name, ranks, w):
    """A K=3 committee over a 2-way model axis cannot split the committee:
    the layout degrades LOUDLY (the reference's WARNING text) and still
    scores as the unsharded engine."""
    e0 = tacq.FusedEngine(R.apply, params_from_numpy(R.weights(3), "cpu"),
                          R.THRESHOLD, device="cpu")
    xs = np.random.RandomState(9).randn(32, R.D).astype(np.float32)
    want = R.uq(e0.score(xs, advance=False))
    for out in ranks(name):
        assert any("sharding fallback" in m and "committee" in m
                   for m in out["k3_warnings"]), out["k3_warnings"]
        _assert_uq_close(out["k3"], want)


@pytest.mark.parametrize("name", list(SHAPES))
def test_twin_gathers_match_and_release_restores_groups(name, ranks):
    """A twin of the mesh (process groups of its own, one per axis line
    of size > 1, as a lane makes) gathers the mesh's bits with the same
    staged bytes over every set of axes, float32, int32 and bool; its
    ``release`` destroys exactly the groups it made (a rank holds one
    per axis of size > 1: its own line's), a second ``release`` does
    nothing, and a gather on the released twin raises."""
    lines = sum(1 for n in SHAPES[name] if n > 1)
    for o in ranks(name):
        t = o["twin"]
        for case, r in t["gathers"].items():
            np.testing.assert_array_equal(r["mesh"], r["twin"],
                                          err_msg=str(case))
            assert r["bytes"][0] == r["bytes"][1], case
        before, with_twin, released, again = t["groups"]
        assert with_twin - before == lines
        assert released == again == before
        assert t["released_error"] is not None


def test_resolve_mesh_grid_form():
    """Without a process group the world is this process: '1x1' and
    'host' are 1x1 meshes; a grid larger than the world raises, as does a
    malformed name (the 2- and 4-rank forms: ``test_committee_and_rows_
    split_over_the_mesh``)."""
    assert dict(tacq.resolve_mesh(PALRunConfig(uq_mesh="1x1")).shape) == \
        {"data": 1, "model": 1}
    assert tacq.resolve_mesh(PALRunConfig(uq_mesh="")) is None
    with pytest.raises(ValueError, match="ranks"):
        tacq.resolve_mesh(PALRunConfig(uq_mesh="2x4"))
    with pytest.raises(ValueError, match="256"):
        tacq.resolve_mesh(PALRunConfig(uq_mesh="production"))
    with pytest.raises(ValueError, match="uq_mesh"):
        tacq.resolve_mesh(PALRunConfig(uq_mesh="3z"))


# ---------------------------------------------------------------------------
# kv_seq_shard attention on a split cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(SHAPES))
def test_kv_seq_shard_merged_partials_equal_plain(name, ranks, w):
    """Each rank's split_kv partials over its key range, all-gathered and
    merged, equal the plain attention over the whole cache (causal with
    kv_len, a sliding window, no mask)."""
    n = SHAPES[name][0] * SHAPES[name][1]
    q, k, v, kv_len = (torch.from_numpy(w[x]) for x in
                       ("q", "k", "v", "kv_len"))
    S = k.shape[1]
    wants = {
        "causal": ops.plain_attention(q, k, v, q_offset=int(kv_len.max()) - 1,
                                      kv_len=kv_len),
        "window": ops.plain_attention(q, k, v, window=20, q_offset=S - 1),
        "full": ops.plain_attention(q, k, v, causal=False)}
    outs = ranks(name)
    assert sorted(o["kv_range"] for o in outs) == \
        [(i * S // n, (i + 1) * S // n) for i in range(n)]
    for out in outs:
        for case, want in wants.items():
            np.testing.assert_allclose(out["attn_" + case], want.numpy(),
                                       rtol=1e-5, atol=1e-6)


def test_kv_seq_shard_partials_model_merges_ranges():
    """In one process: two ranks' single-split partials (q_offset and
    kv_len shifted to each range's start) merged in rank order equal the
    whole cache's plain attention and the split model."""
    g = torch.Generator().manual_seed(3)
    B, T, S, H, KV, Dh = 3, 2, 48, 8, 2, 16
    q = torch.randn(B, T, H, Dh, generator=g)
    k, v = torch.randn(2, B, S, KV, Dh, generator=g)
    kv_len = torch.tensor([47, 20, 30], dtype=torch.int32)
    parts = []
    for r in range(2):
        lo = r * S // 2
        parts.append(fa.split_kv_partials(
            q, k[:, lo:lo + S // 2], v[:, lo:lo + S // 2], splits=1,
            keys_per_split=S // 2, q_offset=S - 2 - lo,
            kv_len=(kv_len - lo).clamp(min=0)))
    m, l, acc = (torch.cat(x) for x in zip(*parts))
    got = fa.combine_partials(m, l, acc, q.dtype)
    want = ops.plain_attention(q, k, v, q_offset=S - 2, kv_len=kv_len)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(
        got, fa.split_kv_model(q, k, v, splits=2, keys_per_split=S // 2,
                               q_offset=S - 2, kv_len=kv_len),
        rtol=1e-6, atol=1e-6)
    # the kernel's flat layout round trip
    packed = fa.pack_partials(*parts[0])
    for a, b in zip(fa.unpack_partials(packed, B, T, H, KV, Dh, 1),
                    parts[0]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Host-mesh cases (1x1, in this process)
# ---------------------------------------------------------------------------


def _host_committee(seed):
    """test_serving_queue.py's committee: K=5 linear members."""
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(5, 6, 3).astype(np.float32)}


def _rows(n, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(6) * scale).astype(np.float32) for _ in range(n)]


def _lin(p, x):
    return x @ p["w"]


def test_engine_1x1_matches_reference_unsharded(w):
    """The 1x1 mesh engine against the reference's unsharded
    FusedEngine(impl='xla') on the same weights, rules and rounds."""
    rules = tbud.rules_from_config(PALRunConfig(
        std_threshold=R.THRESHOLD, oracle_budget=0.3, reweight_buckets=32))
    e = tacq.FusedEngine(R.apply, params_from_numpy(w["ws"], "cpu"),
                         R.THRESHOLD, rules=rules, mesh=make_host_mesh(),
                         device="cpu")
    rounds = _score_rounds()
    for got, want in zip((R.uq(e.score(list(x))) for x in rounds),
                         _reference_scores(w["ws"], rounds)):
        _assert_uq_close(got, want)


def test_sharded_host_mesh_identical_selection_results():
    """On make_host_mesh() the mesh engine gives the unsharded engine's
    SelectionResults bit for bit across shape buckets, stateful rule state
    included, one program per bucket; and the reference's within
    tolerance."""
    ws = _host_committee(8)

    def rules():
        return (tbud.RollingReweightRule(n_buckets=8),
                tbud.BudgetRule(target=0.25, thr_init=0.4, horizon=8))

    def jrules():
        from repro.core import budget as rbud

        return (rbud.RollingReweightRule(n_buckets=8),
                rbud.BudgetRule(target=0.25, thr_init=0.4, horizon=8))

    plain = tacq.FusedEngine(_lin, params_from_numpy(ws, "cpu"), 0.4,
                             rules=rules(), device="cpu")
    shard = tacq.FusedEngine(_lin, params_from_numpy(ws, "cpu"), 0.4,
                             rules=rules(), mesh=make_host_mesh(),
                             device="cpu")
    ref = racq.FusedEngine(lambda p, x: x @ p["w"],
                           {"w": jnp.asarray(ws["w"])}, 0.4,
                           rules=jrules(), impl="xla")
    for r, n in enumerate((13, 8, 33, 13, 5)):
        rows = _rows(n, seed=50 + r, scale=1.5)
        a = plain.score(rows, stream=r % 2)
        b = shard.score(rows, stream=r % 2)
        _assert_uq_equal(R.uq(a), R.uq(b))
        _assert_uq_close(R.uq(b), R.uq(ref.score(rows, stream=r % 2)),
                         thr=0.4)
        ra = tsel.selection_from_uq(rows, a)
        rb = tsel.selection_from_uq(rows, b)
        np.testing.assert_array_equal(ra.uncertain_mask, rb.uncertain_mask)
        for x, y in zip(ra.inputs_to_oracle, rb.inputs_to_oracle):
            np.testing.assert_array_equal(x, y)
    for x, y in zip(R._leaves(plain.state_dict()),
                    R._leaves(shard.state_dict())):
        np.testing.assert_array_equal(x, y)
    assert plain.trace_counts == shard.trace_counts
    assert all(c == 1 for c in shard.trace_counts.values())


def test_sharded_engine_places_params_and_batch_on_mesh():
    eng = tacq.FusedEngine(_lin, params_from_numpy(_host_committee(9),
                                                   "cpu"),
                           0.4, mesh=make_host_mesh(), device="cpu")
    assert dict(eng.mesh.shape) == {"data": 1, "model": 1}
    # the committee keeps every member on a 1-ary model axis; rows whole
    assert eng.cparams["w"].shape[0] == 5 and eng.size == 5
    assert eng.rows_of(8) == (0, 8)
    assert eng.score(_rows(4, seed=10)).mask.shape == (4,)


def test_sharded_engine_refresh_keeps_layout():
    from repro_torch.core.weight_sync import WeightStore

    eng = tacq.FusedEngine(_lin, params_from_numpy(_host_committee(11),
                                                   "cpu"),
                           0.4, mesh=make_host_mesh(), device="cpu")
    ptr = eng.cparams["w"].data_ptr()
    store = WeightStore(5)
    w_new = np.random.RandomState(12).randn(5, 18).astype(np.float32)
    for i in range(5):
        store.publish_packed(i, w_new[i])
    assert eng.refresh_from(store) == 1
    assert eng.cparams["w"].data_ptr() == ptr
    np.testing.assert_allclose(eng.cparams["w"].numpy().reshape(5, -1),
                               w_new, rtol=1e-6)


def test_make_engine_resolves_uq_mesh_knob():
    cfg = PALRunConfig(std_threshold=0.4, uq_impl="xla", uq_mesh="host")
    eng = tacq.make_engine(cfg, committee=tacq.CommitteeSpec(
        _lin, params_from_numpy(_host_committee(13), "cpu")), device="cpu")
    assert isinstance(eng, tacq.FusedEngine)
    assert eng.mesh is not None and dict(eng.mesh.shape) == \
        {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="uq_mesh"):
        tacq.resolve_mesh(PALRunConfig(uq_mesh="nope"))


def test_host_mesh_train_step_bit_identical_to_unsharded(w):
    """test_committee_trainer.py:140: the 1x1 mesh trainer's params and
    moments equal the unsharded trainer's bit for bit."""
    plain = R._trainer(w["ws"], None, steps=9)
    hosted = R._trainer(w["ws"], make_host_mesh(), steps=9)
    for t in (plain, hosted):
        t.train()
    for key in ("w1", "w2"):
        assert torch.equal(plain.cparams[key], hosted.cparams[key])
        assert torch.equal(plain.cstate.opt.mu[key],
                           hosted.cstate.opt.mu[key])


def test_host_mesh_int8_bit_identical_to_unsharded(w):
    """test_memory_policy.py:339: the 1x1 mesh does not perturb quantized
    training."""
    plain = R._trainer(w["ws"], None, policy="int8", steps=6)
    hosted = R._trainer(w["ws"], make_host_mesh(), policy="int8", steps=6)
    for t in (plain, hosted):
        t.train()
    for a, b in zip(R._leaves(plain.state_dict()["cstate"]),
                    R._leaves(hosted.state_dict()["cstate"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_pal_on_the_host_mesh_runs_unsharded(tmp_path):
    """PAL(uq_mesh='host') builds its engine and trainer on the 1x1 mesh,
    the unsharded program with no lanes (PAL on meshes of two processes:
    ``tests/test_torch_mesh_pal.py``)."""
    from repro_torch.core import PAL

    cfg = PALRunConfig(result_dir=str(tmp_path), uq_mesh="host",
                       std_threshold=0.4)

    def loss_fn(p, b):
        loss = torch.mean((b["x"] @ p["w"] - b["y"]) ** 2)
        return loss, {"loss": loss}

    pal = PAL(cfg, make_generator=lambda rank, rd: None,
              make_oracle=lambda rank, rd: None,
              committee=tacq.CommitteeSpec(
                  _lin, params_from_numpy(_host_committee(14), "cpu")),
              loss_fn=loss_fn, device="cpu")
    assert dict(pal.engine.mesh.shape) == {"data": 1, "model": 1}
    assert pal.committee_trainer.mesh is pal.engine.mesh
    assert pal.leader and pal._engine_lane is None
