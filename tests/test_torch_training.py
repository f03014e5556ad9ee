"""The port's committee-training slice (``repro_torch.training``,
``repro_torch.data.replay``, ``models/potential.potential_loss``) against
the reference on the same numpy inputs and weights.  Mirrors
tests/test_committee_trainer.py and tests/test_memory_policy.py.

The port's minibatch draw is its own counter-based hash (JAX's threefry is
not reproduced), so the parity runs replay the port's
``minibatch_indices`` into the reference's per-member ``make_train_step``,
as the reference's own fused-vs-sequential test does with its draws.

Tolerances: the fused trainer at the reference test's shape against the
reference's sequential steps: params rtol 1e-5 atol 1e-5; the potential
loss's parameter gradients (a double backward): rtol 1e-4 atol 1e-6; the
fused trainer on the potential loss: per-step losses rtol 1e-4 over 12
steps; bf16 and int8 final losses against fp32: rtol 0.15 atol 5e-3 (the
reference's own gate); snapshots, quarantine and restores: bit for bit.
Not mirrored here: the two host-mesh tests (they fail in the reference;
tests/test_torch_mesh.py holds the 1x1 mesh trainer against the unsharded
one) and the PAL-runtime tests (tests/test_torch_runtime.py).
"""
import contextlib
import dataclasses
import logging
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.pal_potential import PotentialConfig as JPotentialConfig
from repro.core import committee as jcmte
from repro.models import potential as jpot
from repro.training.committee_trainer import CommitteeTrainer as JTrainer
from repro.training.committee_trainer import (
    default_train_config as jdefault_train_config,
)
from repro.training.train_step import make_train_state as jmake_state
from repro.training.train_step import make_train_step as jmake_step
from repro_torch.checkpoint import BF16Bits
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.pal_potential import PotentialConfig
from repro_torch.core import acquisition as tacq
from repro_torch.core import committee as tcmte
from repro_torch.core.monitor import Monitor
from repro_torch.data.replay import ReplayTrainingBuffer
from repro_torch.models import potential as tpot
from repro_torch.optim.adamw import QTensor
from repro_torch.optim.memory_policy import MemoryPolicy
from repro_torch.training import (
    CommitteeTrainer, default_train_config, make_eval_step, make_train_state,
    make_train_step, state_dict_from_reference,
)
from repro_torch.training import committee_trainer as ct

K, IN_DIM, HIDDEN, OUT_DIM = 4, 6, 16, 3
POLICIES = ("fp32", "bf16", "int8")
PARAM_TOL = dict(rtol=1e-5, atol=1e-5)


def _members_np(seed=0, k=K):
    rng = np.random.RandomState(seed)
    return [{
        "w1": rng.randn(IN_DIM, HIDDEN).astype(np.float32) * .3,
        "b1": rng.randn(HIDDEN).astype(np.float32) * .1,
        "w2": rng.randn(HIDDEN, OUT_DIM).astype(np.float32) * .3,
        "b2": rng.randn(OUT_DIM).astype(np.float32) * .1,
    } for _ in range(k)]


def _cparams(seed=0, k=K):
    return tcmte.stack_members([tcmte.params_from_numpy(m, "cpu")
                                for m in _members_np(seed, k)])


def _data(n=40, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, IN_DIM).astype(np.float32),
            rng.randn(n, OUT_DIM).astype(np.float32))


def _apply(p, x):
    return torch.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def _loss(p, batch):
    return torch.mean((_apply(p, batch["x"]) - batch["y"]) ** 2), {}


def _japply(p, x):
    return jnp.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def _jloss(p, batch):
    return jnp.mean((_japply(p, batch["x"]) - batch["y"]) ** 2), {}


def _trainer(cparams=None, policy=None, **kw):
    kw.setdefault("steps", 10)
    kw.setdefault("batch", 8)
    kw.setdefault("lr", 1e-2)
    kw.setdefault("replay_capacity", 64)
    kw.setdefault("seed", 0)
    return CommitteeTrainer(_loss, _cparams() if cparams is None else cparams,
                            memory_policy=policy, device="cpu", **kw)


def _host_leaves_equal(a, b):
    def norm(x):
        if isinstance(x, BF16Bits):
            return ("bf16", x.bits)
        return ("arr", np.asarray(x))
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(
        norm(x)[0] == norm(y)[0] and np.array_equal(norm(x)[1], norm(y)[1])
        for x, y in zip(la, lb))


def _state_equal(t1, t2):
    l1, l2 = pytree.tree_leaves(t1.cstate), pytree.tree_leaves(t2.cstate)
    return len(l1) == len(l2) and all(
        a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(l1, l2))


# ---------------------------------------------------------------------------
# parity against the reference's per-member step
# ---------------------------------------------------------------------------


def _sequential_reference(members, xs, ys, idx, tcfg, jloss=_jloss):
    """The reference's make_train_step, member by member, on the port's
    data order; returns each member's final params and per-step losses."""
    step = jax.jit(jmake_step(jloss, tcfg))
    out, losses = [], []
    for i, m in enumerate(members):
        st = jmake_state(jax.tree.map(jnp.asarray, m), tcfg)
        li = []
        for t in range(len(idx)):
            st, met = step(st, {"x": jnp.asarray(xs[idx[t][i]]),
                                "y": jnp.asarray(ys[idx[t][i]])})
            li.append(float(met["loss"]))
        out.append(jax.tree.map(np.asarray, st.params))
        losses.append(li)
    return out, np.asarray(losses).T            # (steps, K)


def test_fused_matches_sequential_per_member_training():
    """The reference test's shape (K 4, 6->16->3, 12 steps, lr 1e-2): the
    one-program vmapped step trains each member as the reference's
    sequential per-member loop does on the same data order."""
    members = _members_np()
    xs, ys = _data()
    steps = 12
    tr = _trainer(_cparams(), bootstrap=True, seed=5)
    tr.add_blocks(list(zip(xs, ys)))
    idx = [tr.minibatch_indices(t, len(xs)) for t in range(steps)]
    tr.train(steps=steps)
    want, _ = _sequential_reference(members, xs, ys, idx,
                                    jdefault_train_config(1e-2))
    for i in range(K):
        for key in ("w1", "b1", "w2", "b2"):
            np.testing.assert_allclose(tr.cparams[key][i].numpy(),
                                       want[i][key], **PARAM_TOL)
    assert not np.allclose(tr.cparams["w1"][0].numpy(), members[0]["w1"])


def test_train_step_accum_and_bf16_compression_match_reference():
    """make_train_step stays a per-member function: accum_steps=2 and the
    bf16 gradient cast, with a warmup cosine schedule, step by step."""
    m = _members_np()[0]
    xs, ys = _data(16, seed=3)
    kw = dict(learning_rate=5e-3, schedule="cosine", warmup_steps=3,
              decay_steps=12, accum_steps=2, grad_compression="bf16",
              weight_decay=0.1)
    jstep = jax.jit(jmake_step(_jloss, JTrainConfig(**kw)))
    tstep = make_train_step(_loss, TrainConfig(**kw))
    jst = jmake_state(jax.tree.map(jnp.asarray, m), JTrainConfig(**kw))
    tst = make_train_state(tcmte.params_from_numpy(m, "cpu"),
                           TrainConfig(**kw))
    for t in range(5):
        sl = slice(t % 2, t % 2 + 8)
        jst, jm = jstep(jst, {"x": jnp.asarray(xs[sl]),
                              "y": jnp.asarray(ys[sl])})
        tst, tm = tstep(tst, {"x": torch.from_numpy(xs[sl]),
                              "y": torch.from_numpy(ys[sl])})
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5)
    for k in m:
        np.testing.assert_allclose(tst.params[k].numpy(),
                                   np.asarray(jst.params[k]), **PARAM_TOL)
    assert int(tst.step) == 5
    ev = make_eval_step(_loss)(tst.params, {"x": torch.from_numpy(xs),
                                            "y": torch.from_numpy(ys)})
    assert ev == {}


# ---------------------------------------------------------------------------
# the potential: oracles, the loss's double backward, the fused trainer
# ---------------------------------------------------------------------------

SMALL = dict(n_atoms=4, hidden=(16, 16), n_rbf=8)
PCFG, JPCFG = PotentialConfig(**SMALL), JPotentialConfig(**SMALL)


def _geometries(n, seed):
    rng = np.random.RandomState(seed)
    lattice = np.stack(np.meshgrid([0, 1.3], [0, 1.3], [0, 1.3]),
                       -1).reshape(-1, 3)[:PCFG.n_atoms]
    return (lattice[None] + rng.randn(n, PCFG.n_atoms, 3)
            * rng.uniform(0.02, 0.08, (n, 1, 1))).astype(np.float32)


def _jmember_params(seed):
    return jax.tree.map(np.asarray, jpot.init(JPCFG, jax.random.PRNGKey(seed)))


def test_oracles_match_reference():
    for c in _geometries(4, 0):
        for tf, jf in ((tpot.lj_energy_forces, jpot.lj_energy_forces),
                       (tpot.morse_energy_forces, jpot.morse_energy_forces)):
            te, tfo = tf(torch.from_numpy(c))
            je, jfo = jf(jnp.asarray(c))
            np.testing.assert_allclose(float(te), float(je), rtol=1e-5)
            np.testing.assert_allclose(tfo.numpy(), np.asarray(jfo),
                                       rtol=1e-4, atol=1e-5)


def _labels(coords):
    e, f = jax.vmap(jpot.lj_energy_forces)(jnp.asarray(coords))
    return np.array(e, np.float32), np.array(f, np.float32)


def test_potential_loss_grads_match_reference():
    """grad over the params of a loss whose force term is itself a grad
    over the coordinates (a double backward)."""
    coords = _geometries(6, 1)
    e, f = _labels(coords)
    p = _jmember_params(3)
    jb = {"coords": jnp.asarray(coords), "energy": jnp.asarray(e),
          "forces": jnp.asarray(f)}
    tb = {"coords": torch.from_numpy(coords), "energy": torch.from_numpy(e),
          "forces": torch.from_numpy(f)}
    (jl, jaux), jg = jax.value_and_grad(
        lambda q: jpot.potential_loss(q, jb, JPCFG), has_aux=True)(
            jax.tree.map(jnp.asarray, p))
    tg, (tl, taux) = torch.func.grad_and_value(
        lambda q: tpot.potential_loss(q, tb, PCFG), has_aux=True)(
            tcmte.params_from_numpy(p, "cpu"))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    for k in ("e_mse", "f_mse"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-4)
    for k in p:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   rtol=1e-4, atol=1e-6)
    # no input sits at the descriptors' clamp boundary (d == r_cut)
    d = np.linalg.norm(coords[:, :, None] - coords[:, None], axis=-1)
    assert np.abs(d - PCFG.r_cut).min() > 1e-3


def _pot_loss(p, b):
    n = b["x"].shape[0]
    return tpot.potential_loss(p, {
        "coords": b["x"].reshape(n, PCFG.n_atoms, 3), "energy": b["y"][:, 0],
        "forces": b["y"][:, 1:].reshape(n, PCFG.n_atoms, 3)}, PCFG)


def _jpot_loss(p, b):
    n = b["x"].shape[0]
    return jpot.potential_loss(p, {
        "coords": b["x"].reshape(n, JPCFG.n_atoms, 3), "energy": b["y"][:, 0],
        "forces": b["y"][:, 1:].reshape(n, JPCFG.n_atoms, 3)}, JPCFG)


def test_fused_potential_trainer_losses_match_reference_per_step():
    coords = _geometries(48, 2)
    e, f = _labels(coords)
    xs = coords.reshape(48, -1)
    ys = np.concatenate([e[:, None], f.reshape(48, -1)], axis=1)
    members = [_jmember_params(10 + i) for i in range(3)]
    cp = tcmte.stack_members([tcmte.params_from_numpy(m, "cpu")
                              for m in members])
    tr = CommitteeTrainer(_pot_loss, cp, batch=8, lr=1e-3, seed=4,
                          replay_capacity=64, device="cpu")
    tr.add_blocks(list(zip(xs, ys)))
    steps = 12
    idx = [tr.minibatch_indices(t, 48) for t in range(steps)]
    got = np.stack([tr.train(steps=1)["loss"] for _ in range(steps)])
    _, want = _sequential_reference(members, xs, ys, idx,
                                    jdefault_train_config(1e-3), jloss=_jpot_loss)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1].mean() < got[0].mean()


def test_policy_parity_full_schedule_same_data_order():
    """bootstrap=False: every policy sees the same minibatches; bf16 and
    int8 moments track the fp32 loss over a full schedule (the reference's
    gate)."""
    rng = np.random.RandomState(1)
    xs = rng.randn(48, IN_DIM).astype(np.float32)
    ys = np.tile(np.sin(2 * xs[:, :1]), (1, OUT_DIM)).astype(np.float32)
    batch = {"x": torch.from_numpy(xs), "y": torch.from_numpy(ys)}

    def full_loss(tr):
        return np.array([float(_loss(tcmte.member(tr.cparams, i), batch)[0])
                         for i in range(K)])

    final = {}
    for policy in POLICIES:
        tr = _trainer(policy=policy, bootstrap=False, seed=3)
        tr.add_blocks(list(zip(xs, ys)))
        before = full_loss(tr)
        tr.train(steps=30)
        final[policy] = full_loss(tr)
        assert np.all(final[policy] < before)
    for policy in ("bf16", "int8"):
        np.testing.assert_allclose(final[policy], final["fp32"],
                                   rtol=0.15, atol=5e-3)


# ---------------------------------------------------------------------------
# the minibatch draw
# ---------------------------------------------------------------------------


def _mix32_py(h):
    h ^= h >> 16
    h = (h * 0x7FEB352D) & 0xFFFFFFFF
    h ^= h >> 15
    h = (h * 0x6C8E9CF5) & 0xFFFFFFFF
    return h ^ (h >> 16)


@pytest.mark.parametrize("step_seq", [0, 1, 77, 2 ** 31 - 1, 2 ** 40 + 5])
def test_draw_equals_python_integer_hash(step_seq):
    """The tensor hash never overflows int64: it equals the same hash in
    Python's unbounded integers."""
    seed, size, k, b = 123456789, 1000003, 3, 5
    got = ct.draw_indices(seed, torch.tensor(step_seq), torch.tensor(size),
                          k, b, True).numpy()
    base = _mix32_py((seed & 0xFFFFFFFF) ^ 0x9E3779B9)
    h0 = _mix32_py((step_seq & 0xFFFFFFFF) ^ base)
    want = [[_mix32_py(_mix32_py(h0 ^ m) ^ p) % size for p in range(b)]
            for m in range(k)]
    np.testing.assert_array_equal(got, want)


def test_bootstrap_decorrelates_member_minibatches():
    tr = _trainer(bootstrap=True, seed=2)
    idx = tr.minibatch_indices(0, 40)
    assert idx.shape == (K, tr.batch)
    assert len({tuple(r) for r in idx}) == K
    off = _trainer(bootstrap=False, seed=2).minibatch_indices(0, 40)
    assert all(np.array_equal(off[0], off[i]) for i in range(K))
    assert not np.array_equal(idx, _trainer(seed=3).minibatch_indices(0, 40))
    # an empty ring draws row 0
    assert (tr.minibatch_indices(5, 0) == 0).all()


def test_minibatch_draw_is_uniform():
    """Chi-square over 37 rows: 300 steps x 4 members x 32 positions."""
    tr = _trainer(bootstrap=True, seed=9, batch=32)
    draws = np.concatenate([tr.minibatch_indices(t, 37).reshape(-1)
                            for t in range(300)])
    assert draws.min() >= 0 and draws.max() < 37
    counts = np.bincount(draws, minlength=37)
    expect = draws.size / 37
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    assert chi2 < 80.0, chi2        # 36 dof: p ~ 3e-5 at 80
    # consecutive steps and neighbouring members are not correlated
    a = np.stack([tr.minibatch_indices(t, 37) for t in range(200)])
    same_step = np.mean(a[1:] == a[:-1])
    same_member = np.mean(a[:, 1:] == a[:, :-1])
    assert same_step < 0.06 and same_member < 0.06


def test_bootstrap_members_diverge_same_members_converge_together():
    same = tcmte.stack_members([tcmte.params_from_numpy(
        _members_np()[0], "cpu")] * K)
    xs, ys = _data()
    on = _trainer(same, bootstrap=True, seed=3)
    off = _trainer(same, bootstrap=False, seed=3)
    for t in (on, off):
        t.add_blocks(list(zip(xs, ys)))
        t.train(steps=8)
    assert not torch.equal(on.cparams["w1"][0], on.cparams["w1"][1])
    assert torch.equal(off.cparams["w1"][0], off.cparams["w1"][1])


# ---------------------------------------------------------------------------
# replay ring
# ---------------------------------------------------------------------------


def test_replay_ring_append_wraparound_and_validation():
    buf = ReplayTrainingBuffer(10, device="cpu")
    xs, ys = _data(8)
    buf.append(xs, ys)
    xb, yb, size = buf.arrays()
    assert size == 8 and tuple(xb.shape) == (10, IN_DIM)
    assert int(buf.size_dev) == 8
    np.testing.assert_array_equal(xb[:8].numpy(), xs)
    np.testing.assert_array_equal(yb[:8].numpy(), ys)
    ptr = buf._buf.data_ptr()

    xs2, ys2 = _data(5, seed=9)
    buf.append(xs2, ys2)                     # wraps: rows 8,9 then 0,1,2
    xb, yb, size = buf.arrays()
    assert size == 10 and len(buf) == 10 and int(buf.size_dev) == 10
    np.testing.assert_array_equal(xb[8:10].numpy(), xs2[:2])
    np.testing.assert_array_equal(xb[0:3].numpy(), xs2[2:])
    np.testing.assert_array_equal(yb[0:3].numpy(), ys2[2:])
    assert buf.total_added == 13 and buf.append_blocks == 2

    xs3, ys3 = _data(25, seed=11)            # only the newest rows survive
    buf.append(xs3, ys3)
    xb, _, size = buf.arrays()
    assert size == 10 and tuple(xb.shape) == (10, IN_DIM)
    assert buf._buf.data_ptr() == ptr and buf.generation == 1

    with pytest.raises(ValueError, match="row width"):
        buf.append(np.zeros((2, IN_DIM + 1), np.float32),
                   np.zeros((2, OUT_DIM), np.float32))
    with pytest.raises(ValueError, match="row width"):
        buf.append(np.zeros((2, IN_DIM), np.float32),
                   np.zeros((2, OUT_DIM + 1), np.float32))
    with pytest.raises(ValueError, match="row mismatch"):
        buf.append(xs[:3], ys[:2])


def test_replay_ring_state_roundtrip_in_place():
    buf = ReplayTrainingBuffer(6, device="cpu")
    xs, ys = _data(4)
    buf.append(xs, ys)
    sd = buf.state_dict()
    buf2 = ReplayTrainingBuffer(6, device="cpu")
    buf2.append(xs[:1] * 0, ys[:1] * 0)
    ptr, gen = buf2._buf.data_ptr(), buf2.generation
    buf2.load_state_dict(sd)                 # same shape: copied in place
    assert buf2._buf.data_ptr() == ptr and buf2.generation == gen
    xb, _, size = buf2.arrays()
    assert size == 4 and buf2.total_added == 4 and int(buf2.size_dev) == 4
    np.testing.assert_array_equal(xb[:4].numpy(), xs)
    buf2.append(xs[:3], ys[:3])              # appends continue at the cursor
    assert len(buf2) == 6


def test_replay_bf16_halves_ring_and_append_bytes():
    xs, ys = _data(32)
    buf32 = ReplayTrainingBuffer(64, device="cpu")
    buf16 = ReplayTrainingBuffer(64, dtype="bfloat16", device="cpu")
    buf32.append(xs, ys)
    buf16.append(xs, ys)
    x32, _, n32 = buf32.arrays()
    x16, _, n16 = buf16.arrays()
    assert n32 == n16 == 32
    assert x16.dtype == torch.bfloat16 and x32.dtype == torch.float32
    assert buf16._buf.nbytes * 2 == buf32._buf.nbytes
    assert buf16.bytes_to_device * 2 == buf32.bytes_to_device
    np.testing.assert_array_equal(
        x16[:n16].float().numpy(),
        torch.from_numpy(xs).to(torch.bfloat16).float().numpy())


def test_replay_snapshot_preserves_storage_dtype():
    xs, ys = _data(16)
    buf = ReplayTrainingBuffer(32, dtype="bfloat16", device="cpu")
    buf.append(xs, ys)
    sd = pickle.loads(pickle.dumps(buf.state_dict()))
    assert sd["dtype"] == "bfloat16" and isinstance(sd["x"], BF16Bits)
    fresh = ReplayTrainingBuffer(32, device="cpu")        # fp32-configured
    fresh.load_state_dict(sd)
    assert fresh.dtype == "bfloat16"                      # snapshot wins
    assert torch.equal(fresh.arrays()[0].view(torch.int16),
                       buf.arrays()[0].view(torch.int16))
    buf32 = ReplayTrainingBuffer(32, device="cpu")
    buf32.append(xs, ys)
    legacy = buf32.state_dict()
    legacy.pop("dtype")                                   # no dtype key
    into = ReplayTrainingBuffer(32, dtype="bfloat16", device="cpu")
    into.append(xs[:2], ys[:2])
    gen = into.generation
    into.load_state_dict(legacy)
    assert into.dtype == "float32" and into.generation == gen + 1


def test_replay_ring_takes_the_reference_snapshot():
    from repro.data.replay import ReplayTrainingBuffer as JRing
    xs, ys = _data(12)
    for dtype in ("float32", "bfloat16"):
        jr = JRing(16, dtype=dtype)
        jr.append(xs, ys)
        rep = jr.state_dict()
        conv = {k: (BF16Bits(np.asarray(v).view(np.uint16))
                    if k in ("x", "y") and dtype == "bfloat16" else v)
                for k, v in rep.items()}
        tr = ReplayTrainingBuffer(16, device="cpu")
        tr.load_state_dict(conv)
        assert tr.dtype == dtype and len(tr) == 12
        want = np.asarray(rep["x"]).astype(np.float32)
        np.testing.assert_array_equal(tr.arrays()[0].float().numpy(), want)


# ---------------------------------------------------------------------------
# snapshots, restores and the policy check
# ---------------------------------------------------------------------------


def test_trainer_state_dict_resumes_mid_schedule():
    xs, ys = _data()
    tr = _trainer(seed=4)
    tr.add_blocks(list(zip(xs, ys)))
    tr.train(steps=7)
    sd = tr.state_dict()
    assert np.abs(np.asarray(sd["cstate"].opt.mu["w1"])).sum() > 0
    assert int(np.asarray(sd["cstate"].step)[0]) == 7 and sd["step_seq"] == 7
    tr2 = _trainer(seed=4)
    ptrs = [t.data_ptr() for t in pytree.tree_leaves(tr2.cstate)]
    tr2.load_state_dict(sd)
    assert [t.data_ptr() for t in pytree.tree_leaves(tr2.cstate)] == ptrs
    assert int(tr2._seq_dev) == 7
    tr.train(steps=3)
    tr2.train(steps=3)
    assert _state_equal(tr, tr2)
    tr3 = _trainer(seed=4)
    tr3.add_blocks(list(zip(xs, ys)))
    tr3.train(steps=3)
    assert not torch.equal(tr2.cparams["w1"], tr3.cparams["w1"])


@pytest.mark.parametrize("policy", POLICIES)
def test_trainer_snapshot_roundtrip_bit_identical(policy):
    xs, ys = _data()
    pol = MemoryPolicy(name=policy, moments=policy,
                       replay_dtype="bfloat16" if policy != "fp32"
                       else "float32")
    tr = _trainer(policy=pol, seed=4)
    tr.add_blocks(list(zip(xs, ys)))
    tr.train(steps=5)
    wire = pickle.dumps(tr.state_dict())
    tr2 = _trainer(policy=pol, seed=4)
    tr2.load_state_dict(pickle.loads(wire))
    assert _state_equal(tr, tr2)
    assert _host_leaves_equal(tr.state_dict()["cstate"],
                              tr2.state_dict()["cstate"])
    mu = pytree.tree_leaves(tr2.cstate.opt.mu,
                            is_leaf=lambda x: isinstance(x, QTensor))
    if policy == "int8":
        assert all(isinstance(l, QTensor) and l.q.dtype == torch.int8
                   for l in mu)
    elif policy == "bf16":
        assert all(l.dtype == torch.bfloat16 for l in mu)
        snap = pickle.loads(wire)["cstate"].opt.mu["w1"]
        assert isinstance(snap, BF16Bits)
    tr.train(steps=3)
    tr2.train(steps=3)
    assert _state_equal(tr, tr2)


def test_bf16_params_roundtrip_bits():
    pol = MemoryPolicy(name="w", moments="bf16", params_dtype="bfloat16")
    xs, ys = _data()
    tr = _trainer(policy=pol)
    tr.add_blocks(list(zip(xs, ys)))
    tr.train(steps=3)
    assert tr.cparams["w1"].dtype == torch.bfloat16
    tr2 = _trainer(policy=pol)
    tr2.load_state_dict(pickle.loads(pickle.dumps(tr.state_dict())))
    assert _state_equal(tr, tr2)


def test_snapshot_policy_mismatch_raises_not_dequantizes():
    xs, ys = _data()
    tr_i8 = _trainer(policy="int8")
    tr_i8.add_blocks(list(zip(xs, ys)))
    tr_i8.train(steps=2)
    snap = tr_i8.state_dict()
    with pytest.raises(ValueError, match="memory policy"):
        _trainer(policy="fp32").load_state_dict(snap)
    with pytest.raises(ValueError, match="int8"):
        _trainer(policy="bf16").load_state_dict(snap)
    legacy = {k: v for k, v in snap.items() if k != "memory_policy"}
    with pytest.raises(ValueError, match="memory policy"):
        _trainer(policy="fp32").load_state_dict(legacy)
    ok = _trainer(policy="int8")
    ok.load_state_dict(legacy)
    assert _state_equal(tr_i8, ok)
    bf = _trainer(policy="bf16")
    legacy_bf = {k: v for k, v in bf.state_dict().items()
                 if k != "memory_policy"}
    with pytest.raises(ValueError, match="moments"):
        _trainer(policy="fp32").load_state_dict(legacy_bf)


def test_params_dtype_mismatch_raises():
    bf = MemoryPolicy(name="w", moments="fp32", params_dtype="bfloat16")
    with pytest.raises(ValueError, match="params_dtype"):
        _trainer(policy="fp32").load_state_dict(_trainer(policy=bf)
                                                .state_dict())


def test_trainer_skips_mismatched_snapshot(caplog):
    tr = _trainer()
    xs, ys = _data()
    tr.add_blocks(list(zip(xs, ys)))
    tr.train(steps=2)
    other = _trainer(_cparams(k=K + 2), steps=2, replay_capacity=16)
    before = other.cparams["w1"].clone()
    with caplog.at_level(logging.WARNING):
        other.load_state_dict(tr.state_dict())           # K mismatch
    assert torch.equal(other.cparams["w1"], before)
    assert "skipping restore" in caplog.text


@pytest.mark.parametrize("policy", POLICIES)
def test_reference_snapshot_continues_in_the_port(policy):
    """The JAX trainer trains 5 steps mid-schedule (warmup cosine); its
    snapshot goes through ``state_dict_from_reference`` into the port,
    bit for bit; 4 more port steps equal the reference's per-member step
    continued from the same snapshot on the port's data order."""
    members = _members_np(seed=6)
    xs, ys = _data(40, seed=8)
    kw = dict(learning_rate=1e-2, schedule="cosine", warmup_steps=4,
              decay_steps=20, weight_decay=0.01)
    jtr = JTrainer(_jloss, jcmte.stack_members(
        [jax.tree.map(jnp.asarray, m) for m in members]), batch=8,
        replay_capacity=64, seed=2, memory_policy=policy,
        train_cfg=JTrainConfig(**kw))
    jtr.add_blocks(list(zip(xs, ys)))
    jtr.train(steps=5)
    jsd = jtr.state_dict()
    psd = pickle.loads(pickle.dumps(state_dict_from_reference(jsd)))

    tr = CommitteeTrainer(_loss, _cparams(seed=6), batch=8,
                          replay_capacity=64, seed=2, memory_policy=policy,
                          train_cfg=TrainConfig(**kw), device="cpu")
    tr.load_state_dict(psd)
    assert tr.steps_done == 5 and tr._step_seq == 5 and len(tr.replay) == 40
    assert _host_leaves_equal(tr.state_dict()["cstate"], psd["cstate"])

    steps = 4
    idx = [tr.minibatch_indices(5 + t, 40) for t in range(steps)]
    tr.train(steps=steps)
    jstep = jax.jit(jmake_step(_jloss, JTrainConfig(
        **kw, opt_moments=policy, quantized_opt_state=policy == "int8")))
    for i in range(K):
        st = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)[i]),
                          jsd["cstate"])
        for t in range(steps):
            st, _ = jstep(st, {"x": jnp.asarray(xs[idx[t][i]]),
                               "y": jnp.asarray(ys[idx[t][i]])})
        for key in members[0]:
            np.testing.assert_allclose(tr.cparams[key][i].numpy(),
                                       np.asarray(st.params[key]),
                                       **PARAM_TOL)
        assert int(tr.cstate.step[i]) == int(st.step) == 9


# ---------------------------------------------------------------------------
# quarantine, counters, interrupts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", POLICIES)
def test_poison_quarantine_exact_under_every_policy(policy):
    xs, ys = _data()
    mon = Monitor()
    tr = _trainer(policy=policy, bootstrap=True, seed=7, monitor=mon)
    tr.add_blocks(list(zip(xs, ys)))
    tr.train(steps=3)
    ptrs = [t.data_ptr() for t in pytree.tree_leaves(tr.cstate)]
    tr.poison_member(1)
    frozen = [t[1].clone() for t in pytree.tree_leaves(tr.cstate.opt)]
    frozen_step = int(tr.cstate.step[1])
    healthy = tr.cparams["w1"][0].clone()
    out = tr.train(steps=4)
    assert not tr.last_member_ok[1] and tr.last_member_ok[[0, 2, 3]].all()
    assert not out["member_ok"][1]
    assert all(torch.equal(a, b[1]) for a, b in
               zip(frozen, pytree.tree_leaves(tr.cstate.opt)))
    assert int(tr.cstate.step[1]) == frozen_step
    assert torch.isnan(tr.cparams["w1"][1]).all()
    assert not torch.equal(tr.cparams["w1"][0], healthy)
    for i in (0, 2, 3):
        assert torch.isfinite(tr.cparams["w1"][i]).all()
    assert [t.data_ptr() for t in pytree.tree_leaves(tr.cstate)] == ptrs
    c = mon.report()["counters"]
    assert c["train.fused_steps"] == 7 and c["train.members_poisoned"] == 1
    assert c["train.member_rollbacks"] == 1
    with pytest.raises(ValueError, match="out of range"):
        tr.poison_member(K)


class _Interrupt:
    def __init__(self, after):
        self.calls, self.after = 0, after

    def test(self):
        self.calls += 1
        return self.calls >= self.after


def test_train_yields_to_interrupt_and_empty_ring():
    tr = _trainer()
    assert tr.train() == {} and tr.rounds == 0
    xs, ys = _data()
    tr.add_blocks(list(zip(xs, ys)))
    out = tr.train(interrupt=_Interrupt(3))
    assert tr.steps_done == 3 and tr.rounds == 1
    assert set(out) >= {"loss", "grad_norm", "lr", "member_ok"}
    assert out["loss"].shape == (K,) and out["lr"].dtype == np.float32
    tr.train()
    assert tr.steps_done == 13 and int(tr._seq_dev) == 13


def test_mesh_raises_not_implemented():
    # the mesh trainer is ported (tests/test_torch_mesh.py); what is left
    # to refuse is a mesh whose committee axis spans ranks with no process
    # group to gather them: the round's metrics gather raises
    from repro_torch.launch.mesh import Mesh, make_host_mesh

    xs, ys = _data()
    tr = _trainer(mesh=Mesh(np.arange(2).reshape(1, 2), ("data", "model")))
    assert tr.cparams["w1"].shape[0] == K // 2
    tr.add_blocks(list(zip(xs, ys)))
    with pytest.raises(RuntimeError, match="process group"):
        tr.train(steps=1)
    hosted = _trainer(mesh=make_host_mesh(), sharding_rules={})
    assert hosted.cparams["w1"].shape[0] == K


@contextlib.contextmanager
def _no_host_reads(monkeypatch):
    def refuse(name):
        def f(*a, **k):
            raise AssertionError(f"host read: Tensor.{name}")
        return f

    for name in ("item", "__int__", "__float__", "__bool__", "__index__",
                 "cpu", "numpy", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, refuse(name))
    try:
        yield
    finally:
        monkeypatch.undo()


@pytest.mark.parametrize("policy", POLICIES)
def test_step_program_makes_no_host_read(monkeypatch, policy):
    """The program the card captures: draw, gather, the vmapped potential
    step (a double backward), AdamW, the quarantine and the in-place
    writes read no tensor value on the host."""
    coords = _geometries(16, 5)
    e, f = _labels(coords)
    cp = tpot.init_committee(PotentialConfig(**SMALL, committee_size=3),
                             torch.Generator().manual_seed(2), device="cpu")
    tr = CommitteeTrainer(_pot_loss, cp, batch=4, replay_capacity=32,
                          memory_policy=policy, device="cpu")
    tr.add_blocks(list(zip(coords.reshape(16, -1),
                           np.concatenate([e[:, None], f.reshape(16, -1)],
                                          axis=1))))
    before = tr.cparams["w0"].clone()
    with _no_host_reads(monkeypatch):
        with pytest.raises(AssertionError, match="host read"):
            torch.ones(()).item()
        metrics = tr._program()
        tr._program()
    assert not torch.equal(before, tr.cparams["w0"])
    assert bool(metrics["member_ok"].all()) and int(tr._seq_dev) == 2


# ---------------------------------------------------------------------------
# the handoff into the engine
# ---------------------------------------------------------------------------


def test_device_weight_refresh_moves_zero_packed_host_bytes():
    xs, ys = _data()
    tr = _trainer()
    tr.add_blocks(list(zip(xs, ys)))
    tr.train(steps=5)
    engine = tacq.FusedEngine(_apply, _cparams(), 0.5, device="cpu")
    snap = tr.snapshot_cparams()
    assert snap["w1"].data_ptr() != tr.cparams["w1"].data_ptr()
    assert engine.refresh_from_device(snap) == 1
    assert engine.refresh_host_bytes == 0 and engine.device_refreshes == 1
    uq = engine.score([xs[i] for i in range(5)])
    want = np.mean([_apply(tcmte.member(tr.cparams, i),
                           torch.from_numpy(xs[:5])).numpy()
                    for i in range(K)], axis=0)
    np.testing.assert_allclose(uq.mean, want, atol=1e-5)
    tr.train(steps=2)                        # the snapshot is a copy
    assert torch.equal(snap["w1"], engine.cparams["w1"])
    assert not torch.equal(snap["w1"], tr.cparams["w1"])
    with pytest.raises(ValueError, match="committee size"):
        engine.refresh_from_device(_cparams(k=K + 1))


def test_k32_int8_trains_and_scores_through_fused_engine():
    k = 32
    cparams = _cparams(seed=2, k=k)
    pol = MemoryPolicy(name="diet", moments="int8", replay_dtype="bfloat16")
    tr = CommitteeTrainer(_loss, cparams, steps=4, batch=8, lr=1e-2,
                          replay_capacity=64, seed=0, memory_policy=pol,
                          device="cpu")
    xs, ys = _data()
    tr.add_blocks(list(zip(xs, ys)))
    out = tr.train()
    assert out["loss"].shape == (k,) and np.isfinite(out["loss"]).all()
    eng = tacq.FusedEngine(_apply, cparams, 0.05, device="cpu")
    eng.refresh_from_device(tr.snapshot_cparams())
    res = eng.score(xs[:8])
    assert res.scalar_std.shape == (8,) and np.isfinite(res.scalar_std).all()
    assert eng.refresh_host_bytes == 0
    tr.poison_member(3)                      # degraded-K statistics
    eng.refresh_from_device(tr.snapshot_cparams())
    res = eng.score(xs[:8])
    assert (res.finite_members == k - 1).all()
    assert np.isfinite(res.scalar_std).all()


def test_default_train_config_matches_reference():
    assert dataclasses.asdict(default_train_config(3e-3)) == \
        dataclasses.asdict(jdefault_train_config(3e-3))


def test_training_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CommitteeTrainer(_loss, _cparams())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ReplayTrainingBuffer(8)
    assert CommitteeTrainer(_loss, _cparams(), device="cpu").device.type \
        == "cpu"
