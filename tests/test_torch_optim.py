"""The port's optimizer slice (``repro_torch.optim``) against the reference's
(``repro.optim``) on the same numpy inputs.  Mirrors
tests/test_optim_data_ckpt.py (AdamW, schedules, clip) and
tests/test_memory_policy.py (quantization properties, policy presets,
footprint accounting).

Tolerances: schedules rtol 1e-6; ``quantize`` ``q`` equal at every entry,
``scale`` rtol 1e-7; one ``adamw_update`` per moment format: params rtol
1e-6 atol 1e-7, fp32 moments rtol 1e-6, bf16 moments within one bf16 ulp,
int8 ``q`` within +-1 (its scale rtol 1e-6); byte counts exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import memory_policy as jmp
from repro.optim.schedule import make_schedule as jmake_schedule
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import memory_policy as tmp
from repro_torch.optim.schedule import make_schedule as tmake_schedule

POLICIES = ("fp32", "bf16", "int8")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _params(seed=0):
    rng = np.random.RandomState(seed)
    return {"w1": rng.randn(6, 16).astype(np.float32) * .3,
            "b1": rng.randn(16).astype(np.float32) * .1,
            "w2": rng.randn(16, 130).astype(np.float32) * .3,
            "s": np.float32(rng.randn())}


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

SCHEDULES = {
    "constant": dict(kind="constant", base_lr=3e-3),
    "constant_warmup": dict(kind="constant", base_lr=3e-3, warmup_steps=7),
    "cosine": dict(kind="cosine", base_lr=2.0, warmup_steps=5,
                   decay_steps=50, min_lr_ratio=0.05),
    "cosine_no_warmup": dict(kind="cosine", base_lr=1e-3, decay_steps=40),
    "wsd": dict(kind="wsd", base_lr=1.0, warmup_steps=10, decay_steps=100,
                stable_steps=50, min_lr_ratio=0.1),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_reference(name):
    kw = SCHEDULES[name]
    jfn, tfn = jmake_schedule(**kw), tmake_schedule(**kw)
    steps = np.arange(0, 2 * kw.get("decay_steps", 50) + 1, dtype=np.int32)
    want = np.array([float(jfn(jnp.int32(s))) for s in steps], np.float32)
    got = np.array([float(tfn(torch.tensor(int(s), dtype=torch.int32)))
                    for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # a batched step (the trainer's (K,) counters) gives the same values
    got_b = tfn(torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got_b, want, rtol=1e-6)
    assert tfn(torch.tensor(3)).dtype == torch.float32


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="unknown schedule"):
        tmake_schedule("linear", 1.0)


# ---------------------------------------------------------------------------
# int8 block quantization
# ---------------------------------------------------------------------------

QUANT_CASES = [((7,), None), ((3, 130), 1), ((3, 130), None), ((4, 256), None),
               ((16, 6), None), ((2, 5, 48), None), ((), None), ((1,), None),
               ((128, 3), 0)]


@pytest.mark.parametrize("shape,axis", QUANT_CASES,
                         ids=[f"{s}-{a}" for s, a in QUANT_CASES])
def test_quantize_matches_reference(shape, axis):
    rng = np.random.RandomState(len(shape) * 7 + (axis or 0))
    x = np.asarray(rng.randn(*shape) * 3.0, np.float32)
    if x.size > 4:
        x.reshape(-1)[3] = 0.0
        x.reshape(-1)[:2] = 1.5          # ties of the rounding
    j = jadamw.quantize(jnp.asarray(x), axis=axis)
    t = tadamw.quantize(_t(x), axis=axis)
    assert (t.block, t.axis) == (j.block, j.axis)
    assert t.q.dtype == torch.int8 and t.scale.dtype == torch.float32
    np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
    np.testing.assert_allclose(t.scale.numpy(), np.asarray(j.scale),
                               rtol=1e-7)
    np.testing.assert_allclose(tadamw.dequantize(t).numpy(),
                               np.asarray(jadamw.dequantize(j)), rtol=1e-7)


def test_quantize_rounds_half_to_even():
    # 0.5 and 1.5 of the block's step: round half to even gives 0 and 2
    x = np.array([127.0, 0.5, 1.5, -2.5, 2.5], np.float32)
    t = tadamw.quantize(_t(x))
    np.testing.assert_array_equal(t.q.numpy(), [127, 0, 2, -2, 2])
    np.testing.assert_array_equal(
        t.q.numpy(), np.asarray(jadamw.quantize(jnp.asarray(x)).q))


@pytest.mark.parametrize("seed", range(6))
def test_quantize_roundtrip_error_bounded_by_block_scale(seed):
    rng = np.random.RandomState(seed)
    shape = (rng.randint(1, 6), rng.randint(1, 140))
    x = (rng.randn(*shape) * rng.uniform(1e-3, 10.0)
         + rng.uniform(-3, 3)).astype(np.float32)
    t = tadamw.quantize(_t(x))
    y = tadamw.dequantize(t).numpy()
    s = np.moveaxis(t.scale.numpy(), t.axis, -1)
    per = np.moveaxis(np.repeat(s, t.block, axis=-1), -1, t.axis)
    assert np.all(np.abs(x - y) <= 0.5 * per + 1e-7)
    # re-quantizing the dequantized tensor reproduces q exactly
    t2 = tadamw.quantize(tadamw.dequantize(t), axis=t.axis)
    np.testing.assert_array_equal(t.q.numpy(), t2.q.numpy())
    np.testing.assert_allclose(t.scale.numpy(), t2.scale.numpy(), rtol=1e-6)


def test_quantize_zero_constant_and_sqrt_nu_edges():
    z = tadamw.quantize(torch.zeros(3, 256))
    assert (z.q == 0).all() and (tadamw.dequantize(z) == 0).all()
    for c in (2.5, -0.125):
        t = tadamw.quantize(torch.full((4, 128), c))
        np.testing.assert_allclose(tadamw.dequantize(t).numpy(), c,
                                   rtol=1e-6)
    nu = np.concatenate([np.full(127, 1e-6), [4.0]]).astype(np.float32)
    snu = np.sqrt(nu)
    deq = tadamw.dequantize(tadamw.quantize(_t(snu))).numpy()
    assert np.max(np.abs(deq - snu)) <= 0.5 * (snu.max() / 127.0) + 1e-7
    s = tadamw.quantize(torch.tensor(-1.75))
    assert tuple(s.q.shape) == () and tuple(s.scale.shape) == ()
    np.testing.assert_allclose(float(tadamw.dequantize(s)), -1.75,
                               rtol=1e-6)


def test_qtensor_maps_under_vmap():
    """block and axis are static context: a stacked committee of quantized
    moments maps with torch.func.vmap and keeps its layout."""
    x = torch.randn(4, 3, 130)
    stacked = torch.func.vmap(tadamw.quantize)(x)
    one = tadamw.quantize(x[2])
    assert (stacked.block, stacked.axis) == (one.block, one.axis)
    assert torch.equal(stacked.q[2], one.q)
    assert torch.equal(stacked.scale[2], one.scale)


# ---------------------------------------------------------------------------
# clip and AdamW
# ---------------------------------------------------------------------------


def test_clip_by_global_norm_matches_reference():
    g = {k: v * 40 for k, v in _params(3).items()}
    jg, jn = jadamw.clip_by_global_norm(
        jax.tree.map(jnp.asarray, g), 1.0)
    tg, tn = tadamw.clip_by_global_norm({k: _t(v) for k, v in g.items()},
                                        1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for k in g:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   rtol=1e-6, atol=1e-8)
    small, _ = tadamw.clip_by_global_norm({"a": torch.full((4,), 0.01)}, 1.0)
    np.testing.assert_allclose(small["a"].numpy(), 0.01, rtol=1e-6)
    assert float(tadamw.global_norm(tg)) == pytest.approx(1.0, rel=1e-5)


def _jstate_to_torch(st):
    def conv(m):
        if isinstance(m, jadamw.QTensor):
            return tadamw.QTensor(_t(m.q), _t(m.scale), m.block, m.axis)
        return torch.from_numpy(np.array(m, np.float32)).to(
            torch.bfloat16 if m.dtype == jnp.bfloat16 else torch.float32)
    is_q = lambda x: isinstance(x, jadamw.QTensor)  # noqa: E731
    return tadamw.AdamWState(
        step=_t(st.step),
        mu=jax.tree.map(conv, st.mu, is_leaf=is_q),
        nu=jax.tree.map(conv, st.nu, is_leaf=is_q))


@pytest.mark.parametrize("moments", POLICIES)
def test_adamw_update_matches_reference(moments):
    """Three reference updates build a live state; the port takes it over
    and both apply one more update on the same grads."""
    cfg_j = jadamw.AdamWConfig(weight_decay=0.05, moments=moments)
    cfg_t = tadamw.AdamWConfig(weight_decay=0.05, moments=moments)
    params = jax.tree.map(jnp.asarray, _params(1))
    st = jadamw.adamw_init(params, moments=moments)
    rng = np.random.RandomState(2)
    grads_seq = [{k: np.asarray(rng.randn(*np.shape(v)) * 0.3, np.float32)
                  for k, v in _params(1).items()} for _ in range(4)]
    for g in grads_seq[:3]:
        params, st = jadamw.adamw_update(jax.tree.map(jnp.asarray, g), st,
                                         params, jnp.float32(1e-2), cfg_j)
    tparams = {k: _t(v) for k, v in params.items()}
    tst = _jstate_to_torch(st)
    g = grads_seq[3]
    jp, jst = jadamw.adamw_update(jax.tree.map(jnp.asarray, g), st, params,
                                  jnp.float32(1e-2), cfg_j)
    tp, tst2 = tadamw.adamw_update({k: _t(v) for k, v in g.items()}, tst,
                                   tparams, torch.tensor(1e-2), cfg_t)
    assert int(tst2.step) == int(jst.step) == 4
    for k in g:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
        for tm, jm in ((tst2.mu[k], jst.mu[k]), (tst2.nu[k], jst.nu[k])):
            if moments == "fp32":
                np.testing.assert_allclose(tm.numpy(), np.asarray(jm),
                                           rtol=1e-6)
            elif moments == "bf16":
                assert tm.dtype == torch.bfloat16
                a = tm.float().numpy()
                b = np.asarray(jm, np.float32)
                ulp = np.abs(b) * 2.0 ** -7 + 1e-30
                assert np.all(np.abs(a - b) <= ulp)
            else:
                assert (tm.block, tm.axis) == (jm.block, jm.axis)
                dq = np.abs(tm.q.numpy().astype(int)
                            - np.asarray(jm.q).astype(int))
                assert dq.max() <= 1
                np.testing.assert_allclose(tm.scale.numpy(),
                                           np.asarray(jm.scale), rtol=1e-6)


def _quadratic(moments):
    target = torch.from_numpy(np.random.RandomState(0).randn(8, 8)
                              .astype(np.float32))
    params = {"w": torch.zeros(8, 8)}
    state = tadamw.adamw_init(params, moments=moments)
    cfg = tadamw.AdamWConfig(weight_decay=0.0, moments=moments)
    grad = torch.func.grad(lambda p: torch.mean((p["w"] - target) ** 2))
    for _ in range(300):
        params, state = tadamw.adamw_update(grad(params), state, params,
                                            torch.tensor(0.05), cfg)
    return float(torch.mean((params["w"] - target) ** 2))


@pytest.mark.parametrize("moments,bound", [("fp32", 1e-3), ("bf16", 1e-2),
                                           ("int8", 5e-2)])
def test_adamw_converges_quadratic(moments, bound):
    assert _quadratic(moments) < bound


def test_resolve_moments():
    assert tadamw.resolve_moments("", True) == "int8"
    assert tadamw.resolve_moments() == "fp32"
    with pytest.raises(ValueError, match="unknown moment format"):
        tadamw.resolve_moments("int4")


# ---------------------------------------------------------------------------
# MemoryPolicy and footprint accounting
# ---------------------------------------------------------------------------


def test_policy_presets_and_validation():
    assert tmp.MemoryPolicy.named("int8").moments == "int8"
    assert tmp.resolve_policy(None) is None
    assert tmp.resolve_policy("bf16").moments == "bf16"
    p = tmp.MemoryPolicy(name="x", moments="int8", replay_dtype="bfloat16")
    assert tmp.resolve_policy(p) is p
    for name in POLICIES:
        assert (dataclasses.asdict(tmp.MemoryPolicy.named(name))
                == dataclasses.asdict(jmp.MemoryPolicy.named(name)))
    with pytest.raises(ValueError, match="unknown"):
        tmp.MemoryPolicy.named("fp16")
    with pytest.raises(ValueError, match="unknown"):
        tmp.MemoryPolicy(moments="int4")
    with pytest.raises(ValueError, match="replay_dtype"):
        tmp.MemoryPolicy(replay_dtype="float16")
    with pytest.raises(TypeError):
        tmp.resolve_policy(42)


FOOTPRINT_POLICIES = [tmp.MemoryPolicy.named(p) for p in POLICIES] + [
    tmp.MemoryPolicy(name="w", moments="int8", params_dtype="bfloat16")]


@pytest.mark.parametrize("policy", FOOTPRINT_POLICIES,
                         ids=lambda p: p.describe())
def test_member_state_nbytes_matches_reference(policy):
    m = _params(0)
    jpol = jmp.MemoryPolicy(**dataclasses.asdict(policy))
    want = jmp.member_state_nbytes(jax.tree.map(jnp.asarray, m), jpol)
    assert tmp.member_state_nbytes(m, policy) == want
    assert tmp.member_state_nbytes({k: _t(v) for k, v in m.items()},
                                   policy) == want
    assert tmp.stacked_state_nbytes(m, 64, policy) == 64 * want


@pytest.mark.parametrize("policy", POLICIES)
def test_stacked_nbytes_equal_the_trainers_buffers(policy):
    """The count from shapes and dtypes == the bytes of the stacked state
    the committee trainer allocates."""
    import torch.utils._pytree as pytree

    from repro_torch.core import committee as tcmte
    from repro_torch.training import CommitteeTrainer

    members = [{k: _t(v) for k, v in _params(s).items()} for s in range(5)]
    tr = CommitteeTrainer(lambda p, b: (torch.sum(p["w1"]), {}),
                          tcmte.stack_members(members), device="cpu",
                          memory_policy=policy, replay_capacity=8)
    measured = sum(t.numel() * t.element_size()
                   for t in pytree.tree_leaves(tr.cstate))
    assert measured == tmp.stacked_state_nbytes(members[0], 5, tr.policy)


def test_stacked_footprint_shrinks_with_policy():
    m = _params(0)
    by = {p: tmp.stacked_state_nbytes(m, 64, tmp.MemoryPolicy.named(p))
          for p in POLICIES}
    assert by["int8"] < by["bf16"] < by["fp32"]
