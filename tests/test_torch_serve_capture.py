"""The serving path's device-resident decode index and its programs, on the
CPU: ``decode_step`` of every LM family with the position as a 0-dim
tensor, the plain attention with a tensor offset, ``ServeEngine``'s eager
programs, the kernel counters' replay bookkeeping, and the oracles' CPU
paths, against the port's own host-int path and the JAX package (the
reference's ``init`` carried across by ``params_from_numpy``; the same
numpy inputs).

Mirrors tests/test_serving_and_dryrun.py's ServeEngine cases
(test_serve_engine_greedy_deterministic, test_serve_engine_temperature_
sampling_varies, test_serve_engine_matches_decode_consistency).  The card's
half (the captured graphs, the device-offset kernel, the captured oracles)
is ``tests/test_torch_serve_capture_cuda.py``, which imports no JAX.

Tolerances: tensor index against host int, bit for bit (the same ops on
the same values); against the reference's jitted decode,
``tests/test_torch_lm_zoo.py``'s fp32 logits rtol 1e-4, atol 1e-4; the
plain attention with a tensor offset against the int offset, bit for bit
(per-row offsets against one row alone: rtol = atol = 1e-6, the CPU
matmul's rounding by batch).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_config
from repro.models.model_zoo import build_model as jbuild_model
from repro_torch.configs import base as tbase
from repro_torch.core.committee import params_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref, ssd, wkv6
from repro_torch.models import model_zoo
from repro_torch.models import transformer as ttfm
from repro_torch.serving import ServeEngine

FP32 = dict(rtol=1e-4, atol=1e-4)
FAMILIES = ["dense", "moe", "rwkv6", "hybrid", "encdec", "vlm"]
B, T = 2, 12


def _tcfg(jcfg):
    return tbase.ModelConfig(**{f: getattr(jcfg, f) for f in
                                jcfg.__dataclass_fields__})


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _extras(cfg, seed=7):
    rng = np.random.RandomState(seed)
    if cfg.family == "encdec":
        return {"enc_embeds": rng.randn(B, cfg.encoder_seq, cfg.d_model
                                        ).astype(np.float32)}
    if cfg.family == "vlm":
        return {"patch_embeds": rng.randn(B, cfg.vision_tokens, cfg.d_model
                                          ).astype(np.float32)}
    return {}


def _pair(family, max_seq=40, **kw):
    jcfg = tiny_config(family, **kw)
    jm = jbuild_model(jcfg, impl="xla", max_seq=max_seq)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = model_zoo.build_model(_tcfg(jcfg), max_seq=max_seq)
    return jm, jparams, tm, params_from_numpy(jparams, "cpu")


# ---------------------------------------------------------------------------
# decode_step with the position on the device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
def test_tensor_index_decode_equals_host_int_and_the_reference(family):
    """4 decode steps teacher-forced with the reference's greedy tokens:
    the port with a 0-dim int32 index gives its host-int logits and cache
    bit for bit, and the reference's jitted decode step's logits within
    the zoo's fp32 tolerance."""
    jm, jparams, tm, tparams = _pair(family)
    cfg = tm.cfg
    n_prefix = cfg.vision_tokens if family == "vlm" else 0
    tokens = np.random.RandomState(3).randint(
        0, cfg.vocab_size, (B, T)).astype(np.int32)
    extras = _extras(cfg)
    S = n_prefix + T + 6
    jl, jcache = jax.jit(jm.prefill)(
        jparams, jnp.asarray(tokens), jm.init_cache(B, S),
        **{k: jnp.asarray(v) for k, v in extras.items()})
    caches = []
    for _ in range(2):
        c = tm.init_cache(B, S, device="cpu")
        tm.prefill(tparams, torch.from_numpy(tokens), c,
                   **{k: torch.from_numpy(v) for k, v in extras.items()})
        caches.append(c)
    jdecode = jax.jit(jm.decode_step)
    for i in range(4):
        nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)[:, None]
        idx = n_prefix + T + i
        jl, jcache = jdecode(jparams, jnp.asarray(nxt), jcache,
                             jnp.int32(idx))
        a, _ = tm.decode_step(tparams, torch.from_numpy(nxt), caches[0], idx)
        b, _ = tm.decode_step(tparams, torch.from_numpy(nxt), caches[1],
                              torch.tensor(idx, dtype=torch.int32))
        assert torch.equal(a, b), f"decode step {i}"
        np.testing.assert_allclose(a.numpy(), _np(jl), **FP32,
                                   err_msg=f"decode step {i}")
    for key in caches[0]:
        assert torch.equal(caches[0][key], caches[1][key]), key


def test_tensor_index_decode_with_a_sliding_window():
    """A dense model with a 6-token window: the window mask follows the
    device position as it follows the host int."""
    _, _, tm, tparams = _pair("dense", sliding_window=6)
    tokens = torch.from_numpy(np.random.RandomState(4).randint(
        0, tm.cfg.vocab_size, (B, T)).astype(np.int32))
    caches = [tm.init_cache(B, T + 4, device="cpu") for _ in range(2)]
    for c in caches:
        tm.prefill(tparams, tokens, c)
    nxt = tokens[:, -1:]
    for i in range(4):
        a, _ = tm.decode_step(tparams, nxt, caches[0], T + i)
        b, _ = tm.decode_step(tparams, nxt, caches[1], torch.tensor(T + i))
        assert torch.equal(a, b)
        nxt = torch.argmax(a, -1).to(torch.int32)[:, None]


def test_decode_index_takes_a_host_int_or_a_0_dim_integer_tensor():
    assert ttfm.decode_index(np.int64(5)) == 5
    t = torch.tensor(5, dtype=torch.int32)
    assert ttfm.decode_index(t) is t
    for bad in (torch.tensor([5]), torch.tensor(5.0)):
        with pytest.raises(ValueError, match="0-dim integer"):
            ttfm.decode_index(bad)


# ---------------------------------------------------------------------------
# the plain attention with a tensor offset
# ---------------------------------------------------------------------------


def _qkv(Bq, Tq, S, H, KV, D, seed=5):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.randn(*s).astype(np.float32))
                 for s in ((Bq, Tq, H, D), (Bq, S, KV, D), (Bq, S, KV, D)))


@pytest.mark.parametrize("causal,window", [(False, None), (False, 5),
                                           (True, None), (True, 7)])
def test_plain_attention_takes_a_tensor_offset(causal, window):
    """A 0-dim tensor offset gives the int offset's bits in
    ``ref.attention_ref``, ``ops.plain_attention`` and ``split_kv_model``;
    a (B,) tensor gives each row's own int-offset call (to 1e-6)."""
    q, k, v = _qkv(3, 2, 20, 4, 2, 16)
    kv_len = torch.tensor([20, 13, 9], dtype=torch.int32)
    kw = dict(causal=causal, window=window)
    for fn in (ref.attention_ref, ops.plain_attention,
               lambda *a, **k_: fa.split_kv_model(
                   *a, splits=3, keys_per_split=7, **k_)):
        want = fn(q, k, v, q_offset=11, kv_len=kv_len, **kw)
        got = fn(q, k, v, q_offset=torch.tensor(11, dtype=torch.int32),
                 kv_len=kv_len, **kw)
        assert torch.equal(got, want)
        offs = kv_len - 2
        got = fn(q, k, v, q_offset=offs, kv_len=kv_len, **kw)
        for b in range(3):
            want_b = fn(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                        q_offset=int(offs[b]), kv_len=kv_len[b:b + 1], **kw)
            # one row alone against the batch: the CPU's batched products
            # may round a row by an ulp differently (ROADMAP §C)
            np.testing.assert_allclose(got[b:b + 1].numpy(), want_b.numpy(),
                                       rtol=1e-6, atol=1e-6)


def test_the_sequence_sharded_decode_keeps_its_host_int():
    """It stays eager: a device position is refused before any mesh
    arithmetic."""
    q, k, v = _qkv(1, 1, 8, 4, 2, 16)
    with pytest.raises(TypeError, match="host int"):
        ops._seq_sharded_attention(q, k, v, None, ("data",), causal=False,
                                   window=None, q_offset=torch.tensor(7),
                                   kv_len=None)


# ---------------------------------------------------------------------------
# the kernel counters
# ---------------------------------------------------------------------------


def test_counters_add_replayed_launches():
    """``count_replays`` adds a replay's launches: flash's by counter,
    wkv6's and ssd's as one count; a launch outside capture never touches
    ``captured``."""
    before = {n: getattr(fa, n) for n in fa.COUNTERS}
    fa.count_replays({"launches": 3, "launches_tiled": 1,
                      "launches_split": 2, "launches_partials": 0,
                      "launches_combine": 0})
    assert {n: getattr(fa, n) - before[n] for n in fa.COUNTERS} == {
        "launches": 3, "launches_tiled": 1, "launches_split": 2,
        "launches_partials": 0, "launches_combine": 0}
    for kernel in (wkv6, ssd):
        n0, c0 = kernel.launches, kernel.captured
        kernel.count_replays(7)
        assert (kernel.launches - n0, kernel.captured) == (7, c0)
    assert set(fa.captured) == set(fa.COUNTERS)


# ---------------------------------------------------------------------------
# ServeEngine on the CPU: the same programs, eagerly
# ---------------------------------------------------------------------------


def _old_loop(m, params, batch, gen, max_seq):
    """The engine's loop as it ran before its programs: a fresh cache,
    the prefill, greedy decode steps at host-int positions."""
    n_prefix = m.cfg.vision_tokens if m.cfg.family == "vlm" else 0
    inputs = {k: torch.from_numpy(v) for k, v in batch.items()}
    cache = m.init_cache(B, max_seq, device="cpu")
    logits, cache = model_zoo.make_prefill_fn(m)(params, inputs, cache)
    out = [torch.argmax(logits, -1).to(torch.int32)]
    P = batch["tokens"].shape[1]
    for i in range(gen - 1):
        logits, cache = m.decode_step(params, out[-1][:, None], cache,
                                      n_prefix + P + i)
        out.append(torch.argmax(logits, -1).to(torch.int32))
    return torch.stack(out, 1).numpy()


@pytest.mark.parametrize("family", FAMILIES)
def test_eager_generate_on_the_cpu_is_unchanged(family):
    """Three generates, another prompt in the middle (the cache and the
    recurrent state reset by every generate): the tokens of the loop the
    engine ran before its programs, bit for bit."""
    _, _, tm, tparams = _pair(family)
    max_seq = 40
    eng = ServeEngine(tm, tparams, max_seq=max_seq, batch=B, device="cpu")
    batches = [dict(tokens=np.random.RandomState(s).randint(
        0, tm.cfg.vocab_size, (B, T)).astype(np.int32), **_extras(tm.cfg))
        for s in (1, 2)]
    runs = [eng.generate(b, max_new_tokens=6) for b in
            (batches[0], batches[1], batches[0])]
    np.testing.assert_array_equal(runs[0].tokens, runs[2].tokens)
    cp = tm.compute_params(tparams)
    for res, batch in zip(runs, batches):
        assert res.tokens.shape == (B, T + 6) and res.steps == 6
        np.testing.assert_array_equal(res.tokens[:, :T], batch["tokens"])
        np.testing.assert_array_equal(
            res.tokens[:, T:], _old_loop(tm, cp, batch, 6, max_seq))
    assert eng.captures == eng.replays == 0


def test_engine_greedy_deterministic_and_temperature_varies():
    """The reference's two engine properties: greedy repeats; two seeds
    sample different tokens at temperature 1.5, one seed the same."""
    _, _, tm, tparams = _pair("dense", max_seq=48)
    batch = {"tokens": np.ones((B, 16), np.int32) * 5}
    eng = ServeEngine(tm, tparams, max_seq=48, batch=B, device="cpu")
    r1, r2 = (eng.generate(batch, max_new_tokens=8) for _ in range(2))
    np.testing.assert_array_equal(r1.tokens, r2.tokens)
    assert r1.tokens.shape == (B, 24)
    t = [ServeEngine(tm, tparams, max_seq=48, batch=B, temperature=1.5,
                     seed=s, device="cpu").generate(
        {"tokens": np.ones((B, 16), np.int32)}, max_new_tokens=12).tokens
        for s in (1, 2, 1)]
    assert not np.array_equal(t[0], t[1])
    np.testing.assert_array_equal(t[0], t[2])


@contextlib.contextmanager
def _no_host_reads(monkeypatch):
    """Every Python-level way a tensor's value reaches the host raises."""
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


@pytest.mark.parametrize("family", FAMILIES)
def test_decode_program_reads_nothing_on_the_host(monkeypatch, family):
    """The engine's decode program (the step, the greedy sample, the
    advance of the position) reads no tensor's value on the host, so the
    card can capture it once and replay it at every position."""
    _, _, tm, tparams = _pair(family)
    eng = ServeEngine(tm, tparams, max_seq=40, batch=B, device="cpu")
    batch = dict(tokens=np.random.RandomState(1).randint(
        0, tm.cfg.vocab_size, (B, T)).astype(np.int32), **_extras(tm.cfg))
    res = eng.generate(batch, max_new_tokens=4)
    slot = eng._slots[B]
    n_prefix = tm.cfg.vision_tokens if family == "vlm" else 0
    eng.generate(batch, max_new_tokens=1)         # back to the prefill's
    with _no_host_reads(monkeypatch):
        with pytest.raises(AssertionError, match="host read"):
            torch.ones(()).item()
        for _ in range(3):
            eng._decode_program(slot)
    start = n_prefix + T
    np.testing.assert_array_equal(slot.seq[:, start:start + 4].numpy(),
                                  res.tokens[:, T:])
    assert int(slot.index) == start + 3


def test_generate_checks_positions_ahead():
    """The range checks the device index no longer makes: the cache
    (max_seq) and Whisper's learned positions (dec_pos)."""
    _, _, tm, tparams = _pair("dense", max_seq=16)
    eng = ServeEngine(tm, tparams, max_seq=16, batch=B, device="cpu")
    with pytest.raises(ValueError, match="do not fit max_seq"):
        eng.generate({"tokens": np.ones((B, 12), np.int32)},
                     max_new_tokens=6)
    _, _, wm, wparams = _pair("encdec", max_seq=10)
    eng = ServeEngine(wm, wparams, max_seq=16, batch=B, device="cpu")
    batch = dict(tokens=np.ones((B, 8), np.int32), **_extras(wm.cfg))
    with pytest.raises(ValueError, match="past dec_pos"):
        eng.generate(batch, max_new_tokens=4)
    assert eng.generate(batch, max_new_tokens=3).tokens.shape == (B, 11)


# ---------------------------------------------------------------------------
# the oracles' CPU path and their default device
# ---------------------------------------------------------------------------


def test_oracles_on_the_cpu_are_unchanged():
    """The LJ oracle's labels are ``lj_energy_forces``'s; the teacher's
    its forward's argmax after the prompt's head; no graph on the CPU."""
    from repro_torch.examples import lm_active_distill as distill
    from repro_torch.examples import quickstart
    from repro_torch.models import potential as pot

    lj = quickstart.LJOracle(0, "", device="cpu")
    x = (quickstart.lattice() + 0.03).astype(np.float32).reshape(-1)
    inp, label = lj.run_calc(x)
    _, f = pot.lj_energy_forces(torch.from_numpy(x.reshape(-1, 3)))
    assert inp is x
    np.testing.assert_array_equal(label, f.reshape(-1).numpy())
    teacher = distill.TeacherOracle(0, "", device="cpu")
    prompt = distill.PromptGene(3, "").generate_new_data(None)[1]
    _, label = teacher.run_calc(prompt)
    want = torch.argmax(teacher.model.forward(teacher.params, {
        "tokens": torch.from_numpy(prompt.astype(np.int32))[None]}), -1)[0]
    np.testing.assert_array_equal(label[1:], want.numpy().astype(np.float32))
    assert label[0] == prompt[0] and lj.captures == teacher.captures == 0


def test_lj_oracle_defaults_to_the_card(monkeypatch):
    """``LJOracle`` resolves its device as every port entry point does:
    the CUDA card by default, an error without one (never a silent CPU
    oracle)."""
    from repro_torch.examples import quickstart

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        quickstart.LJOracle(0, "")
