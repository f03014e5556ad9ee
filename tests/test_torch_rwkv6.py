"""Port parity for the RWKV6 serving path: the ``wkv6`` plain versions and
``ops.wkv6`` (its CPU path) against the JAX package's ``repro.kernels.ref``
and the Pallas kernel in interpret mode, ``common.group_norm``, and
``models.rwkv6.RWKV6LM`` (forward, prefill, decode) and ``ServeEngine``
against the JAX ``RWKV6LM`` on the same weights (the reference's ``init``
carried across by ``params_from_numpy``) and the same numpy inputs.
Mirrors tests/test_kernels.py:105-177, tests/test_models.py and
tests/test_serving_and_dryrun.py:45-63.  The CUDA kernel is held against
the same plain version on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py).

Tolerances: the reference's wkv6 atol, 5e-3 in fp32 and 1e-1 in bf16 (its
tests/test_kernels.py); the plain versions against the reference's, which
differ only in summation order, 1e-4.  Models: fp32 atol 5e-4 (as
tests/test_models.py), rtol 2e-4; bf16 on one layer at rtol 2e-2, atol
5e-2: the frameworks' bf16 silu and logistic differ by one ulp on ~40 % of
entries (XLA's CPU lowering rounds inside them, PyTorch once), 0.0156 at
the block outputs' magnitude of 2-6, and the unembedding sums that into up
to ~0.04 on logits of magnitude ~4 (a second random layer doubles it).
Greedy tokens are exact in fp32.  bf16 inputs are made by rounding the
same fp32 numpy arrays in both frameworks (both round to nearest even)."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_config
from repro.kernels import ref as jref
from repro.kernels.wkv6 import wkv6 as jwkv6
from repro.models import common as jcm
from repro.models import rwkv6 as jrwkv6
from repro.models.model_zoo import build_model as jbuild_model
from repro.serving import ServeEngine as JServeEngine
from repro_torch.configs import base as tbase
from repro_torch.configs import get_arch
from repro_torch.core.committee import params_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.kernels import wkv6 as kernel
from repro_torch.models import common as tcm
from repro_torch.models import model_zoo
from repro_torch.models import rwkv6 as trwkv6
from repro_torch.serving import ServeEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WKV_ATOL = {"float32": 5e-3, "bfloat16": 1e-1}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FP32 = dict(rtol=2e-4, atol=5e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)          # group_norm alone
BF16_MODEL = dict(rtol=2e-2, atol=5e-2)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return x.to(torch.float32).numpy()


def _tcfg(jcfg):
    """The same ModelConfig as the port's dataclass."""
    return tbase.ModelConfig(**{f: getattr(jcfg, f) for f in
                                jcfg.__dataclass_fields__})


def _wkv_inputs(B, T, H, N, dtype="float32", seed=4, w_lo=0.2, w_hi=0.999,
                w_const=None, state=True):
    """(jax arrays, torch tensors) of r, k, v, w, u, state0 from numpy: r,
    k, v normal and w uniform in [w_lo, w_hi] (or ``w_const``), rounded to
    ``dtype``; u and the state fp32."""
    rng = np.random.RandomState(seed)
    r, k, v = (rng.randn(B, T, H, N).astype(np.float32) for _ in range(3))
    w = (np.full((B, T, H, N), w_const, np.float32) if w_const is not None
         else rng.uniform(w_lo, w_hi, (B, T, H, N)).astype(np.float32))
    u = rng.randn(H, N).astype(np.float32)
    s0 = rng.randn(B, H, N, N).astype(np.float32) if state else None
    jd, td = DT[dtype]
    jx = [jnp.asarray(a).astype(jd) for a in (r, k, v, w)] + [
        jnp.asarray(u), None if s0 is None else jnp.asarray(s0)]
    tx = [torch.from_numpy(a).to(td) for a in (r, k, v, w)] + [
        torch.from_numpy(u), None if s0 is None else torch.from_numpy(s0)]
    return jx, tx


# the reference's sweep (tests/test_kernels.py:105-110)
SWEEP = [(1, 64, 2, 16, 16), (2, 128, 3, 32, 32), (1, 96, 1, 64, 32)]


# ---------------------------------------------------------------------------
# wkv6: plain versions, ops (CPU), against the reference and the Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,N,chunk", SWEEP)
def test_wkv6_plain_versions_match_reference(B, T, H, N, chunk, dtype):
    """ref.wkv6_ref / wkv6_chunked_ref against the reference's, and the
    chunked form against the sequential oracle at the reference's atol."""
    jx, tx = _wkv_inputs(B, T, H, N, dtype)
    y_s, s_s = ref.wkv6_ref(*tx)
    jy_s, js_s = jax.jit(jref.wkv6_ref)(*jx)
    assert y_s.dtype == DT[dtype][1] and s_s.dtype == torch.float32
    np.testing.assert_allclose(_t(s_s), _np(js_s), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_t(y_s), _np(jy_s), rtol=1e-4,
                               atol=1e-4 if dtype == "float32" else 1e-1)
    y_c, s_c = ref.wkv6_chunked_ref(*tx, chunk=chunk)
    jy_c, js_c = jax.jit(jref.wkv6_chunked_ref,
                         static_argnames="chunk")(*jx, chunk=chunk)
    np.testing.assert_allclose(_t(s_c), _np(js_c), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_t(y_c), _np(jy_c), rtol=1e-4,
                               atol=1e-4 if dtype == "float32" else 1e-1)
    atol = WKV_ATOL[dtype]
    np.testing.assert_allclose(_t(y_c), _np(jy_s), atol=atol)
    np.testing.assert_allclose(_t(s_c), _np(js_s), atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,N,chunk", SWEEP)
def test_ops_wkv6_matches_pallas_kernel_interpret(B, T, H, N, chunk, dtype):
    """Mirrors test_wkv6_pallas_matches_sequential: ops.wkv6 on the CPU
    against the Pallas kernel run in interpret mode, and both against the
    sequential oracle, at the reference's atol."""
    jx, tx = _wkv_inputs(B, T, H, N, dtype)
    before = kernel.launches
    y, s = ops.wkv6(*tx, chunk=chunk)
    assert kernel.launches == before           # the CPU path runs no kernel
    assert y.dtype == DT[dtype][1] and tuple(y.shape) == (B, T, H, N)
    assert s.dtype == torch.float32 and tuple(s.shape) == (B, H, N, N)
    jy, js = jwkv6(*jx, chunk=chunk, interpret=True)
    jy_s, js_s = jax.jit(jref.wkv6_ref)(*jx)
    atol = WKV_ATOL[dtype]
    np.testing.assert_allclose(_t(y), _np(jy), atol=atol)
    np.testing.assert_allclose(_t(s), _np(js), atol=atol)
    np.testing.assert_allclose(_t(y), _np(jy_s), atol=atol)
    np.testing.assert_allclose(_t(s), _np(js_s), atol=atol)


def test_wkv6_strong_decay_stable():
    """Mirrors test_wkv6_strong_decay_stable: w = 1e-4 must not overflow
    the chunked form."""
    jx, tx = _wkv_inputs(1, 128, 2, 16, w_const=1e-4, state=False, seed=5)
    y, s = ops.wkv6(*tx, chunk=32)
    jy, _ = jwkv6(*jx, chunk=32, interpret=True)
    jy_s, js_s = jax.jit(jref.wkv6_ref)(*jx)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    np.testing.assert_allclose(_t(y), _np(jy_s), atol=5e-3)
    np.testing.assert_allclose(_t(s), _np(js_s), atol=5e-3)
    np.testing.assert_allclose(_t(y), _np(jy), atol=5e-3)


def test_wkv6_state_chaining_equals_full_run():
    """Mirrors test_wkv6_state_chaining_equals_full_run: two halves with
    the state carried == one run (atol 1e-4)."""
    _, (r, k, v, w, u, _) = _wkv_inputs(2, 128, 2, 16, w_lo=0.3, w_hi=0.99,
                                        state=False, seed=6)
    y_full, s_full = ref.wkv6_chunked_ref(r, k, v, w, u, None, chunk=32)
    h = 64
    y1, s1 = ops.wkv6(r[:, :h], k[:, :h], v[:, :h], w[:, :h], u, None,
                      chunk=32)
    y2, s2 = ops.wkv6(r[:, h:], k[:, h:], v[:, h:], w[:, h:], u, s1,
                      chunk=32)
    np.testing.assert_allclose(_t(torch.cat([y1, y2], 1)), _t(y_full),
                               atol=1e-4)
    np.testing.assert_allclose(_t(s2), _t(s_full), atol=1e-4)


def test_wkv6_decode_step_matches_scan_and_reference():
    """Mirrors test_wkv6_decode_step_matches_scan: 8 single steps ==
    the sequential scan (atol 1e-4), each step == the reference's."""
    jx, tx = _wkv_inputs(2, 8, 2, 16, w_lo=0.3, w_hi=0.99, state=False,
                         seed=7)
    r, k, v, w, u, _ = tx
    y_ref, s_ref = ref.wkv6_ref(r, k, v, w, u, None)
    S = torch.zeros(2, 2, 16, 16)
    jS = jnp.zeros((2, 2, 16, 16))
    ys = []
    for t in range(8):
        y, S = ops.wkv6_decode(r[:, t], k[:, t], v[:, t], w[:, t], u, S)
        jy, jS = jref.wkv6_decode_ref(*(a[:, t] for a in jx[:4]), jx[4], jS)
        np.testing.assert_allclose(_t(y), _np(jy), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_t(S), _np(jS), rtol=1e-5, atol=1e-5)
        ys.append(y)
    np.testing.assert_allclose(_t(torch.stack(ys, 1)), _t(y_ref), atol=1e-4)
    np.testing.assert_allclose(_t(S), _t(s_ref), atol=1e-4)


def test_wkv6_raises_unless_the_chunk_divides_T():
    """The reference's contract (src/repro/kernels/wkv6.py:84-86): the
    chunk is cut to T, and must divide it."""
    jx, tx = _wkv_inputs(1, 96, 1, 16, state=False)
    with pytest.raises(ValueError, match="not divisible"):
        jwkv6(*jx, chunk=64, interpret=True)
    for fn in (ops.wkv6, ops.plain_wkv6):
        with pytest.raises(ValueError, match="not divisible"):
            fn(*tx, chunk=64)
    with pytest.raises(ValueError, match="not divisible"):
        ref.wkv6_chunked_ref(*tx, chunk=64)
    y, _ = ops.wkv6(*(a[:, :48] if a is not None and a.dim() == 4 else a
                      for a in tx), chunk=64)            # chunk cut to T
    assert tuple(y.shape) == (1, 48, 1, 16)


def test_wkv6_writes_its_state_into_state_out_even_when_aliased():
    _, (r, k, v, w, u, s0) = _wkv_inputs(2, 64, 2, 16, seed=8)
    y_want, s_want = ops.wkv6(r, k, v, w, u, s0, chunk=16)
    buf = s0.clone()
    y, s = ops.wkv6(r, k, v, w, u, buf, chunk=16, state_out=buf)
    assert s is buf
    assert torch.equal(y, y_want) and torch.equal(buf, s_want)
    out = torch.empty_like(s0)
    y2, s2 = ops.plain_wkv6(r, k, v, w, u, s0, chunk=16, state_out=out)
    assert s2 is out and torch.equal(out, s_want) and torch.equal(y2, y)


def test_wkv6_rejects_other_devices_and_needs_cuda_for_the_kernel(
        monkeypatch):
    _, tx = _wkv_inputs(1, 16, 1, 16, state=False)
    meta = [a.to("meta") if a is not None else None for a in tx]
    with pytest.raises(ValueError, match="no implementation"):
        ops.wkv6(*meta, chunk=16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kernel.wkv6(*tx, chunk=16)


def test_cpu_path_never_touches_the_kernel_loader(monkeypatch):
    from repro_torch.kernels import _build

    def boom(*a, **k):
        raise AssertionError("kernel loader touched on the CPU path")

    monkeypatch.setattr(_build, "load", boom)
    monkeypatch.setattr(_build, "build_all", boom)
    _, tx = _wkv_inputs(1, 32, 2, 16)
    ops.wkv6(*tx, chunk=16)
    _, _, _, tm, tparams = _pair("base")
    tok = torch.zeros((1, 8), dtype=torch.int32)
    tm.prefill(tparams, tok, tm.init_cache(1, 8, device="cpu"))


# ---------------------------------------------------------------------------
# model numerics and parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_matches_reference(dtype):
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 5, 64) * 3 + 1).astype(np.float32)
    wt = rng.randn(64).astype(np.float32)
    b = rng.randn(64).astype(np.float32)
    jd, td = DT[dtype]
    got = tcm.group_norm(torch.from_numpy(x).to(td), torch.from_numpy(wt),
                         torch.from_numpy(b), groups=4, eps=64e-5)
    want = jcm.group_norm(jnp.asarray(x).astype(jd), wt, b, groups=4,
                          eps=64e-5)
    assert got.dtype == td
    tol = FP32 if dtype == "float32" else BF16
    np.testing.assert_allclose(_t(got), _np(want), **tol)


def test_param_specs_and_counts_match_reference_tree():
    jcfg = tiny_config("rwkv6")
    jshapes = jax.tree.map(lambda s: s.shape, jrwkv6.param_specs(jcfg),
                           is_leaf=jcm.is_spec)
    tshapes = tcm.map_specs(lambda s: s.shape,
                            trwkv6.param_specs(_tcfg(jcfg)))
    assert jshapes == tshapes
    from repro.configs import get_arch as jget_arch
    from repro.models.model_zoo import count_params as jcount

    full = get_arch("rwkv6-7b").model
    assert model_zoo.count_params(full) == jcount(jget_arch("rwkv6-7b").model)
    assert 7.5e9 < model_zoo.count_params(full) < 7.7e9
    m = model_zoo.build_model(full)
    assert isinstance(m, trwkv6.RWKV6LM)
    cache = m.cache_specs(8, 576)
    assert cache["wkv"].shape == (32, 8, 64, 64, 64)
    assert cache["wkv"].dtype == torch.float32
    assert cache["tshift"].shape == (32, 8, 4096)
    assert cache["tshift"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# RWKV6LM against the reference
# ---------------------------------------------------------------------------

VARIANTS = {
    "base": (dict(), 64),
    "chunk8": (dict(), 8),         # prefill of 16 tokens in two chunks
    "bf16": (dict(dtype="bfloat16", num_layers=1), 64),
}


def _pair(variant, impl="xla"):
    kw, chunk = VARIANTS[variant]
    jcfg = tiny_config("rwkv6", **kw)
    jm = jrwkv6.RWKV6LM(jcfg, impl=impl, wkv_chunk=chunk)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = trwkv6.RWKV6LM(_tcfg(jcfg), wkv_chunk=chunk)
    tparams = params_from_numpy(jparams, "cpu")
    return jcfg, jm, jparams, tm, tparams


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_rwkv6_forward_prefill_decode_match_reference(variant):
    jcfg, jm, jparams, tm, tparams = _pair(variant)
    tol = BF16_MODEL if jcfg.dtype == "bfloat16" else FP32
    rng = np.random.RandomState(3)
    B, T = 2, 16
    tokens = rng.randint(0, jcfg.vocab_size, (B, T)).astype(np.int32)

    want = jax.jit(jm.forward)(jparams, {"tokens": jnp.asarray(tokens)})
    got = tm.forward(tparams, {"tokens": torch.from_numpy(tokens)})
    assert tuple(got.shape) == want.shape == (B, T, jcfg.padded_vocab)
    np.testing.assert_allclose(_t(got), _np(want), **tol)

    jcache = jm.init_cache(B, T + 4)
    tcache = tm.init_cache(B, T + 4, device="cpu")
    jl, jcache = jax.jit(jm.prefill)(jparams, jnp.asarray(tokens), jcache)
    tl, tcache2 = tm.prefill(tparams, torch.from_numpy(tokens), tcache)
    assert tcache2 is tcache
    np.testing.assert_allclose(_t(tl), _np(jl), **tol)
    for key in ("wkv", "tshift", "cshift"):
        assert tuple(tcache[key].shape) == jcache[key].shape
        np.testing.assert_allclose(_t(tcache[key]), _np(jcache[key]), **tol)

    # three decode steps, teacher-forced with the reference's greedy tokens
    jdecode = jax.jit(jm.decode_step)
    for i in range(3):
        nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)[:, None]
        jl, jcache = jdecode(jparams, jnp.asarray(nxt), jcache,
                             jnp.int32(T + i))
        tl, tcache = tm.decode_step(tparams, torch.from_numpy(nxt), tcache,
                                    T + i)
        np.testing.assert_allclose(_t(tl), _np(jl), **tol)
    for key in ("wkv", "tshift", "cshift"):
        assert tcache[key].dtype == tcm.torch_dtype(str(jcache[key].dtype))
        np.testing.assert_allclose(_t(tcache[key]), _np(jcache[key]), **tol)


def test_rwkv6_forward_matches_pallas_interpret_reference():
    """Mirrors test_xla_vs_pallas_interpret_forward: the JAX model with its
    Pallas wkv6 in interpret mode, 64 tokens (one chunk), against the
    port's CPU path (atol 2e-3, the reference's bound for that test)."""
    jcfg, jm, jparams, tm, tparams = _pair("base", impl="pallas_interpret")
    tokens = np.random.RandomState(9).randint(
        0, jcfg.vocab_size, (2, 64)).astype(np.int32)
    want = jm.forward(jparams, {"tokens": jnp.asarray(tokens)})
    got = tm.forward(tparams, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(_t(got), _np(want), atol=2e-3)


def test_rwkv6_prefill_and_decode_match_forward():
    """Mirrors test_prefill_and_decode_match_forward for the port alone
    (atol 5e-4): the cached path agrees with a full forward."""
    _, _, _, tm, tparams = _pair("base")
    tok = torch.from_numpy(np.random.RandomState(10).randint(
        0, 256, (2, 16)).astype(np.int32))
    cache = tm.init_cache(2, 20, device="cpu")
    last, cache = tm.prefill(tparams, tok, cache)
    full = tm.forward(tparams, {"tokens": tok})
    np.testing.assert_allclose(_t(last), _t(full[:, -1]), atol=5e-4)
    nxt = torch.argmax(last, -1).to(torch.int32)[:, None]
    logits2, cache = tm.decode_step(tparams, nxt, cache, 16)
    full2 = tm.forward(tparams, {"tokens": torch.cat([tok, nxt], 1)})
    np.testing.assert_allclose(_t(logits2), _t(full2[:, -1]), atol=5e-4)


def test_rwkv6_decode_ignores_the_index_and_plain_equals_auto():
    _, _, _, tm, tparams = _pair("base")
    tok = torch.from_numpy(np.random.RandomState(11).randint(
        0, 256, (2, 8)).astype(np.int32))
    plain = model_zoo.build_model(tm.cfg, impl="plain")
    assert isinstance(plain, trwkv6.RWKV6LM)
    assert torch.equal(plain.forward(tparams, {"tokens": tok}),
                       tm.forward(tparams, {"tokens": tok}))
    outs = []
    for index in (8, 1000):
        cache = tm.init_cache(2, 12, device="cpu")
        _, cache = tm.prefill(tparams, tok, cache)
        outs.append(tm.decode_step(tparams, tok[:, :1], cache, index)[0])
    assert torch.equal(outs[0], outs[1])


def test_rwkv6_compute_params_keep_the_bits():
    """Casting the cast-at-use leaves once ahead (what ServeEngine keeps)
    gives the bits of the model's per-product casts; w0, decay_b, u and the
    norm weights stay fp32."""
    _, _, _, tm, tparams = _pair("bf16")
    cp = tm.compute_params(tparams)
    assert isinstance(cp["layers"], list)
    assert len(cp["layers"]) == tm.cfg.num_layers
    tmix, cmix = cp["layers"][0]["tmix"], cp["layers"][0]["cmix"]
    for key in ("mu_x", "mu", "lora_a", "lora_b", "decay_a", "wr", "wk", "wv",
                "wg", "wo"):
        assert tmix[key].dtype == torch.bfloat16, key
    for key in ("w0", "decay_b", "u", "ln", "gn_w", "gn_b"):
        assert tmix[key].dtype == torch.float32, key
    for key in ("mu_k", "mu_r", "wk", "wv", "wr"):
        assert cmix[key].dtype == torch.bfloat16, key
    assert cmix["ln"].dtype == torch.float32
    assert cp["final_ln"].dtype == torch.float32
    assert cp["lm_head"].dtype == torch.bfloat16
    tokens = torch.from_numpy(
        np.random.RandomState(5).randint(0, 256, (2, 10)).astype(np.int32))
    assert torch.equal(tm.forward(cp, {"tokens": tokens}),
                       tm.forward(tparams, {"tokens": tokens}))
    got, want = (tm.prefill(params, tokens,
                            tm.init_cache(2, 12, device="cpu"))[0]
                 for params in (cp, tparams))      # the cached path as well
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# ServeEngine and the serve CLI
# ---------------------------------------------------------------------------


def test_serve_engine_greedy_tokens_match_reference():
    jcfg = tiny_config("rwkv6")
    jm = jbuild_model(jcfg, max_seq=40)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = model_zoo.build_model(_tcfg(jcfg), max_seq=40)
    tparams = params_from_numpy(jparams, "cpu")
    batch = {"tokens": np.random.RandomState(6).randint(
        0, 256, (2, 16)).astype(np.int32)}
    want = JServeEngine(jm, jparams, max_seq=40, batch=2).generate(
        batch, max_new_tokens=8)
    got = ServeEngine(tm, tparams, max_seq=40, batch=2,
                      device="cpu").generate(batch, max_new_tokens=8)
    assert got.tokens.shape == (2, 24) and got.steps == 8
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.prefill_seconds > 0 and got.decode_tokens_per_s > 0


def test_serve_cli_runs_rwkv6_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "rwkv6-7b", "--preset", "smoke", "--batch", "2",
         "--prompt-len", "16", "--gen", "4"],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["arch"] == "rwkv6-7b" and res["generated"] == 4
    assert res["device"] == "cpu" and res["decode_tokens_per_s"] > 0
