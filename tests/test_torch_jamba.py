"""Port parity for the Jamba serving path: ``models.mamba`` (the causal
conv and the mixer, prefill then decode with states), ``models.moe``
(routing with capacity drops, the FFN, the load-balance loss) and
``models.jamba.JambaLM`` (forward, prefill, decode, ``compute_params``)
and ``ServeEngine`` against the JAX package on the same weights (the
reference's ``init`` carried across by ``params_from_numpy``) and the same
numpy inputs.  Mirrors tests/test_models.py (forward, prefill/decode
against forward, xla vs pallas_interpret) and
tests/test_serving_and_dryrun.py:45-63.  The ssd kernel's own parity is in
tests/test_torch_ssd.py.

Tolerances: fp32 rtol 2e-4, atol 5e-4 (as tests/test_models.py, and
tests/test_torch_rwkv6.py's FP32); bf16 on one group (8 layers, the least
depth ``jamba.param_specs`` takes) at rtol 2e-2, atol 5e-2, the
BF16_MODEL tolerance of tests/test_torch_rwkv6.py (the frameworks' bf16
silu rounds differently, see there); 2e-3 against the JAX model on its
Pallas kernels in interpret mode (the reference's bound for that test).
Greedy tokens are exact in fp32.  MoE routing masks are compared exactly."""
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
from repro.configs import get_arch as jget_arch
from repro.launch.train import reduced_config as jreduced
from repro.models import common as jcm
from repro.models import jamba as jjamba
from repro.models import mamba as jmamba
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.models.model_zoo import build_model as jbuild_model
from repro.models.model_zoo import count_params as jcount
from repro.serving import ServeEngine as JServeEngine
from repro_torch.configs import base as tbase
from repro_torch.configs import get_arch
from repro_torch.configs.jamba1p5_large_398b import ONE_CARD_CUT
from repro_torch.core.committee import (params_from_numpy, tree_leaves,
                                        tree_paths)
from repro_torch.kernels import ssd as ssd_kernel
from repro_torch.models import common as tcm
from repro_torch.models import jamba as tjamba
from repro_torch.models import mamba as tmamba
from repro_torch.models import model_zoo
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from repro_torch.serving import ServeEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAMBA = "jamba-1.5-large-398b"
FP32 = dict(rtol=2e-4, atol=5e-4)
BF16_MODEL = dict(rtol=2e-2, atol=5e-2)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return x.to(torch.float32).numpy()


def _tcfg(jcfg):
    """The same ModelConfig as the port's dataclass."""
    return tbase.ModelConfig(**{f: getattr(jcfg, f) for f in
                                jcfg.__dataclass_fields__})


def _smoke(**kw):
    """The reference's smoke preset of jamba-1.5-large (8 layers, d 128, 8
    SSD heads of P = 32, N = 8, 4 experts top-2 in groups of 256, fp32)."""
    return jreduced(jget_arch(JAMBA).model, "smoke").replace(**kw)


def _init(jspecs, seed=0):
    """The reference's init of a spec tree, as numpy-able arrays."""
    return jcm.init_params(jspecs, jax.random.PRNGKey(seed))


# ---------------------------------------------------------------------------
# models/mamba.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv_matches_reference(dtype, with_tail):
    """K = 4 shifted adds accumulated in x's dtype (not a grouped conv)."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, 32).astype(np.float32)
    w = rng.randn(4, 32).astype(np.float32)
    b = rng.randn(32).astype(np.float32)
    tail = rng.randn(2, 3, 32).astype(np.float32) if with_tail else None
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = tcm.torch_dtype(dtype)
    jy, jtail = jmamba._causal_conv(
        jnp.asarray(x).astype(jd), jnp.asarray(w), jnp.asarray(b),
        None if tail is None else jnp.asarray(tail).astype(jd))
    ty, ttail = tmamba._causal_conv(
        torch.from_numpy(x).to(td), torch.from_numpy(w),
        torch.from_numpy(b),
        None if tail is None else torch.from_numpy(tail).to(td))
    assert ty.dtype == td and ttail.dtype == td
    tol = FP32 if dtype == "float32" else BF16_MODEL
    np.testing.assert_allclose(_t(ty), _np(jy), **tol)
    np.testing.assert_array_equal(_t(ttail), _np(jtail))


def _mixer_pair(seed=1, **kw):
    jcfg = _smoke(**kw)
    jp = _init(jmamba.mamba_specs(jcfg), seed)
    return jcfg, jp, _tcfg(jcfg), params_from_numpy(jp, "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_mixer_prefill_then_decode_match_reference(dtype):
    """The mixer with states at the smoke preset's dims: a 16-token
    prefill from zero states (the ssd scan, a rounded to the activation
    dtype), then 3 decode steps (the one-token recurrence, a in fp32);
    outputs and both states each step, the port's states updated in
    place."""
    jcfg, jp, tcfg, tp = _mixer_pair(dtype=dtype)
    tol = FP32 if dtype == "float32" else BF16_MODEL
    rng = np.random.RandomState(2)
    B, T = 2, 16
    ms = jmamba.mamba_state_specs(jcfg, B)
    jst = {k: jnp.zeros(s.shape, s.dtype) for k, s in ms.items()}
    tms = tmamba.mamba_state_specs(tcfg, B)
    tst = {k: torch.zeros(s.shape, dtype=s.dtype) for k, s in tms.items()}
    assert {k: tuple(v.shape) for k, v in tst.items()} == \
        {k: v.shape for k, v in jst.items()}
    conv_buf, ssd_buf = tst["conv"], tst["ssd"]
    jd, td = jnp.dtype(dtype), tcm.torch_dtype(dtype)
    for step, t in enumerate((T, 1, 1, 1)):
        x = rng.randn(B, t, jcfg.d_model).astype(np.float32)
        jy, jst = jmamba.mamba_mixer(jp, jnp.asarray(x).astype(jd), jcfg,
                                     states=jst)
        ty = tmamba.mamba_mixer(tp, torch.from_numpy(x).to(td), tcfg,
                                states=tst)
        assert tst["conv"] is conv_buf and tst["ssd"] is ssd_buf
        assert ty.dtype == td and tst["conv"].dtype == td
        np.testing.assert_allclose(_t(ty), _np(jy), **tol,
                                   err_msg=f"step {step}")
        for key in ("conv", "ssd"):
            np.testing.assert_allclose(_t(tst[key]), _np(jst[key]), **tol,
                                       err_msg=f"step {step} {key}")


def test_mamba_mixer_without_states_matches_reference():
    """No cache (the forward path), two chunks of 64."""
    jcfg, jp, tcfg, tp = _mixer_pair(seed=3)
    x = np.random.RandomState(4).randn(2, 128, jcfg.d_model).astype(
        np.float32)
    jy, jst = jmamba.mamba_mixer(jp, jnp.asarray(x), jcfg)
    assert jst is None
    before = ssd_kernel.launches
    ty = tmamba.mamba_mixer(tp, torch.from_numpy(x), tcfg)
    assert ssd_kernel.launches == before      # the CPU path runs no kernel
    np.testing.assert_allclose(_t(ty), _np(jy), **FP32)
    plain = tmamba.mamba_mixer(tp, torch.from_numpy(x), tcfg, impl="plain")
    assert torch.equal(plain, ty)


# ---------------------------------------------------------------------------
# models/moe.py
# ---------------------------------------------------------------------------


def _jax_routing(jp, x, cfg):
    """The routing half of the reference's moe_ffn (src/repro/models/
    moe.py:82-109), step for step: (sel, in_cap) per (group, token,
    expert)."""
    B, T, D = x.shape
    E, K = cfg.moe_num_experts, cfg.moe_top_k
    h = jcm.rms_norm(x, jp["ln"], cfg.norm_eps)
    S = min(cfg.moe_group_size, B * T)
    while (B * T) % S != 0:
        S -= 1
    xs = h.reshape((B * T) // S, S, D)
    gates = jnp.einsum("gsd,de->gse", xs.astype(jnp.float32),
                       jp["router"].astype(jnp.float32))
    probs = jax.nn.softmax(gates, axis=-1)
    _, top_oh = jmoe._top_k_one_hot(probs, K)
    sel = top_oh.sum(axis=2)
    C = min(max(int(S * K * cfg.moe_capacity_factor / E), 1), S)
    pos = jnp.cumsum(sel, axis=1) - sel
    return np.asarray(sel), np.asarray((sel > 0) & (pos < C))


@pytest.mark.parametrize("cf,family,drops", [
    (0.5, "hybrid", True),            # capacity 4 of 16: drops
    (8.0, "hybrid", False),           # capacity = S: none
    (0.5, "moe", True),               # shared experts, drops
], ids=["hybrid-drops", "hybrid-no-drops", "moe-shared-drops"])
def test_moe_ffn_matches_reference(cf, family, drops):
    """Routing masks identical (and drops where the capacity forces them),
    then the output and the load-balance loss, fp32."""
    jcfg = tiny_config(family, moe_capacity_factor=cf)
    tcfg = _tcfg(jcfg)
    jp = _init(jmoe.moe_ffn_specs(jcfg), seed=5)
    tp = params_from_numpy(jp, "cpu")
    x = np.random.RandomState(6).randn(2, 16, jcfg.d_model).astype(
        np.float32)
    sel, in_cap = _jax_routing(jp, jnp.asarray(x), jcfg)
    r = tmoe.route(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(r.sel.numpy(), sel)
    np.testing.assert_array_equal(r.in_cap.numpy(), in_cap)
    n_dropped = int(((sel > 0) & ~in_cap).sum())
    assert r.dropped == n_dropped and (n_dropped > 0) == drops
    jy, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg, return_aux=True)
    ty, taux = tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg, return_aux=True)
    np.testing.assert_allclose(_t(ty), _np(jy), **FP32)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    assert torch.equal(tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg), ty)


def test_top_k_ties_go_to_the_lower_index_as_in_jax():
    g = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3],
                  [0.4, 0.2, 0.4, 0.0], [0.0, 0.5, 0.0, 0.5]], np.float32)
    for k in (1, 2, 3):
        jv, joh = jmoe._top_k_one_hot(jnp.asarray(g), k)
        tv, toh = tmoe._top_k_one_hot(torch.from_numpy(g), k)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(toh.numpy(), np.asarray(joh))


# ---------------------------------------------------------------------------
# models/jamba.py: specs, weights, JambaLM
# ---------------------------------------------------------------------------


def test_param_specs_and_counts_match_reference_tree():
    jcfg = tiny_config("hybrid")
    jshapes = jax.tree.map(lambda s: s.shape, jjamba.param_specs(jcfg),
                           is_leaf=jcm.is_spec)
    tshapes = tcm.map_specs(lambda s: s.shape,
                            tjamba.param_specs(_tcfg(jcfg)))
    assert jshapes == tshapes
    full = get_arch(JAMBA).model
    n = model_zoo.count_params(full)
    assert n == jcount(jget_arch(JAMBA).model)
    assert round(n / 1e9, 1) == 397.6
    cut = full.replace(**ONE_CARD_CUT)
    assert ONE_CARD_CUT == {"num_layers": 8, "moe_num_experts": 2}
    assert model_zoo.count_params(cut) == jcount(
        jget_arch(JAMBA).model.replace(**ONE_CARD_CUT))
    assert 6 * model_zoo.count_params(cut) / 2**30 < 64    # 63.2 GiB
    with pytest.raises(ValueError, match="multiple of the period"):
        tjamba.param_specs(_tcfg(jcfg).replace(num_layers=12))
    m = model_zoo.build_model(cut)
    cache = m.cache_specs(8, 576)
    assert cache["k"].shape == (1, 8, 576, 8, 128)
    assert cache["conv"].shape == (1, 7, 8, 3, 16384)
    assert cache["ssd"].shape == (1, 7, 8, 128, 16, 128)
    assert cache["conv"].dtype == cache["k"].dtype == torch.bfloat16
    assert cache["ssd"].dtype == torch.float32


def test_params_from_numpy_takes_the_jamba_tree_unchanged():
    """The JAX JambaLM.init tree (numpy leaves nested two stacking levels
    deep) carries across as it is: the same key paths, shapes and
    dtypes."""
    jcfg = tiny_config("hybrid")
    jparams = jjamba.JambaLM(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jparams, "cpu")
    jpaths = [tuple(getattr(k, "key", k) for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert tree_paths(tparams) == jpaths
    for path, t, j in zip(tree_paths(tparams), tree_leaves(tparams),
                          jax.tree_util.tree_leaves(jparams)):
        assert tuple(t.shape) == j.shape, path
        assert t.dtype == torch.float32 and j.dtype == jnp.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert tparams["layers"]["mamba"]["in_proj"].shape[:2] == (1, 7)
    assert tparams["layers"]["moe"]["wi"].shape[:3] == (1, 4, 4)


VARIANTS = {
    "smoke": (dict(), 16),
    "two-chunks": (dict(), 128),       # a prefill of 128 tokens: 2 chunks
}


def _pair(variant, impl="xla"):
    kw, _ = VARIANTS[variant]
    jcfg = _smoke(**kw)
    jm = jjamba.JambaLM(jcfg, impl=impl)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = tjamba.JambaLM(_tcfg(jcfg))
    tparams = params_from_numpy(jparams, "cpu")
    return jcfg, jm, jparams, tm, tparams


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_jamba_forward_prefill_decode_match_reference(variant):
    """forward logits (and the aux loss), prefill logits and cache (k, v,
    conv, ssd), then 4 decode steps teacher-forced with the reference's
    greedy tokens, and the cache after them."""
    jcfg, jm, jparams, tm, tparams = _pair(variant)
    tol = FP32
    B, T = 2, VARIANTS[variant][1]
    tokens = np.random.RandomState(3).randint(
        0, jcfg.vocab_size, (B, T)).astype(np.int32)

    want, jaux = jax.jit(lambda p, b: jm.forward(p, b, return_aux=True))(
        jparams, {"tokens": jnp.asarray(tokens)})
    got, taux = tm.forward(tparams, {"tokens": torch.from_numpy(tokens)},
                           return_aux=True)
    assert tuple(got.shape) == want.shape == (B, T, jcfg.padded_vocab)
    np.testing.assert_allclose(_t(got), _np(want), **tol)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-3)

    jcache = jm.init_cache(B, T + 5)
    tcache = tm.init_cache(B, T + 5, device="cpu")
    jl, jcache = jax.jit(jm.prefill)(jparams, jnp.asarray(tokens), jcache)
    tl, tcache2 = tm.prefill(tparams, torch.from_numpy(tokens), tcache)
    assert tcache2 is tcache
    np.testing.assert_allclose(_t(tl), _np(jl), **tol)
    for key in ("k", "v", "conv", "ssd"):
        assert tuple(tcache[key].shape) == jcache[key].shape
        assert tcache[key].dtype == tcm.torch_dtype(str(jcache[key].dtype))
        np.testing.assert_allclose(_t(tcache[key]), _np(jcache[key]), **tol,
                                   err_msg=key)

    jdecode = jax.jit(jm.decode_step)
    for i in range(4):
        nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)[:, None]
        jl, jcache = jdecode(jparams, jnp.asarray(nxt), jcache,
                             jnp.int32(T + i))
        tl, tcache = tm.decode_step(tparams, torch.from_numpy(nxt), tcache,
                                    T + i)
        np.testing.assert_allclose(_t(tl), _np(jl), **tol,
                                   err_msg=f"decode step {i}")
    for key in ("k", "v", "conv", "ssd"):
        np.testing.assert_allclose(_t(tcache[key]), _np(jcache[key]), **tol,
                                   err_msg=key)


def test_jamba_bf16_one_group_matches_reference_per_sublayer():
    """One group (8 layers) in bf16 at BF16_MODEL, held sublayer by
    sublayer: each attention, mixer, MoE and dense block of the port takes
    the reference's own bf16 activations and must give the reference's
    output; then the aux loss and the unembedding of the reference's last
    hidden state.  (End to end, 8 random-weight bf16 layers amplify the
    frameworks' 1-2 ulp silu differences past any bf16 tolerance: the
    reference's init makes attention nearly one-hot, ROADMAP §C.)"""
    jcfg = _smoke(dtype="bfloat16")
    tcfg = _tcfg(jcfg)
    jparams = jjamba.JambaLM(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jparams, "cpu")
    gj = jax.tree.map(lambda a: a[0], jparams["layers"])
    gt = tjamba._sub(tparams["layers"], 0)
    tokens = np.random.RandomState(3).randint(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    jx = jtfm.embed(jparams, jnp.asarray(tokens), jcfg)
    tx = ttfm.embed(tparams, torch.from_numpy(tokens), tcfg)
    assert tx.dtype == torch.bfloat16
    np.testing.assert_array_equal(_t(tx), _np(jx))
    pos = jnp.arange(16, dtype=jnp.int32)
    tpos = torch.arange(16, dtype=torch.int32)

    def same(j, t, what):
        assert t.dtype == torch.bfloat16, what
        np.testing.assert_allclose(_t(t), _np(j), **BF16_MODEL, err_msg=what)

    attn_o, _, moe_os, dense_os = jjamba._offsets(jcfg)
    m_i, jaux, taux = 0, 0.0, 0.0
    def bf16(j):
        return torch.from_numpy(np.array(_np(j))).to(torch.bfloat16)

    for o in range(jjamba.PERIOD):
        xt = bf16(jx)
        if o == attn_o:
            ja, _ = jtfm.attention_block(gj["attn"], jx, jcfg, positions=pos)
            ta, _ = ttfm.attention_block(gt["attn"], xt, tcfg,
                                         positions=tpos)
        else:
            ja, _ = jmamba.mamba_mixer(jjamba._sub(gj["mamba"], m_i), jx,
                                       jcfg)
            ta = tmamba.mamba_mixer(tjamba._sub(gt["mamba"], m_i), xt, tcfg)
            m_i += 1
        same(ja, ta, f"offset {o} mixer")
        jx = jx + ja
        xt = bf16(jx)
        if o in moe_os:
            i = moe_os.index(o)
            jm_, a_j = jmoe.moe_ffn(jjamba._sub(gj["moe"], i), jx, jcfg,
                                    return_aux=True)
            tm_, a_t = tmoe.moe_ffn(tjamba._sub(gt["moe"], i), xt, tcfg,
                                    return_aux=True)
            jaux, taux = jaux + float(a_j), taux + float(a_t)
        else:
            i = dense_os.index(o)
            jm_ = jtfm.mlp_block(jjamba._sub(gj["dense"], i), jx, jcfg)
            tm_ = ttfm.mlp_block(tjamba._sub(gt["dense"], i), xt, tcfg)
        same(jm_, tm_, f"offset {o} ffn")
        jx = jx + jm_
    np.testing.assert_allclose(taux, jaux, rtol=1e-3)
    same(jtfm.unembed(jparams, jx, jcfg),
         ttfm.unembed(tparams, bf16(jx), tcfg), "logits")


def test_jamba_forward_matches_pallas_interpret_reference():
    """Mirrors test_xla_vs_pallas_interpret_forward[hybrid]: the JAX model
    on its Pallas flash and ssd kernels in interpret mode, 64 tokens,
    against the port's CPU path (atol 2e-3)."""
    jcfg = tiny_config("hybrid")
    jm = jbuild_model(jcfg, impl="pallas_interpret")
    jparams = jm.init(jax.random.PRNGKey(1))
    tm = model_zoo.build_model(_tcfg(jcfg))
    tokens = np.random.RandomState(9).randint(
        0, jcfg.vocab_size, (2, 64)).astype(np.int32)
    want = jm.forward(jparams, {"tokens": jnp.asarray(tokens)})
    got = tm.forward(params_from_numpy(jparams, "cpu"),
                     {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(_t(got), _np(want), atol=2e-3)


def test_jamba_prefill_and_decode_match_forward():
    """Mirrors test_prefill_and_decode_match_forward[hybrid] for the port
    alone (atol 5e-4): the cached path agrees with a full forward, and the
    plain impl equals the auto one on the CPU.  At the reference's tiny
    hybrid config (capacity factor 8): with capacity drops, a decode step's
    two-token group routes otherwise than the full forward, in the
    reference as here."""
    jcfg = tiny_config("hybrid")
    tm = tjamba.JambaLM(_tcfg(jcfg))
    tparams = params_from_numpy(
        jjamba.JambaLM(jcfg).init(jax.random.PRNGKey(2)), "cpu")
    tok = torch.from_numpy(np.random.RandomState(10).randint(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32))
    cache = tm.init_cache(2, 20, device="cpu")
    last, cache = tm.prefill(tparams, tok, cache)
    full = tm.forward(tparams, {"tokens": tok})
    np.testing.assert_allclose(_t(last), _t(full[:, -1]), atol=5e-4)
    nxt = torch.argmax(last, -1).to(torch.int32)[:, None]
    logits2, cache = tm.decode_step(tparams, nxt, cache, 16)
    full2 = tm.forward(tparams, {"tokens": torch.cat([tok, nxt], 1)})
    np.testing.assert_allclose(_t(logits2), _t(full2[:, -1]), atol=5e-4)
    plain = model_zoo.build_model(tm.cfg, impl="plain")
    assert torch.equal(plain.forward(tparams, {"tokens": tok}), full)


def test_jamba_compute_params_keep_the_bits():
    """Casting the cast-at-use leaves once ahead (what ServeEngine keeps)
    gives the bits of the model's per-product casts; the router, A_log,
    dt_bias and the norm weights stay fp32; both stacking levels split."""
    jcfg = _smoke(dtype="bfloat16")
    tm = tjamba.JambaLM(_tcfg(jcfg))
    tparams = params_from_numpy(
        jjamba.JambaLM(jcfg).init(jax.random.PRNGKey(0)), "cpu")
    cp = tm.compute_params(tparams)
    assert isinstance(cp["layers"], list) and len(cp["layers"]) == 1
    g = cp["layers"][0]
    assert [len(g[k]) for k in ("mamba", "moe", "dense")] == [7, 4, 4]
    bf16, f32 = torch.bfloat16, torch.float32
    for key in ("in_proj", "conv_w", "conv_b", "w_dt", "w_B", "w_C",
                "D_skip", "out_proj"):
        assert g["mamba"][3][key].dtype == bf16, key
    for key in ("A_log", "dt_bias", "ln", "norm_w"):
        assert g["mamba"][3][key].dtype == f32, key
    for key in ("wi", "wg", "wo"):
        assert g["moe"][1][key].dtype == bf16, key
        assert g["dense"][1][key].dtype == bf16, key
    assert g["moe"][1]["router"].dtype == f32
    assert g["moe"][1]["ln"].dtype == g["dense"][1]["ln"].dtype == f32
    for key in ("wq", "wk", "wv", "wo"):
        assert g["attn"][key].dtype == bf16, key
    assert cp["final_ln"].dtype == f32 and cp["lm_head"].dtype == bf16
    assert set(tjamba.CAST_KEYS) == {
        "wq", "wk", "wv", "wo", "wi", "wg", "embedding", "lm_head",
        "in_proj", "conv_w", "conv_b", "w_dt", "w_B", "w_C", "D_skip",
        "out_proj"}
    tokens = torch.from_numpy(
        np.random.RandomState(5).randint(0, 2048, (2, 10)).astype(np.int32))
    assert torch.equal(tm.forward(cp, {"tokens": tokens}),
                       tm.forward(tparams, {"tokens": tokens}))
    got, want = (tm.prefill(params, tokens,
                            tm.init_cache(2, 12, device="cpu"))[0]
                 for params in (cp, tparams))      # the cached path as well
    assert torch.equal(got, want)


def test_build_model_returns_jamba_for_hybrid_and_still_raises_for_moe():
    """hybrid builds JambaLM; the moe family, which raised until MoELM was
    ported, now builds ``moe.MoELM`` on the same ``moe_ffn``."""
    m = model_zoo.build_model(_tcfg(tiny_config("hybrid")), impl="plain")
    assert isinstance(m, tjamba.JambaLM) and m.impl == "plain"
    moe_lm = model_zoo.build_model(_tcfg(tiny_config("moe")), impl="plain")
    assert type(moe_lm) is tmoe.MoELM and moe_lm.impl == "plain"


# ---------------------------------------------------------------------------
# ServeEngine and the serve CLI
# ---------------------------------------------------------------------------


def test_serve_engine_greedy_tokens_match_reference():
    jcfg = _smoke()
    jm = jbuild_model(jcfg, max_seq=40)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = model_zoo.build_model(_tcfg(jcfg), max_seq=40)
    tparams = params_from_numpy(jparams, "cpu")
    batch = {"tokens": np.random.RandomState(6).randint(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32)}
    want = JServeEngine(jm, jparams, max_seq=40, batch=2).generate(
        batch, max_new_tokens=8)
    got = ServeEngine(tm, tparams, max_seq=40, batch=2,
                      device="cpu").generate(batch, max_new_tokens=8)
    assert got.tokens.shape == (2, 24) and got.steps == 8
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_serve_cli_runs_jamba_smoke_and_refuses_full_width():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--device",
            "cpu", "--arch", JAMBA]
    out = subprocess.run(
        base + ["--preset", "smoke", "--batch", "2", "--prompt-len", "16",
                "--gen", "4"],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["arch"] == JAMBA and res["generated"] == 4
    assert res["device"] == "cpu" and res["decode_tokens_per_s"] > 0
    out = subprocess.run(base + ["--preset", "full"], capture_output=True,
                         text=True, timeout=120, env=env, cwd=REPO)
    assert out.returncode != 0
    assert "397.6 B parameters do not fit one card" in out.stderr
