"""Port parity for the rest of the LM zoo: ``models.moe.MoELM`` (qwen2-moe,
qwen3-moe), ``models.whisper.WhisperLM`` (whisper-small) and
``models.internvl.InternVLM`` (internvl2-2b), with
``common.sinusoidal_positions``, ``transformer.lm_loss``,
``model_zoo.make_loss_fn`` / ``make_prefill_fn`` / ``count_params`` and
``ServeEngine.generate`` with frame and patch embeddings, against the JAX
package with ``impl='xla'`` on the same weights (the reference's ``init``
carried across by ``params_from_numpy``) and the same numpy inputs.

Mirrors tests/test_models.py (test_forward_shapes_and_finite,
test_prefill_and_decode_match_forward, test_moe_aux_loss_positive_and_
bounded, test_lm_loss_ignores_negative_labels), tests/test_arch_smoke.py
(test_smoke_forward_and_train_step, test_smoke_serve_step) and
tests/test_serving_and_dryrun.py:21-42 (greedy ServeEngine tokens).

Tolerances: fp32 logits rtol 1e-4, atol 1e-4; losses and the MoE aux term
rtol 1e-5; prefill + decode
against the port's own forward at the reference's atol 5e-4; greedy tokens
equal to the reference's argmax on every position whose top-2 margin there
exceeds twice the logits' tolerance.  The logits' atol is 1e-4, not 1e-5:
the reference's own fp32 logits at whisper-small's smoke config lie 1.6e-4
from the same model evaluated in float64 (the port's are 1.1e-4 from it),
so an atol of 1e-5 separates no fault from round-off there (the port and
the reference differ by up to 5.3e-5 on logits of max-abs 0.9)."""
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
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data.synthetic import synthetic_batch as jsynthetic_batch
from repro.launch.train import reduced_config as jreduced
from repro.models import common as jcm
from repro.models import transformer as jtfm
from repro.models.model_zoo import build_model as jbuild_model
from repro.models.model_zoo import count_params as jcount
from repro.models.model_zoo import make_loss_fn as jmake_loss_fn
from repro.serving import ServeEngine as JServeEngine
from repro.training import make_train_state as jmake_train_state
from repro.training import make_train_step as jmake_train_step
from repro_torch.configs import base as tbase
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.configs.qwen2_moe_a2p7b import ONE_CARD_CUT
from repro_torch.core.committee import (params_from_numpy, tree_leaves,
                                        tree_paths)
from repro_torch.data.synthetic import synthetic_batch
from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.launch.train import reduced_config
from repro_torch.models import common as tcm
from repro_torch.models import internvl as tinternvl
from repro_torch.models import model_zoo
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from repro_torch.models import whisper as twhisper
from repro_torch.serving import ServeEngine
from repro_torch.training import make_train_state, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP32 = dict(rtol=1e-4, atol=1e-4)
LOSS = dict(rtol=1e-5)
FAMILIES = ["moe", "encdec", "vlm"]
ARCHS = ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b", "whisper-small",
         "internvl2-2b"]
CLASSES = {"moe": tmoe.MoELM, "encdec": twhisper.WhisperLM,
           "vlm": tinternvl.InternVLM}
B, T = 2, 16


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return x.detach().to(torch.float32).numpy()


def _tcfg(jcfg):
    """The same ModelConfig as the port's dataclass."""
    return tbase.ModelConfig(**{f: getattr(jcfg, f) for f in
                                jcfg.__dataclass_fields__})


def _extras(cfg, seed=7, scale=1.0):
    """The prefill inputs beside the tokens, numpy from a seed."""
    rng = np.random.RandomState(seed)
    if cfg.family == "encdec":
        return {"enc_embeds": (rng.randn(B, cfg.encoder_seq, cfg.d_model)
                               * scale).astype(np.float32)}
    if cfg.family == "vlm":
        return {"patch_embeds": (rng.randn(B, cfg.vision_tokens, cfg.d_model)
                                 * scale).astype(np.float32)}
    return {}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _pair(jcfg, max_seq=T + 8, seed=0):
    """(reference model, its params, port model, the same params)."""
    jm = jbuild_model(jcfg, impl="xla", max_seq=max_seq)
    jparams = jm.init(jax.random.PRNGKey(seed))
    tm = model_zoo.build_model(_tcfg(jcfg), max_seq=max_seq)
    return jm, jparams, tm, params_from_numpy(jparams, "cpu")


def _forward(m, params, batch):
    if m.cfg.family == "moe":
        return m.forward(params, batch, return_aux=True)
    return m.forward(params, batch), None


# ---------------------------------------------------------------------------
# common.sinusoidal_positions, transformer.lm_loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,d", [(1500, 768), (24, 64), (5, 2), (7, 9)])
def test_sinusoidal_positions_match_reference(n, d):
    """Built in float64 and cast to fp32 once: the same bits."""
    got = tcm.sinusoidal_positions(n, d)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, d - d % 2)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jcm.sinusoidal_positions(n, d)))


@pytest.mark.parametrize("case", ["plain", "ignored", "mask", "z_loss",
                                  "bf16"])
def test_lm_loss_matches_reference(case):
    rng = np.random.RandomState(3)
    logits = (rng.randn(2, 8, 32) * 3).astype(np.float32)
    labels = rng.randint(0, 32, (2, 8)).astype(np.int32)
    kw_j, kw_t = {}, {}
    if case in ("ignored", "mask", "z_loss"):
        labels[0, :3] = -1
        labels[1, 5] = -1
    if case == "mask":
        mask = (rng.rand(2, 8) > 0.4).astype(np.int32)
        kw_j["mask"], kw_t["mask"] = jnp.asarray(mask), torch.from_numpy(mask)
    if case == "z_loss":
        kw_j["z_loss_coef"] = kw_t["z_loss_coef"] = 1e-3
    jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    if case == "bf16":
        jl, tl = jl.astype(jnp.bfloat16), tl.to(torch.bfloat16)
    want, wm = jtfm.lm_loss(jl, jnp.asarray(labels), **kw_j)
    got, gm = ttfm.lm_loss(tl, torch.from_numpy(labels), **kw_t)
    assert got.dtype == torch.float32 and set(gm) == set(wm)
    np.testing.assert_allclose(float(got), float(want), **LOSS)
    for k in wm:
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), **LOSS,
                                   err_msg=k)


def test_lm_loss_ignores_negative_labels():
    """Mirrors tests/test_models.py::test_lm_loss_ignores_negative_labels."""
    logits = torch.from_numpy(
        np.random.RandomState(0).randn(2, 8, 32).astype(np.float32))
    labels = torch.full((2, 8), -1, dtype=torch.int32)
    labels[0, 0] = 3
    loss, metrics = ttfm.lm_loss(logits, labels)
    assert float(metrics["tokens"]) == 1.0 and torch.isfinite(loss)
    want = torch.logsumexp(logits[0, 0], -1) - logits[0, 0, 3]
    np.testing.assert_allclose(float(loss), float(want), **LOSS)
    none, m0 = ttfm.lm_loss(logits, torch.full((2, 8), -1))
    assert float(none) == 0.0 and float(m0["tokens"]) == 0.0


# ---------------------------------------------------------------------------
# specs, weights, counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
def test_build_model_and_param_specs_match_reference_tree(family):
    jcfg = tiny_config(family)
    jm = jbuild_model(jcfg, max_seq=40)
    tm = model_zoo.build_model(_tcfg(jcfg), impl="plain", max_seq=40)
    assert type(tm) is CLASSES[family] and tm.impl == "plain"
    jshapes = jax.tree.map(lambda s: s.shape, jm.param_specs(),
                           is_leaf=jcm.is_spec)
    assert tcm.map_specs(lambda s: s.shape, tm.param_specs()) == jshapes
    jcache = jax.tree.map(lambda s: s.shape, jm.cache_specs(2, 30),
                          is_leaf=jcm.is_spec)
    assert tcm.map_specs(lambda s: s.shape, tm.cache_specs(2, 30)) == jcache


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_match_reference(arch):
    """From the specs, no allocation; Whisper's dec_pos at max_seq rows."""
    cfg = get_arch(arch).model
    for max_seq in (448, 4096):
        assert model_zoo.count_params(cfg, max_seq) == jcount(
            jget_arch(arch).model, max_seq)
    if arch == "whisper-small":
        assert (model_zoo.count_params(cfg, 4096)
                - model_zoo.count_params(cfg, 448)) == (4096 - 448) * 768


def test_qwen2_moe_one_card_cut_count_is_its_docstring():
    """ONE_CARD_CUT keeps every width and cuts the depth to 16 layers:
    9,751,201,792 params (58.5 GB at 6 bytes), of 14,315,636,736 whole."""
    full = get_arch("qwen2-moe-a2.7b").model
    assert ONE_CARD_CUT == {"num_layers": 16}
    n = model_zoo.count_params(full.replace(**ONE_CARD_CUT))
    assert n == 9_751_201_792 and f"{n:,}" in _one_card_doc()
    assert model_zoo.count_params(full) == 14_315_636_736
    assert round(6 * n / 1e9, 1) == 58.5
    assert round(6 * model_zoo.count_params(full) / 1e9, 1) == 85.9


def _one_card_doc():
    """The docstring under ONE_CARD_CUT (a module-level string, read from
    the source)."""
    import ast
    import inspect

    from repro_torch.configs import qwen2_moe_a2p7b as qcfg

    body = ast.parse(inspect.getsource(qcfg)).body
    for a, b in zip(body, body[1:]):
        if isinstance(a, ast.Assign) and a.targets[0].id == "ONE_CARD_CUT":
            return b.value.value
    raise AssertionError("no docstring under ONE_CARD_CUT")


@pytest.mark.parametrize("family", FAMILIES)
def test_params_from_numpy_takes_the_tree_unchanged(family):
    """encoder / decoder / dec_pos / mm_proj / moe leaves carry across as
    they are: the same key paths, shapes, dtypes and values."""
    jparams = jbuild_model(tiny_config(family), max_seq=40).init(
        jax.random.PRNGKey(0))
    tparams = params_from_numpy(jparams, "cpu")
    jpaths = [tuple(getattr(k, "key", k) for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert tree_paths(tparams) == jpaths
    for t, j in zip(tree_leaves(tparams), jax.tree_util.tree_leaves(jparams)):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    want = {"moe": {"layers", "embedding", "final_ln", "lm_head"},
            "encdec": {"encoder", "enc_final_ln", "decoder", "dec_pos",
                       "embedding", "final_ln"},
            "vlm": {"layers", "embedding", "final_ln", "lm_head",
                    "mm_proj"}}[family]
    assert set(tparams) == want


# ---------------------------------------------------------------------------
# forward, prefill, decode against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_prefill_decode_match_reference(family):
    """forward logits (and the MoE aux term), prefill logits and every
    cache entry, then 4 decode steps teacher-forced with the reference's
    greedy tokens, and the cache after them."""
    jcfg = tiny_config(family)
    n_prefix = jcfg.vision_tokens if family == "vlm" else 0
    jm, jparams, tm, tparams = _pair(jcfg)
    tokens = np.random.RandomState(3).randint(
        0, jcfg.vocab_size, (B, T)).astype(np.int32)
    extras = _extras(jcfg)
    batch = dict(tokens=tokens, **extras)

    want, jaux = _forward(jm, jparams, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    got, taux = _forward(tm, tparams, _torch_batch(batch))
    assert tuple(got.shape) == want.shape == (B, T, jcfg.padded_vocab)
    np.testing.assert_allclose(_t(got), _np(want), **FP32)
    if family == "moe":
        np.testing.assert_allclose(float(taux), float(jaux), **LOSS)

    S = n_prefix + T + 5
    jcache = jm.init_cache(B, S)
    tcache = tm.init_cache(B, S, device="cpu")
    kw_j = {k: jnp.asarray(v) for k, v in extras.items()}
    kw_t = {k: torch.from_numpy(v) for k, v in extras.items()}
    jl, jcache = jm.prefill(jparams, jnp.asarray(tokens), jcache, **kw_j)
    tl, tcache2 = tm.prefill(tparams, torch.from_numpy(tokens), tcache,
                             **kw_t)
    assert tcache2 is tcache and set(tcache) == set(jcache)
    np.testing.assert_allclose(_t(tl), _np(jl), **FP32)
    for key in jcache:
        assert tuple(tcache[key].shape) == jcache[key].shape
        np.testing.assert_allclose(_t(tcache[key]), _np(jcache[key]),
                                   **FP32, err_msg=key)
    for i in range(4):
        nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)[:, None]
        idx = n_prefix + T + i
        jl, jcache = jm.decode_step(jparams, jnp.asarray(nxt), jcache,
                                    jnp.int32(idx))
        tl, tcache = tm.decode_step(tparams, torch.from_numpy(nxt), tcache,
                                    idx)
        np.testing.assert_allclose(_t(tl), _np(jl), **FP32,
                                   err_msg=f"decode step {i}")
    for key in jcache:
        np.testing.assert_allclose(_t(tcache[key]), _np(jcache[key]),
                                   **FP32, err_msg=key)


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_shapes_and_finite(family):
    """Mirrors tests/test_models.py::test_forward_shapes_and_finite: the
    loss through ``make_loss_fn`` is finite; text-only logits for vlm."""
    cfg = _tcfg(tiny_config(family))
    m = model_zoo.build_model(cfg, max_seq=T)
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (B, T)).astype(np.int32))
    batch = dict(tokens=tokens, labels=tokens,
                 **_torch_batch(_extras(cfg)))
    loss, metrics = model_zoo.make_loss_fn(m)(params, batch)
    assert torch.isfinite(loss) and float(loss) > 0
    logits, _ = _forward(m, params, batch)
    assert tuple(logits.shape) == (B, T, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("family", FAMILIES)
def test_prefill_and_decode_match_forward(family):
    """Mirrors tests/test_models.py::test_prefill_and_decode_match_forward
    for the port alone (atol 5e-4), and the plain impl equals the auto one
    on the CPU."""
    cfg = _tcfg(tiny_config(family))
    m = model_zoo.build_model(cfg, max_seq=T + 4)
    params = params_from_numpy(jbuild_model(
        tiny_config(family), max_seq=T + 4).init(jax.random.PRNGKey(2)),
        "cpu")
    n_prefix = cfg.vision_tokens if family == "vlm" else 0
    tok = torch.from_numpy(np.random.RandomState(10).randint(
        0, cfg.vocab_size, (B, T)).astype(np.int32))
    extras = {k: torch.from_numpy(v) for k, v in _extras(cfg).items()}
    cache = m.init_cache(B, T + n_prefix + 4, device="cpu")
    last, cache = m.prefill(params, tok, cache, **extras)
    full, _ = _forward(m, params, dict(tokens=tok, **extras))
    np.testing.assert_allclose(_t(last), _t(full[:, -1]), atol=5e-4)
    nxt = torch.argmax(last, -1).to(torch.int32)[:, None]
    logits2, cache = m.decode_step(params, nxt, cache, T + n_prefix)
    full2, _ = _forward(m, params, dict(tokens=torch.cat([tok, nxt], 1),
                                        **extras))
    np.testing.assert_allclose(_t(logits2), _t(full2[:, -1]), atol=5e-4)
    plain = model_zoo.build_model(cfg, impl="plain", max_seq=T + 4)
    assert torch.equal(_forward(plain, params, dict(tokens=tok, **extras))[0],
                       full)


def test_moe_aux_loss_positive_and_bounded():
    """Mirrors tests/test_models.py::test_moe_aux_loss_positive_and_
    bounded, and the value is the reference's (rtol 1e-5)."""
    jcfg = tiny_config("moe")
    jm, jparams, tm, tparams = _pair(jcfg)
    tok = np.random.RandomState(4).randint(0, jcfg.vocab_size, (B, T)
                                           ).astype(np.int32)
    _, aux = tm.forward(tparams, {"tokens": torch.from_numpy(tok)},
                        return_aux=True)
    assert 0.0 < float(aux) < 10.0
    _, jaux = jm.forward(jparams, {"tokens": jnp.asarray(tok)},
                         return_aux=True)
    np.testing.assert_allclose(float(aux), float(jaux), **LOSS)


@pytest.mark.parametrize("family", ["dense", "moe", "rwkv6", "hybrid",
                                    "encdec", "vlm"])
@pytest.mark.parametrize("z_loss_coef", [0.0, 1e-4])
def test_make_loss_fn_matches_reference(family, z_loss_coef):
    """Every family: the loss, its metrics and the MoE aux term (moe, and
    hybrid with experts) at rtol 1e-5."""
    jcfg = tiny_config(family)
    jm, jparams, tm, tparams = _pair(jcfg, max_seq=T)
    tok = np.random.RandomState(5).randint(0, jcfg.vocab_size, (B, T)
                                           ).astype(np.int32)
    labels = np.roll(tok, -1, axis=1)
    labels[:, -1] = -1
    batch = dict(tokens=tok, labels=labels, **_extras(jcfg))
    want, wm = jmake_loss_fn(jm, z_loss_coef)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    got, gm = model_zoo.make_loss_fn(tm, z_loss_coef)(
        tparams, _torch_batch(batch))
    assert set(gm) == set(wm)
    assert ("moe_aux" in gm) == (family in ("moe", "hybrid"))
    np.testing.assert_allclose(float(got), float(want), **LOSS)
    for k in wm:
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), **LOSS,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# tests/test_arch_smoke.py at the reduced "smoke" configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_and_train_step(arch):
    """Mirrors tests/test_arch_smoke.py::test_smoke_forward_and_train_step:
    the loss on the reference's synthetic batch equals the reference's on
    its weights (rtol 1e-5); one AdamW step gives the reference's loss and
    a finite grad norm, at lr 0 (the warm-up's first step, in both
    packages); a second step changes the params."""
    jcfg = jreduced(jget_arch(arch).model, "smoke")
    cfg = reduced_config(get_arch(arch).model, "smoke")
    assert _tcfg(jcfg) == cfg
    seq = 64
    jm, jparams, m, params = _pair(jcfg, max_seq=seq)
    jbatch = jsynthetic_batch(jcfg, JShapeConfig("smoke", seq, B, "train"), 0)
    batch = synthetic_batch(cfg, ShapeConfig("smoke", seq, B, "train"), 0)
    assert set(batch) == set(jbatch)
    for k in batch:
        np.testing.assert_array_equal(batch[k], np.asarray(jbatch[k]))
    tbatch = _torch_batch(batch)
    loss_fn = model_zoo.make_loss_fn(m)
    loss, _ = loss_fn(params, tbatch)
    want, _ = jmake_loss_fn(jm)(jparams, {k: jnp.asarray(v)
                                          for k, v in jbatch.items()})
    assert torch.isfinite(loss) and float(loss) > 0
    np.testing.assert_allclose(float(loss), float(want), **LOSS)

    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1, decay_steps=10)
    step = make_train_step(loss_fn, tc)
    state, m2 = step(make_train_state(params, tc), tbatch)
    jstate, jm2 = jax.jit(jmake_train_step(jmake_loss_fn(jm), tc))(
        jmake_train_state(jparams, tc), {k: jnp.asarray(v)
                                         for k, v in jbatch.items()})
    assert torch.isfinite(m2["loss"]) and torch.isfinite(m2["grad_norm"])
    assert int(state.step) == int(jstate.step) == 1
    assert float(m2["lr"]) == float(jm2["lr"]) == 0.0
    np.testing.assert_allclose(float(m2["loss"]), float(jm2["loss"]), **LOSS)
    state, m3 = step(state, tbatch)
    assert float(m3["lr"]) > 0 and torch.isfinite(m3["loss"])
    delta = sum(float((a - b).abs().sum()) for a, b in
                zip(tree_leaves(params), tree_leaves(state.params)))
    assert delta > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_serve_step(arch):
    """Mirrors tests/test_arch_smoke.py::test_smoke_serve_step: one prefill
    and one decode step at the smoke config, against the reference."""
    jcfg = jreduced(jget_arch(arch).model, "smoke")
    jm, jparams, m, params = _pair(jcfg, max_seq=T + 8)
    n_prefix = jcfg.vision_tokens if jcfg.family == "vlm" else 0
    tok = np.random.RandomState(1).randint(0, jcfg.vocab_size, (B, T)
                                           ).astype(np.int32)
    extras = _extras(jcfg, scale=0.02)
    jl, jcache = jm.prefill(jparams, jnp.asarray(tok),
                            jm.init_cache(B, T + n_prefix + 8),
                            **{k: jnp.asarray(v) for k, v in extras.items()})
    last, cache = m.prefill(params, torch.from_numpy(tok),
                            m.init_cache(B, T + n_prefix + 8, device="cpu"),
                            **{k: torch.from_numpy(v)
                               for k, v in extras.items()})
    assert tuple(last.shape) == (B, jcfg.padded_vocab)
    assert bool(torch.isfinite(last).all())
    np.testing.assert_allclose(_t(last), _np(jl), **FP32)
    nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    jl2, _ = jm.decode_step(jparams, jnp.asarray(nxt), jcache,
                            jnp.int32(T + n_prefix))
    logits, _ = m.decode_step(params, torch.from_numpy(nxt), cache,
                              T + n_prefix)
    assert tuple(logits.shape) == (B, jcfg.padded_vocab)
    assert bool(torch.isfinite(logits).all())
    np.testing.assert_allclose(_t(logits), _np(jl2), **FP32)


# ---------------------------------------------------------------------------
# compute_params and ServeEngine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
def test_compute_params_keep_the_bits(family):
    """Casting the cast-at-use leaves once ahead (what ServeEngine keeps)
    gives the bits of the model's per-product casts: every stack split
    (Whisper's encoder and decoder), dec_pos / mm_proj / the shared
    experts' gate cast, the router and the norm weights fp32."""
    jcfg = tiny_config(family, dtype="bfloat16")
    _, _, tm, tparams = _pair(jcfg, max_seq=T + 4)
    cp = tm.compute_params(tparams)
    bf16, f32 = torch.bfloat16, torch.float32
    stacks = (("encoder", "decoder") if family == "encdec"
              else ("layers",))
    for key in stacks:
        depth = jcfg.encoder_layers if key == "encoder" else jcfg.num_layers
        assert isinstance(cp[key], list) and len(cp[key]) == depth
    if family == "moe":
        moe = cp["layers"][1]["moe"]
        assert moe["router"].dtype == moe["ln"].dtype == f32
        assert moe["wi"].dtype == moe["shared"]["gate"].dtype == bf16
    if family == "encdec":
        assert cp["dec_pos"].dtype == cp["decoder"][0]["ffn"]["wi"].dtype \
            == bf16
        assert cp["enc_final_ln"].dtype == f32
    if family == "vlm":
        assert cp["mm_proj"].dtype == bf16
    tok = torch.from_numpy(np.random.RandomState(5).randint(
        0, jcfg.vocab_size, (B, 10)).astype(np.int32))
    extras = {k: torch.from_numpy(v) for k, v in _extras(jcfg).items()}
    got, want = (_forward(tm, p, dict(tokens=tok, **extras))[0]
                 for p in (cp, tparams))
    assert got.dtype == bf16 and torch.equal(got, want)
    n_prefix = jcfg.vision_tokens if family == "vlm" else 0
    got, want = (tm.prefill(p, tok, tm.init_cache(B, n_prefix + 12,
                                                  device="cpu"), **extras)[0]
                 for p in (cp, tparams))
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch,layers", [
    ("qwen2-moe-a2.7b", 1), ("qwen2-moe-a2.7b", 2), ("whisper-small", 1),
    ("whisper-small", 2), ("internvl2-2b", 1), ("internvl2-2b", 2)])
def test_serve_engine_greedy_tokens_match_reference(arch, layers):
    """Greedy ``generate`` at 1-2 layers of the smoke config, in fp32: every
    token equals the argmax of the reference's logits, teacher-forced on the
    port's tokens, wherever their top-2 margin exceeds the logits'
    tolerance; the frame / patch embeddings go through the engine."""
    jcfg = jreduced(jget_arch(arch).model, "smoke").replace(num_layers=layers)
    n_prefix = jcfg.vision_tokens if jcfg.family == "vlm" else 0
    P, gen = 12, 6
    max_seq = n_prefix + P + gen + 2
    jm, jparams, tm, tparams = _pair(jcfg, max_seq=max_seq)
    batch = dict(tokens=np.random.RandomState(6).randint(
        0, jcfg.vocab_size, (B, P)).astype(np.int32),
        **_extras(jcfg, seed=8, scale=0.02))
    got = ServeEngine(tm, tparams, max_seq=max_seq, batch=B,
                      device="cpu").generate(batch, max_new_tokens=gen)
    assert got.tokens.shape == (B, P + gen) and got.steps == gen
    np.testing.assert_array_equal(got.tokens[:, :P], batch["tokens"])
    toks = got.tokens[:, P:]
    # the reference, teacher-forced on the port's tokens
    jl, jcache = jax.jit(jm.prefill)(
        jparams, jnp.asarray(batch["tokens"]), jm.init_cache(B, max_seq),
        **{k: jnp.asarray(v) for k, v in batch.items() if k != "tokens"})
    logits = [_np(jl)]
    for i in range(gen - 1):
        jl, jcache = jm.decode_step(jparams, jnp.asarray(toks[:, i:i + 1]),
                                    jcache, jnp.int32(n_prefix + P + i))
        logits.append(_np(jl))
    logits = np.stack(logits, axis=1)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    tol = FP32["atol"] + FP32["rtol"] * np.abs(logits).max()
    sure = (top2[..., 1] - top2[..., 0]) > 2 * tol
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(toks[sure], logits.argmax(-1)[sure])
    want = JServeEngine(jm, jparams, max_seq=max_seq, batch=B).generate(
        batch, max_new_tokens=gen)
    if sure.all():
        np.testing.assert_array_equal(got.tokens, want.tokens)


def test_serve_engine_moves_frame_and_patch_embeddings_in_the_model_dtype():
    """``generate`` hands the prefill tensors on the engine's device in the
    activation dtype, whatever numpy dtype the caller gave."""
    seen = {}
    for family in ("encdec", "vlm"):
        cfg = _tcfg(tiny_config(family, dtype="bfloat16"))
        m = model_zoo.build_model(cfg, max_seq=24)
        params = m.init(torch.Generator().manual_seed(0), device="cpu")
        prefill = m.prefill

        def spy(p, tokens, cache, **kw):
            seen.update({k: (v.dtype, v.device.type) for k, v in kw.items()})
            return prefill(p, tokens, cache, **kw)

        m.prefill = spy
        eng = ServeEngine(m, params, max_seq=24, batch=B, device="cpu")
        extras = {k: v.astype(np.float64) for k, v in _extras(cfg).items()}
        res = eng.generate(dict(tokens=np.ones((B, 4), np.int32), **extras),
                           max_new_tokens=3)
        assert res.tokens.shape == (B, 7)
    assert seen == {"enc_embeds": (torch.bfloat16, "cpu"),
                    "patch_embeds": (torch.bfloat16, "cpu")}


def test_whisper_refuses_positions_past_dec_pos():
    cfg = _tcfg(tiny_config("encdec"))
    m = model_zoo.build_model(cfg, max_seq=8)
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    cache = m.init_cache(1, 8, device="cpu")
    extras = {k: torch.from_numpy(v[:1]) for k, v in _extras(cfg).items()}
    m.prefill(params, torch.ones((1, 8), dtype=torch.int32), cache, **extras)
    with pytest.raises(ValueError, match="past dec_pos"):
        m.decode_step(params, torch.ones((1, 1), dtype=torch.int32), cache, 8)


def test_cpu_path_launches_no_flash_kernel():
    before = fa_kernel.launches
    for family in FAMILIES:
        cfg = _tcfg(tiny_config(family))
        m = model_zoo.build_model(cfg, max_seq=T)
        params = m.init(torch.Generator().manual_seed(0), device="cpu")
        batch = dict(tokens=torch.ones((B, 8), dtype=torch.int32),
                     **_torch_batch(_extras(cfg)))
        _forward(m, params, batch)
    assert fa_kernel.launches == before


@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-2b",
                                  "qwen2-moe-a2.7b"])
def test_serve_cli_runs_the_new_families_and_refuses_moe_full_width(arch):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--device",
            "cpu", "--arch", arch]
    out = subprocess.run(base + ["--preset", "smoke", "--batch", "2",
                                 "--prompt-len", "8", "--gen", "3"],
                         capture_output=True, text=True, timeout=120,
                         env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["arch"] == arch and res["generated"] == 3
    if arch.startswith("qwen"):
        full = subprocess.run(base + ["--preset", "full"],
                              capture_output=True, text=True, timeout=120,
                              env=env, cwd=REPO)
        assert full.returncode != 0
        assert "14.3 B parameters do not fit one card" in full.stderr
