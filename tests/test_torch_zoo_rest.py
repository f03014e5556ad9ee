"""Port parity for the four LM archs served last: h2o-danube-3-4b (a
sliding window that binds, a head dim of 120), minicpm-2b (MHA, tied
embeddings, a padded vocab), mistral-nemo-12b (an explicit head dim, H * hd
!= d_model) and qwen3-moe-235b-a22b (qk-norm, 16 experts top-8, G = 16),
each at a small config that keeps its feature (``_zoo_rest.SMALL``),
against the JAX package with ``impl='xla'`` on the same weights (the
reference's ``init`` carried across by ``params_from_numpy``) and the same
numpy inputs.

Mirrors, on the port: tests/test_models.py::test_gqa_grouping_uses_shared_kv,
test_sliding_window_changes_logits and test_vocab_padding_rounds_up, and
tests/test_arch_smoke.py::test_all_ten_archs_registered,
test_full_config_matches_assignment and test_shape_assignments, each run
as the reference test's own code through ``_port_rebind`` with the names
it reads rebound to the port's (its models built by the port; the JAX key
it passes seeds the port's generator, its JAX tokens go in as tensors and
its logits come back as numpy).

Tolerances: fp32 logits and cache entries rtol 1e-4, atol 1e-4 (the LM
zoo's, tests/test_torch_lm_zoo.py); greedy tokens equal to the
reference's argmax wherever its top-2 margin exceeds twice that."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_arch_smoke
import test_models
from _port_rebind import rebind
from _zoo_rest import ARCHS, PROMPT, STEPS, WINDOW, small
from conftest import tiny_config as jtiny_config
from repro.configs import get_arch as jget_arch
from repro.models import common as jcm
from repro.models.model_zoo import build_model as jbuild_model
from repro_torch.configs import base as tbase
from repro_torch.configs import get_arch, list_archs
from repro_torch.configs.qwen3_moe_235b_a22b import ONE_CARD_CUT
from repro_torch.core.committee import params_from_numpy
from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.models import common as tcm
from repro_torch.models import model_zoo
from repro_torch.serving import ServeEngine

FP32 = dict(rtol=1e-4, atol=1e-4)
B = 2
MAX_SEQ = PROMPT + STEPS


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return x.detach().to(torch.float32).numpy()


def _tcfg(jcfg):
    """The same ModelConfig as the port's dataclass."""
    return tbase.ModelConfig(**{f: getattr(jcfg, f) for f in
                                jcfg.__dataclass_fields__})


def _pair(arch, **kw):
    """(reference model, its params, port model, the same params) at the
    arch's small config."""
    jcfg = small(jget_arch(arch).model, arch, **kw)
    jm = jbuild_model(jcfg, impl="xla", max_seq=MAX_SEQ)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = model_zoo.build_model(_tcfg(jcfg), max_seq=MAX_SEQ)
    return jm, jparams, tm, params_from_numpy(jparams, "cpu")


def _jitted(jm):
    """The reference's prefill and decode step, each one jitted program."""
    return jax.jit(jm.prefill), jax.jit(jm.decode_step)


def _prompt(cfg, seed=3):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)


def _sure(logits):
    """Positions whose top-2 margin exceeds twice the logits' tolerance."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    tol = FP32["atol"] + FP32["rtol"] * np.abs(logits).max()
    return (top2[..., 1] - top2[..., 0]) > 2 * tol


# ---------------------------------------------------------------------------
# the small configs against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_and_cache_match_reference(arch):
    """Prefill logits and every cache entry, then 8 decode steps fed the
    reference's greedy tokens (the port's argmax equal to them wherever
    the margin allows): each step's logits, and the cache after them."""
    jm, jparams, tm, tparams = _pair(arch)
    cfg = tm.cfg
    assert tuple(tparams["embedding"].shape) == (cfg.padded_vocab,
                                                 cfg.d_model)
    tokens = _prompt(cfg)
    prefill, decode = _jitted(jm)
    jcache = jm.init_cache(B, MAX_SEQ)
    tcache = tm.init_cache(B, MAX_SEQ, device="cpu")
    jl, jcache = prefill(jparams, jnp.asarray(tokens), jcache)
    tl, tcache2 = tm.prefill(tparams, torch.from_numpy(tokens), tcache)
    assert tcache2 is tcache and set(tcache) == set(jcache)
    assert tuple(tl.shape) == (B, cfg.padded_vocab)
    np.testing.assert_allclose(_t(tl), _np(jl), **FP32)
    for key in jcache:
        assert tuple(tcache[key].shape) == jcache[key].shape
        np.testing.assert_allclose(_t(tcache[key]), _np(jcache[key]),
                                   **FP32, err_msg=key)
    for i in range(STEPS):
        want = _np(jl)
        nxt = want.argmax(-1).astype(np.int32)
        sure = _sure(want)
        np.testing.assert_array_equal(_t(tl).argmax(-1)[sure], nxt[sure])
        jl, jcache = decode(jparams, jnp.asarray(nxt[:, None]), jcache,
                            jnp.int32(PROMPT + i))
        tl, tcache = tm.decode_step(tparams, torch.from_numpy(nxt[:, None]),
                                    tcache, PROMPT + i)
        np.testing.assert_allclose(_t(tl), _np(jl), **FP32,
                                   err_msg=f"decode step {i}")
    for key in jcache:
        np.testing.assert_allclose(_t(tcache[key]), _np(jcache[key]),
                                   **FP32, err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_greedy_tokens_match_reference(arch):
    """Greedy ``ServeEngine.generate`` on the CPU (the captured engine's
    programs run eagerly): every token equals the argmax of the reference's
    logits teacher-forced on the port's tokens wherever the margin allows."""
    jm, jparams, tm, tparams = _pair(arch)
    prompt = _prompt(tm.cfg, seed=6)
    got = ServeEngine(tm, tparams, max_seq=MAX_SEQ, batch=B,
                      device="cpu").generate({"tokens": prompt},
                                             max_new_tokens=STEPS)
    assert got.tokens.shape == (B, PROMPT + STEPS) and got.steps == STEPS
    np.testing.assert_array_equal(got.tokens[:, :PROMPT], prompt)
    toks = got.tokens[:, PROMPT:]
    assert ((toks >= 0) & (toks < tm.cfg.padded_vocab)).all()
    prefill, decode = _jitted(jm)
    jl, jcache = prefill(jparams, jnp.asarray(prompt),
                         jm.init_cache(B, MAX_SEQ))
    logits = [_np(jl)]
    for i in range(STEPS - 1):
        jl, jcache = decode(jparams, jnp.asarray(toks[:, i:i + 1]), jcache,
                            jnp.int32(PROMPT + i))
        logits.append(_np(jl))
    logits = np.stack(logits, axis=1)
    sure = _sure(logits)
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(toks[sure], logits.argmax(-1)[sure])


def test_danube_window_binds():
    """The window-off twin of the small danube config, on the same weights:
    the forward's logits agree where every key lies in the window and
    differ past it, and so do the prefill's and each decode step's (every
    one of them past the window), on the port as on the reference."""
    arch = "h2o-danube-3-4b"
    jm, jparams, tm, tparams = _pair(arch)
    twin = model_zoo.build_model(tm.cfg.replace(sliding_window=None),
                                 max_seq=MAX_SEQ)
    jtwin = jbuild_model(jm.cfg.replace(sliding_window=None), impl="xla",
                         max_seq=MAX_SEQ)
    tokens = np.random.RandomState(4).randint(
        0, tm.cfg.vocab_size, (B, MAX_SEQ)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens)}
    a, b = _t(tm.forward(tparams, batch)), _t(twin.forward(tparams, batch))
    np.testing.assert_allclose(a[:, :WINDOW], b[:, :WINDOW], atol=1e-5)
    assert not np.allclose(a[:, WINDOW:], b[:, WINDOW:], **FP32)
    jb = _np(jtwin.forward(jparams, {"tokens": jnp.asarray(tokens)}))
    np.testing.assert_allclose(b, jb, **FP32)
    ca = tm.init_cache(B, MAX_SEQ, device="cpu")
    cb = twin.init_cache(B, MAX_SEQ, device="cpu")
    pa, _ = tm.prefill(tparams, batch["tokens"][:, :PROMPT], ca)
    pb, _ = twin.prefill(tparams, batch["tokens"][:, :PROMPT], cb)
    assert not np.allclose(_t(pa), _t(pb), **FP32)
    for i in range(STEPS):
        nxt = batch["tokens"][:, PROMPT + i:PROMPT + i + 1]
        da, _ = tm.decode_step(tparams, nxt, ca, PROMPT + i)
        db, _ = twin.decode_step(tparams, nxt, cb, PROMPT + i)
        np.testing.assert_allclose(_t(da), a[:, PROMPT + i], **FP32)
        assert not np.allclose(_t(da), _t(db), **FP32), i


# ---------------------------------------------------------------------------
# the published configs: specs, paths, the qwen3-moe cut
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_specs_match_reference(arch):
    """At the published config (specs only, no allocation): the parameter
    and cache shapes are the reference's (``wq`` (D, H, hd) and ``wo`` (H,
    hd, D) with the explicit head dim, the embedding over the padded vocab,
    no ``lm_head`` when tied, qk-norm weights of hd)."""
    jcfg = jget_arch(arch).model
    jm = jbuild_model(jcfg, max_seq=4096)
    tm = model_zoo.build_model(get_arch(arch).model, max_seq=4096)
    jshapes = jax.tree.map(lambda s: s.shape, jm.param_specs(),
                           is_leaf=jcm.is_spec)
    assert tcm.map_specs(lambda s: s.shape, tm.param_specs()) == jshapes
    jcache = jax.tree.map(lambda s: s.shape, jm.cache_specs(8, 576),
                          is_leaf=jcm.is_spec)
    assert tcm.map_specs(lambda s: s.shape, tm.cache_specs(8, 576)) == jcache
    cfg = tm.cfg
    attn = tm.param_specs()["layers"]["attn"]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    assert attn["wq"].shape[1:] == (cfg.d_model, H, hd)
    assert attn["wo"].shape[1:] == (H, hd, cfg.d_model)
    assert ("lm_head" in tm.param_specs()) == (not cfg.tie_embeddings)
    assert ("q_norm" in attn) == cfg.qk_norm


@pytest.mark.parametrize("arch,path", [
    ("h2o-danube-3-4b", "split"), ("minicpm-2b", "split"),
    ("mistral-nemo-12b", "split"), ("qwen3-moe-235b-a22b", "tiled")])
def test_serving_decode_path_at_full_width(arch, path):
    """The flash wrapper's rule at the served decode shape (B = 8, one
    token, the whole cache): G <= 8 (t, g) rows per kv head take the split
    path; qwen3-moe's 64 heads over 4 kv heads are 16 rows, so its every
    decode step is tiled (its prefill is tiled as every prefill)."""
    cfg = get_arch(arch).model
    S = 4672 if arch == "h2o-danube-3-4b" else 576
    assert fa_kernel.plan(8, 1, S, cfg.num_heads, cfg.num_kv_heads).path \
        == path
    assert fa_kernel.plan(8, 512, 512, cfg.num_heads,
                          cfg.num_kv_heads).path == "tiled"
    assert cfg.resolved_head_dim in fa_kernel.HEAD_DIMS


def test_qwen3_moe_one_card_cut_count_is_its_docstring():
    """ONE_CARD_CUT keeps every width and cuts the depth to 4 of 94
    layers: 11,195,683,840 params (67.2 GB at 6 bytes)."""
    full = get_arch("qwen3-moe-235b-a22b").model
    assert ONE_CARD_CUT == {"num_layers": 4}
    n = model_zoo.count_params(full.replace(**ONE_CARD_CUT))
    assert n == 11_195_683_840 and f"{n:,}" in _one_card_doc()
    assert round(6 * n / 1e9, 1) == 67.2


def _one_card_doc():
    """The docstring under qwen3-moe's ONE_CARD_CUT (read from the
    source)."""
    import ast
    import inspect

    from repro_torch.configs import qwen3_moe_235b_a22b as qcfg

    body = ast.parse(inspect.getsource(qcfg)).body
    for a, b in zip(body, body[1:]):
        if isinstance(a, ast.Assign) and a.targets[0].id == "ONE_CARD_CUT":
            return b.value.value
    raise AssertionError("no docstring under ONE_CARD_CUT")


# ---------------------------------------------------------------------------
# reference tests run on the port (_port_rebind)
# ---------------------------------------------------------------------------


def _port_tiny_config(family, **kw):
    """conftest's ``tiny_config`` as the port's ModelConfig."""
    return _tcfg(jtiny_config(family, **kw))


class _PortModel:
    """The port's model behind the calls the reference tests make: ``init``
    takes the JAX key (which seeds the port's generator), ``forward`` takes
    the test's JAX arrays and returns the logits as numpy."""

    def __init__(self, cfg, **kw):
        self.m = model_zoo.build_model(cfg, **kw)

    def init(self, key):
        seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
        return self.m.init(torch.Generator().manual_seed(seed),
                           device="cpu")

    def forward(self, params, batch):
        out = self.m.forward(params, {k: torch.from_numpy(np.array(v))
                                      for k, v in batch.items()})
        return out.detach().numpy()


MODEL_NAMES = dict(tiny_config=_port_tiny_config, build_model=_PortModel)


@pytest.mark.parametrize("name", [
    "test_gqa_grouping_uses_shared_kv", "test_sliding_window_changes_logits",
    "test_vocab_padding_rounds_up"])
def test_reference_model_test_on_the_port(name, rng):
    fn = rebind(test_models, name, **MODEL_NAMES)
    fn(rng) if fn.__code__.co_argcount else fn()


ARCH_NAMES = dict(ARCHS=list_archs(), get_arch=get_arch)


def test_all_ten_archs_registered_on_the_port():
    rebind(test_arch_smoke, "test_all_ten_archs_registered", **ARCH_NAMES)()


@pytest.mark.parametrize("arch", list_archs())
def test_full_config_matches_assignment_on_the_port(arch):
    rebind(test_arch_smoke, "test_full_config_matches_assignment",
           **ARCH_NAMES)(arch)


@pytest.mark.parametrize("arch", list_archs())
def test_shape_assignments_on_the_port(arch):
    rebind(test_arch_smoke, "test_shape_assignments", **ARCH_NAMES)(arch)
