"""Port parity for the remat policy: ``models/transformer._remat`` and
``scan_stack`` in every LM family, and the autograd gradient of
``training/train_step.make_train_step`` that takes checkpointed layers.

Mirrors tests/test_models.py::test_remat_modes_do_not_change_values for
each of the six families (the losses under none / dots / full agree to
abs 1e-5, as the reference holds them; the port's gradients too, since a
checkpoint is taken only under a gradient), then holds the port's loss
and gradients under "dots" against ``jax.value_and_grad`` of the
reference's ``make_loss_fn`` under "dots", with the reference's params
carried across: the loss at rtol 1e-5 and the global gradient norm at rtol
1e-3, the teacher-forced tolerances of tests/test_torch_lm_train.py, and
each gradient leaf at rtol 1e-3 of its largest entry.

The policy's decisions are recorded op by op for one dense and one MoE
layer and held against the reference's own einsums (the ``dot_general``s
of the layer's jaxpr): "dots" saves exactly the products with no batch
dims there (the projections and the router) and recomputes the batched
ones (attention, the expert einsums) and every other op.  The decisions
are read from the policy itself, not from an outer ``saved_tensors_hooks``
(the checkpoint's own hooks sit inside one and hide what it saves)."""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree
from torch.utils.checkpoint import CheckpointPolicy

from conftest import tiny_config
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.models.model_zoo import build_model as jbuild_model
from repro.models.model_zoo import make_loss_fn as jmake_loss_fn
from repro_torch.configs import base as tbase
from repro_torch.configs.base import TrainConfig
from repro_torch.core.committee import params_from_numpy
from repro_torch.models import model_zoo
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tfm
from repro_torch.training import make_train_state, make_train_step

FAMILIES = ["dense", "moe", "hybrid", "rwkv6", "encdec", "vlm"]
B, T = 2, 16
LOSS = dict(rtol=1e-5)        # tests/test_torch_lm_train.py, teacher-forced
GNORM_RTOL = 1e-3             # the same file's grad-norm tolerance
LEAF_RTOL = 1e-3              # each leaf, of its largest entry


def _tcfg(jcfg, **kw):
    """The same ModelConfig as the port's dataclass."""
    return tbase.ModelConfig(**{f: getattr(jcfg, f) for f in
                                jcfg.__dataclass_fields__}).replace(**kw)


def _batch(cfg):
    """tokens, labels (the last ignored) and the frame / patch embeddings,
    numpy from a seed."""
    rng = np.random.RandomState(5)
    tok = rng.randint(0, cfg.vocab_size, (B, T)).astype(np.int32)
    labels = np.roll(tok, -1, axis=1)
    labels[:, -1] = -1
    out = {"tokens": tok, "labels": labels}
    if cfg.family == "encdec":
        out["enc_embeds"] = rng.randn(B, cfg.encoder_seq,
                                      cfg.d_model).astype(np.float32)
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.randn(B, cfg.vision_tokens,
                                        cfg.d_model).astype(np.float32)
    return out


def _ref_params(jcfg):
    return jbuild_model(jcfg, impl="xla", max_seq=T).init(
        jax.random.PRNGKey(0))


def _port_value_and_grad(cfg, params, batch):
    """The port's loss and gradient leaves under ``cfg.remat``, through
    ``torch.autograd.grad`` (as the LM step takes them)."""
    model = model_zoo.build_model(cfg, impl="plain", max_seq=T)
    ps = pytree.tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, _ = model_zoo.make_loss_fn(model)(
        ps, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, pytree.tree_leaves(ps))
    return float(loss.detach()), [g.numpy() for g in grads]


def _checkpointed_units(cfg):
    """Layers (groups for the hybrid) one forward checkpoints."""
    if cfg.family == "hybrid":
        return cfg.num_layers // 8
    if cfg.family == "encdec":
        return cfg.num_layers + cfg.encoder_layers
    return cfg.num_layers


@pytest.mark.parametrize("family", FAMILIES)
def test_remat_modes_do_not_change_values(family, monkeypatch):
    """Loss (abs 1e-5, the reference's) and every gradient leaf (abs 1e-6)
    under none / dots / full; dots and full checkpoint each layer (each
    group for the hybrid, encoder and decoder layers for encdec)."""
    jcfg = tiny_config(family)
    params = params_from_numpy(_ref_params(jcfg), "cpu")
    batch = _batch(jcfg)
    calls = collections.Counter()
    real = tfm.checkpoint

    def counting(fn, *args, **kw):
        calls[kw["context_fn"] is not tfm.noop_context_fn] += 1
        return real(fn, *args, **kw)

    monkeypatch.setattr(tfm, "checkpoint", counting)
    out = {}
    for remat in ("none", "dots", "full"):
        calls.clear()
        cfg = _tcfg(jcfg, remat=remat)
        out[remat] = _port_value_and_grad(cfg, params, batch)
        n = _checkpointed_units(cfg)
        want = {"none": {}, "dots": {True: n}, "full": {False: n}}[remat]
        assert dict(calls) == want, remat
    for remat in ("dots", "full"):
        assert out[remat][0] == pytest.approx(out["none"][0], abs=1e-5)
        for g, w in zip(out[remat][1], out["none"][1]):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


@pytest.mark.parametrize("family", FAMILIES)
def test_dots_loss_and_gradients_match_reference(family):
    """The reference's ``jax.value_and_grad(make_loss_fn)`` under "dots"
    beside the port's under "dots", from the same params and batch."""
    jcfg = tiny_config(family, remat="dots")
    jparams = _ref_params(jcfg)
    batch = _batch(jcfg)
    jm = jbuild_model(jcfg, impl="xla", max_seq=T)
    jl, jg = jax.value_and_grad(lambda p: jmake_loss_fn(jm)(
        p, {k: jnp.asarray(v) for k, v in batch.items()})[0])(jparams)
    tl, tg = _port_value_and_grad(_tcfg(jcfg),
                                  params_from_numpy(jparams, "cpu"), batch)
    np.testing.assert_allclose(tl, float(jl), **LOSS)
    jleaves = [np.asarray(j, np.float32)
               for j in jax.tree_util.tree_leaves(jg)]
    assert len(jleaves) == len(tg)
    gnorm = np.sqrt(sum(float(np.sum(np.square(t, dtype=np.float64)))
                        for t in tg))
    want = np.sqrt(sum(float(np.sum(np.square(j, dtype=np.float64)))
                       for j in jleaves))
    np.testing.assert_allclose(gnorm, want, rtol=GNORM_RTOL)
    for t, j in zip(tg, jleaves):
        assert t.shape == j.shape
        np.testing.assert_allclose(t, j, rtol=LEAF_RTOL,
                                   atol=LEAF_RTOL * np.abs(j).max())


# ---------------------------------------------------------------------------
# The policy, op by op, against the reference's einsums
# ---------------------------------------------------------------------------


def _ref_products(f, *args):
    """The reference layer's ``dot_general``s as (no batch dims, (rows,
    contraction, columns)): rows the lhs's free size, columns the rhs's."""
    out = []

    def size(shape, dims):
        return int(np.prod([shape[d] for d in dims]))

    def walk(jx):
        for e in jx.eqns:
            if e.primitive.name == "dot_general":
                (lc, rc), (lb, rb) = e.params["dimension_numbers"]
                ls, rs = (v.aval.shape for v in e.invars)
                lfree = [d for d in range(len(ls)) if d not in (*lc, *lb)]
                rfree = [d for d in range(len(rs)) if d not in (*rc, *rb)]
                out.append((not lb, (size(ls, lfree), size(rs, rc),
                                     size(rs, rfree))))
            for v in e.params.values():
                for j in (v if isinstance(v, (list, tuple)) else [v]):
                    if hasattr(j, "jaxpr") and hasattr(j.jaxpr, "eqns"):
                        walk(j.jaxpr)
                    elif hasattr(j, "eqns"):
                        walk(j)

    walk(jax.make_jaxpr(f)(*args).jaxpr)
    return out


def _paths(tree, prefix=""):
    """storage address -> the leaf's path, for one layer's views."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, f"{prefix}{k}/"))
        else:
            out[v.untyped_storage().data_ptr()] = prefix + k
    return out


@pytest.mark.parametrize("family,saved", [
    ("dense", {"attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/wg",
               "mlp/wi", "mlp/wo"}),
    ("moe", {"attn/wq", "attn/wk", "attn/wv", "attn/wo", "moe/router",
             "moe/shared/wg", "moe/shared/wi", "moe/shared/wo",
             "moe/shared/gate"}),
])
def test_dots_saves_exactly_the_products_with_no_batch_dims(
        family, saved, monkeypatch):
    jcfg = tiny_config(family)
    jparams = _ref_params(jcfg)
    jpl = jax.tree.map(lambda a: a[0], jparams["layers"])
    pos = jnp.arange(T)
    if family == "dense":
        def jlayer(pl, x):
            return jtfm.dense_layer(pl, x, jcfg, positions=pos,
                                    impl="xla")[0]
    else:
        def jlayer(pl, x):
            return jmoe.moe_layer(pl, x, jcfg, positions=pos, impl="xla",
                                  with_aux=True)[0]
    ref = _ref_products(jlayer, jpl, jnp.zeros((B, T, jcfg.d_model)))

    cfg = _tcfg(jcfg, remat="dots")
    pl = pytree.tree_map(lambda t: t.detach().requires_grad_(),
                         tfm.layer_params(params_from_numpy(jparams, "cpu"),
                                          1)[0])
    names = _paths(pl)
    decisions = []
    real = tfm.dots_policy

    def recording(ctx, op, *args, **kwargs):
        policy = real(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            decisions.append((op, policy, args))
        return policy

    monkeypatch.setattr(tfm, "dots_policy", recording)
    positions = torch.arange(T, dtype=torch.int32)
    if family == "dense":
        def layer(p, x):
            return tfm.dense_layer(p, x, cfg, positions=positions,
                                   impl="plain")[0]
    else:
        def layer(p, x):
            return tmoe.moe_layer(p, x, cfg, positions=positions,
                                  impl="plain")[0]
    x = torch.from_numpy(np.random.RandomState(1).randn(
        B, T, cfg.d_model).astype(np.float32)).requires_grad_()
    tfm._remat(layer, "dots")(pl, x).sum().backward()

    must = CheckpointPolicy.MUST_SAVE
    kept = [(op, args) for op, policy, args in decisions if policy == must]
    assert all(op is torch.ops.aten.mm.default for op, _ in kept)
    assert {names.get(a[1].untyped_storage().data_ptr()) for _, a in kept} \
        == saved
    assert len(kept) == len(saved)
    # the same products as the reference's no-batch dot_generals, by
    # (rows, contraction, columns)
    assert sorted((a[0].shape[0], a[0].shape[1], a[1].shape[1])
                  for _, a in kept) == sorted(s for nb, s in ref if nb)
    # the reference's batched products are the recomputed bmm's
    bmm = [p for op, p, _ in decisions if op is torch.ops.aten.bmm.default]
    assert len(bmm) == sum(not nb for nb, _ in ref)
    assert len(bmm) == {"dense": 2, "moe": 7}[family]
    # everything but the no-batch products is recomputed, elementwise too
    rest = [op for op, p, _ in decisions if p != must]
    assert all(p == CheckpointPolicy.PREFER_RECOMPUTE
               for _, p, _ in decisions if p != must)
    assert len(rest) > len(kept)
    assert {torch.ops.aten.mul.Tensor, torch.ops.aten.bmm.default} <= \
        set(rest)


# ---------------------------------------------------------------------------
# Gradient paths and torch.func
# ---------------------------------------------------------------------------


def test_checkpointed_model_under_torch_func_raises():
    """A model with remat != "none" under ``torch.func.grad`` (or the
    functional step) raises instead of dropping the checkpoint; the same
    model with remat "none" runs there; a forward under ``vmap`` with
    nothing requiring grad, or under ``no_grad``, takes no checkpoint."""
    jcfg = tiny_config("dense")
    params = params_from_numpy(_ref_params(jcfg), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(jcfg).items()}
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1, decay_steps=10)
    for remat in ("dots", "full"):
        model = model_zoo.build_model(_tcfg(jcfg, remat=remat),
                                      impl="plain")
        loss_fn = model_zoo.make_loss_fn(model)
        with pytest.raises(RuntimeError, match="torch.func"):
            torch.func.grad(lambda p: loss_fn(p, batch)[0])(params)
        with pytest.raises(RuntimeError, match="torch.func"):
            make_train_step(loss_fn, tc, functional=True)(
                make_train_state(params, tc), batch)
        logits = torch.func.vmap(lambda t: model.forward(
            params, {"tokens": t}))(batch["tokens"][None])
        with torch.no_grad():
            assert torch.equal(logits[0], model.forward(params, batch))
    none = model_zoo.make_loss_fn(model_zoo.build_model(
        _tcfg(jcfg, remat="none"), impl="plain"))
    g = torch.func.grad(lambda p: none(p, batch)[0])(params)
    assert all(torch.isfinite(t).all() for t in pytree.tree_leaves(g))


@pytest.mark.parametrize("accum", [1, 2])
def test_autograd_step_equals_the_functional_step(accum):
    """The two gradient paths of ``make_train_step`` at remat "none", and
    the autograd path under "dots": the gradients of one batch within 1e-6
    of each leaf's largest entry (the paths' backward ops round apart by
    an ulp), and two steps, with and without gradient accumulation, with
    the same loss, grad norm and lr (rtol 1e-6); no path marks the
    state's params.  The params after AdamW are not held: its first steps
    move an entry by about lr whatever its gradient's size, so a gradient
    of round-off size moves apart by ~lr."""
    from repro_torch.training import train_step as tstep

    jcfg = tiny_config("dense")
    params = params_from_numpy(_ref_params(jcfg), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(jcfg).items()}
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1, decay_steps=10,
                     accum_steps=accum)
    runs = []
    for remat, functional in (("none", True), ("none", False),
                              ("dots", False)):
        loss_fn = model_zoo.make_loss_fn(model_zoo.build_model(
            _tcfg(jcfg, remat=remat), impl="plain"))
        grad_fn = (torch.func.grad_and_value(loss_fn, has_aux=True)
                   if functional else tstep._autograd_grad_and_value(loss_fn))
        grads, (loss, aux) = grad_fn(params, batch)
        assert not loss.requires_grad and not aux["nll"].requires_grad
        state = make_train_state(pytree.tree_map(torch.clone, params), tc)
        step = make_train_step(loss_fn, tc, functional=functional)
        metrics = []
        for _ in range(2):
            state, m = step(state, batch)
            metrics.append(m)
        assert not any(t.requires_grad for t in
                       pytree.tree_leaves((params, state.params)))
        runs.append((pytree.tree_leaves(grads), float(loss), metrics))
    (g0, l0, m0), *rest = runs
    for g, loss, ms in rest:
        assert loss == l0
        for a, b in zip(g, g0):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-6 * float(b.abs().max()))
        for m, w in zip(ms, m0):
            for k in ("loss", "grad_norm", "lr"):
                np.testing.assert_allclose(float(m[k]), float(w[k]),
                                           rtol=1e-6)
