"""Port parity for LM training: ``launch/train.py`` (``train`` and
``main``) and ``training/train_step.py`` (``CapturedTrainStep`` with ``load_state_``,
``train_state_from_reference`` and its inverse)
against the reference's training loop.

Mirrors tests/test_arch_smoke.py::test_smoke_forward_and_train_step and
the reference's ``repro/launch/train.py:main``: one arch per family at
``--preset smoke`` starts both packages from the reference's initial state
(carried across by ``train_state_from_reference``; the port's init draws
from Philox, the reference's from threefry), then runs 6 steps of the
reference's jitted step on its ``SyntheticTokenStream`` beside the port's
``train(...)`` on the CPU.

Free running (the port's ``train`` beside the reference's loop): losses
rtol 1e-4 at every step, ``lr`` rtol 1e-6 (the schedule's fp32 cos lies
one ulp apart at step 6).  Teacher-forced (each step again from the
reference's own state before it, carried across): losses rtol 1e-5, grad
norms rtol 1e-3.  Grad norms are not held free running: AdamW's first
steps move every parameter by about lr whatever the size of its gradient,
so entries whose gradient is round-off in one package and another in the
other move apart by ~lr, and the two runs' grad norms drift (llama3.2-1b's
smoke config: 1.6e-4 at step 1 from the same params, 1.3e-2 at step 5).
whisper-small's free-running losses are held at rtol 1e-3: its smoke
config's fp32 gradients are ill-conditioned (the reference's own lie up to
1.8e-2 from a float64 evaluation on ``embedding``/``dec_pos``, of max-abs
7.2, the port's 3.2e-3), and its losses drift 4.3e-4 apart by step 5.
Resume is held bit for bit."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.configs import get_arch as jget_arch
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data.synthetic import SyntheticTokenStream as JStream
from repro.launch.train import reduced_config as jreduced
from repro.models import model_zoo as jzoo
from repro.optim.adamw import AdamWState as JAdamWState
from repro.optim.adamw import QTensor as JQTensor
from repro.training import TrainState as JTrainState
from repro.training import make_train_state as jmake_train_state
from repro.training import make_train_step as jmake_train_step
from repro_torch.checkpoint import BF16Bits
from repro_torch.configs import get_arch
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import train as ttrain
from repro_torch.models import model_zoo
from repro_torch.optim.adamw import QTensor
from repro_torch.training import (
    CapturedTrainStep, make_train_state, train_state_from_reference,
    train_state_to_reference,
)

FAMILY_ARCH = {"dense": "llama3.2-1b", "moe": "qwen2-moe-a2.7b",
               "rwkv6": "rwkv6-7b", "hybrid": "jamba-1.5-large-398b",
               "encdec": "whisper-small", "vlm": "internvl2-2b"}
STEPS, BATCH, SEQ = 6, 2, 32
LOSS_RTOL, GNORM_RTOL = 1e-4, 1e-3
LR_RTOL = 1e-6          # the schedule's fp32 cos: one ulp apart at step 6
# whisper-small's free-running losses (see the module docstring)
CURVE_RTOL = {"encdec": 1e-3}


def _ref_run(arch, steps=STEPS, batch=BATCH, seq=SEQ, lr=3e-4, seed=0,
             moments=""):
    """The reference's training loop (``repro/launch/train.py:main``) on the
    CPU: (the state before each step and after the last, the batches,
    per-step metrics)."""
    spec = jget_arch(arch)
    cfg = jreduced(spec.model, "smoke")
    tcfg = JTrainConfig(
        learning_rate=lr, warmup_steps=min(50, steps // 10 + 1),
        decay_steps=steps, schedule=spec.train.schedule,
        stable_steps=spec.train.stable_steps, opt_moments=moments)
    model = jzoo.build_model(cfg, max_seq=seq)
    states = [jmake_train_state(model.init(jax.random.PRNGKey(seed)), tcfg)]
    step_fn = jax.jit(jmake_train_step(jzoo.make_loss_fn(model), tcfg))
    stream = JStream(cfg, JShapeConfig("cli", seq, batch, "train"),
                     seed=seed)
    batches, out = [], []
    for _ in range(steps):
        batches.append(next(stream))
        state, m = step_fn(states[-1], {k: jnp.asarray(v)
                                        for k, v in batches[-1].items()})
        states.append(state)
        out.append({k: float(v) for k, v in m.items()})
    return states, batches, out


def _port(arch, init_state, **kw):
    kw.setdefault("steps", STEPS)
    return ttrain.train(arch, "smoke", batch=BATCH, seq=SEQ, device="cpu",
                        init_state=init_state, **kw)


def check_loss_curve(family):
    """The port's ``train(...)`` beside the reference's loop from one
    state: ``lr`` and the losses at every step (free running); then each
    step again from the reference's own state before it (carried across),
    on its batch: loss and grad norm (teacher-forced)."""
    arch = FAMILY_ARCH[family]
    states, batches, want = _ref_run(arch)
    out = _port(arch, train_state_from_reference(states[0], "cpu"))
    got = out["metrics"]
    assert len(got) == len(want) == STEPS and out["start_step"] == 0
    assert out["captures"] == out["replays"] == 0       # the CPU: eager
    assert ("moe_aux" in got[0]) == (family in ("moe", "hybrid"))
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), i
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=LR_RTOL,
                                   err_msg=f"step {i + 1}")
        np.testing.assert_allclose(g["loss"], w["loss"],
                                   rtol=CURVE_RTOL.get(family, LOSS_RTOL),
                                   err_msg=f"step {i + 1}")
    assert out["final_loss"] == got[-1]["loss"]

    spec = get_arch(arch)
    model = model_zoo.build_model(ttrain.reduced_config(spec.model, "smoke"),
                                  impl="plain", max_seq=SEQ)
    step = CapturedTrainStep(model_zoo.make_loss_fn(model),
                             ttrain.train_config(arch, STEPS, 3e-4),
                             train_state_from_reference(states[0], "cpu"))
    for i, (b, w) in enumerate(zip(batches, want)):
        step.load_state_(states[i])
        g = step({k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(g["loss"]), w["loss"], rtol=1e-5,
                                   err_msg=f"step {i + 1}")
        np.testing.assert_allclose(float(g["grad_norm"]), w["grad_norm"],
                                   rtol=GNORM_RTOL, err_msg=f"step {i + 1}")
        if "moe_aux" in w:
            np.testing.assert_allclose(float(g["moe_aux"]), w["moe_aux"],
                                       rtol=1e-5)
        assert int(step.state.step) == i + 1


@pytest.mark.parametrize("family", ["dense", "moe", "rwkv6"])
def test_loss_curve_matches_reference(family):
    check_loss_curve(family)


def _leaves(state):
    return [np.asarray(x.bits if isinstance(x, BF16Bits) else x)
            for x in pytree.tree_leaves(train_state_to_reference(state))]


def test_resume_is_bit_exact_on_the_cpu(tmp_path):
    """6 straight steps with a checkpoint every 3 == the step-3 checkpoint,
    ``resume`` and 3 more."""
    state0 = _ref_run("llama3.2-1b", steps=1)[0][0]
    d = str(tmp_path / "ck")
    straight = _port("llama3.2-1b", train_state_from_reference(state0, "cpu"),
                     ckpt_dir=d, ckpt_every=3)
    assert sorted(os.listdir(d)) == ["ckpt_00000003.pkl", "ckpt_00000006.pkl"]
    os.unlink(os.path.join(d, "ckpt_00000006.pkl"))
    fresh = make_train_state(model_zoo.build_model(
        ttrain.reduced_config(get_arch("llama3.2-1b").model, "smoke"),
        impl="plain").init(torch.Generator().manual_seed(5), device="cpu"),
        TrainConfig())
    resumed = _port("llama3.2-1b", fresh, ckpt_dir=d, resume=True)
    assert resumed["start_step"] == 3 and len(resumed["metrics"]) == 3
    assert resumed["metrics"] == straight["metrics"][3:]
    for a, b in zip(_leaves(resumed["step"].state),
                    _leaves(straight["step"].state)):
        np.testing.assert_array_equal(a, b)


def test_cli_prints_the_reference_lines(capsys, tmp_path):
    out = ttrain.main(["--arch", "llama3.2-1b", "--preset", "smoke",
                       "--steps", "4", "--batch", "2", "--seq", "16",
                       "--log-every", "2", "--ckpt-dir",
                       str(tmp_path / "ck"), "--ckpt-every", "2",
                       "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("arch=llama3.2-1b preset=smoke params=")
    assert lines[0].endswith("M")
    steps = [ln for ln in lines if ln.startswith("step ")]
    assert len(steps) == 2
    for n, ln in zip((2, 4), steps):
        head, rest = ln.split(" loss=")
        assert int(head.split()[1]) == n
        assert [kv.split("=")[0] for kv in ("loss=" + rest).split()] == [
            "loss", "lr", "gnorm", "tok/s"]
    final = json.loads(lines[-1])
    assert set(final) == {"final_loss", "steps", "tokens_per_second"}
    assert final["steps"] == 4 and final["final_loss"] == out["final_loss"]
    assert sorted(os.listdir(tmp_path / "ck")) == [
        "ckpt_00000002.pkl", "ckpt_00000004.pkl"]
    resumed = ttrain.main(["--steps", "4", "--batch", "2", "--seq", "16",
                           "--ckpt-dir", str(tmp_path / "ck"), "--resume",
                           "--device", "cpu"])
    assert "resumed at step 4" in capsys.readouterr().out
    assert resumed["metrics"] == [] and resumed["start_step"] == 4


def test_cli_raises_without_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(["--steps", "1", "--seq", "16", "--batch", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.train(steps=1, seq=16, batch=1)


def test_train_builds_the_plain_model(monkeypatch):
    seen = []
    build = model_zoo.build_model

    def spy(cfg, **kw):
        seen.append(kw.get("impl"))
        return build(cfg, **kw)

    monkeypatch.setattr(ttrain.model_zoo, "build_model", spy)
    ttrain.train(steps=1, batch=1, seq=16, device="cpu")
    assert seen and seen[0] == "plain"


@pytest.mark.parametrize("moments,param_dtype", [
    ("fp32", "float32"), ("bf16", "float32"), ("int8", "float32"),
    ("fp32", "bfloat16")])
def test_train_state_round_trips_every_moment_format(moments, param_dtype):
    """The reference's state after one step (moments non-zero) -> the
    port's -> the host: every leaf bit for bit, QTensor layouts kept; the
    port's step from it equals the reference's next step."""
    spec = jget_arch("llama3.2-1b")
    cfg = jreduced(spec.model, "smoke").replace(param_dtype=param_dtype)
    tcfg = JTrainConfig(learning_rate=1e-3, warmup_steps=1, decay_steps=4,
                        opt_moments=moments)
    model = jzoo.build_model(cfg, max_seq=SEQ)
    jstep = jax.jit(jmake_train_step(jzoo.make_loss_fn(model), tcfg))
    stream = JStream(cfg, JShapeConfig("cli", SEQ, BATCH, "train"))
    state, _ = jstep(jmake_train_state(model.init(jax.random.PRNGKey(0)),
                                       tcfg),
                     {k: jnp.asarray(v) for k, v in next(stream).items()})
    port = train_state_from_reference(state, "cpu")
    q = [x for x in pytree.tree_leaves(port.opt.mu,
                                       is_leaf=lambda t: isinstance(t, QTensor))
         if isinstance(x, QTensor)]
    assert bool(q) == (moments == "int8")
    back = train_state_to_reference(port)
    jleaves = jax.tree.leaves(state)
    bleaves = [x.bits if isinstance(x, BF16Bits) else x
               for x in pytree.tree_leaves(back)]
    jleaves = [x for x in jleaves if not isinstance(x, int)]
    assert len(bleaves) == len(jleaves)
    for a, b in zip(bleaves, jleaves):
        b = np.asarray(b)
        if b.dtype.name == "bfloat16":
            b = b.view(np.uint16)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # rebuilt as the reference's own types, its step takes it back
    def ref_tree(t):
        if isinstance(t, QTensor):
            return JQTensor(jnp.asarray(t.q), jnp.asarray(t.scale), t.block,
                            t.axis)
        if isinstance(t, dict):
            return {k: ref_tree(v) for k, v in t.items()}
        if isinstance(t, BF16Bits):
            return jnp.asarray(t.bits).view(jnp.bfloat16)
        return jnp.asarray(t)

    rebuilt = JTrainState(ref_tree(back.step), ref_tree(back.params),
                          JAdamWState(ref_tree(back.opt.step),
                                      ref_tree(back.opt.mu),
                                      ref_tree(back.opt.nu)))
    batch = next(stream)
    _, want = jstep(rebuilt, {k: jnp.asarray(v) for k, v in batch.items()})
    _, want0 = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})
    assert float(want["loss"]) == float(want0["loss"])
    tstep = CapturedTrainStep(
        model_zoo.make_loss_fn(model_zoo.build_model(
            ttrain.reduced_config(get_arch("llama3.2-1b").model, "smoke")
            .replace(param_dtype=param_dtype), impl="plain")),
        TrainConfig(learning_rate=1e-3, warmup_steps=1, decay_steps=4,
                    opt_moments=moments), port)
    got = tstep({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(got["lr"]), float(want["lr"]),
                               rtol=1e-7)
    assert int(port.step) == int(port.opt.step) == 2


def test_captured_step_writes_its_state_in_place():
    """On the CPU the step runs eagerly, writes the new state into the
    tensors it was given (the addresses a graph would replay on), and
    ``load_state_`` restores a checkpoint tree into them; another
    structure, shape or dtype raises."""
    cfg = ttrain.reduced_config(get_arch("llama3.2-1b").model, "smoke")
    model = model_zoo.build_model(cfg, impl="plain")
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1, decay_steps=4)
    state = make_train_state(
        model.init(torch.Generator().manual_seed(0), device="cpu"), tc)
    snap = train_state_to_reference(state)
    ptrs = [t.data_ptr() for t in pytree.tree_leaves(state)]
    step = CapturedTrainStep(model_zoo.make_loss_fn(model), tc, state)
    stream = JStream(cfg, JShapeConfig("cli", SEQ, BATCH, "train"))
    batches = [{k: torch.from_numpy(v) for k, v in next(stream).items()}
               for _ in range(2)]
    m1 = {k: float(v) for k, v in step(batches[0]).items()}
    step(batches[1])
    assert int(state.step) == 2 and step.captures == step.replays == 0
    assert [t.data_ptr() for t in pytree.tree_leaves(step.state)] == ptrs
    step.load_state_(snap)
    assert int(state.step) == 0
    assert [t.data_ptr() for t in pytree.tree_leaves(step.state)] == ptrs
    assert {k: float(v) for k, v in step(batches[0]).items()} == m1
    bad = train_state_to_reference(state)
    bad.params["embedding"] = bad.params["embedding"][:1]
    with pytest.raises(ValueError, match="embedding"):
        step.load_state_(bad)
    bad = train_state_to_reference(state)
    del bad.params["final_ln"]
    with pytest.raises(ValueError, match="keys differ"):
        step.load_state_(bad)
