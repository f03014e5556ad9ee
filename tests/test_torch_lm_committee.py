"""Port parity for the LM half of PAL: ``core/committee.py``'s committee
statistics and LM functions (``mean_std``, ``disagreement``,
``lm_token_nll``, ``lm_committee_uncertainty``, ``Committee``) and the
``examples/lm_active_distill.py`` twin (``repro_torch.examples.
lm_active_distill``): its student committee scored by the port's CPU
``FusedEngine`` and by the reference's, ``student_loss`` gradients against
``jax.grad``, the teacher's relabelling, and the loop itself on the CPU.
Everything runs on the same numpy inputs and the reference's own weights
(carried across by ``params_from_numpy``), with ``impl='xla'`` there.

Mirrors tests/test_core.py (test_committee_mean_std_ddof1,
test_committee_vmap_equals_member_loop,
test_lm_committee_uncertainty_zero_for_identical_members) and
examples/lm_active_distill.py.

Tolerances: means and NLL statistics rtol 1e-5; stds rtol 1e-4, atol 1e-6;
selection masks exact on rows whose std is further than the std tolerance
from the threshold; gradients rtol 1e-4 with an atol of 1e-4 times the
leaf's largest |gradient| (fp32: near-zero entries of a gradient summed
over 6 x 32 tokens and a 512-way softmax differ by the two frameworks'
summation orders, up to 1e-4 of the leaf's scale); teacher tokens exact
where the teacher's top-2 margin exceeds 1e-4."""
import importlib.util
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import acquisition as jacq
from repro.core import committee as jcmte
from repro_torch.core import acquisition as tacq
from repro_torch.core import committee as tcmte
from repro_torch.core.committee import params_from_numpy, tree_leaves
from repro_torch.examples import lm_active_distill as tdistill

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEAN = dict(rtol=1e-5)
STD = dict(rtol=1e-4, atol=1e-6)
GRAD_RTOL = 1e-4


def _reference_example():
    """The reference's examples/lm_active_distill.py as a module."""
    spec = importlib.util.spec_from_file_location(
        "_ref_lm_active_distill",
        os.path.join(REPO, "examples", "lm_active_distill.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    return _reference_example()


def _t(x):
    return x.detach().to(torch.float32).numpy()


# ---------------------------------------------------------------------------
# core/committee.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K", [1, 2, 4])
def test_committee_mean_std_ddof1(K):
    """Mirrors tests/test_core.py::test_committee_mean_std_ddof1, against
    numpy and the reference; a committee of one has std 0."""
    preds = np.random.RandomState(0).randn(K, 8, 3).astype(np.float32)
    mean, std = tcmte.mean_std(torch.from_numpy(preds))
    jmean, jstd = jcmte.mean_std(jnp.asarray(preds))
    want = (preds.std(axis=0, ddof=1) if K > 1
            else np.zeros_like(preds[0]))
    np.testing.assert_allclose(std.numpy(), want, **STD)
    np.testing.assert_allclose(std.numpy(), np.asarray(jstd), **STD)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), **MEAN)
    m1, s1 = tcmte.mean_std(torch.from_numpy(preds), dim=1)
    jm1, js1 = jcmte.mean_std(jnp.asarray(preds), axis=1)
    np.testing.assert_allclose(m1.numpy(), np.asarray(jm1), **MEAN)
    np.testing.assert_allclose(s1.numpy(), np.asarray(js1), **STD)


def test_disagreement_matches_reference():
    preds = np.random.RandomState(1).randn(4, 6, 3, 2).astype(np.float32)
    got = tcmte.disagreement(torch.from_numpy(preds))
    assert tuple(got.shape) == (6,)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jcmte.disagreement(jnp.asarray(preds))), **STD)


def test_committee_vmap_equals_member_loop():
    """Mirrors tests/test_core.py::test_committee_vmap_equals_member_loop;
    ``jit=`` is taken for the reference's signature; ``replace_member``
    swaps one member and leaves the old tree alone."""
    def apply_fn(p, x):
        return x @ p["w"]

    rng = np.random.RandomState(1)
    members = [{"w": torch.from_numpy(rng.randn(3, 2).astype(np.float32))}
               for _ in range(4)]
    cparams = tcmte.stack_members(members)
    x = torch.from_numpy(rng.randn(5, 3).astype(np.float32))
    for jit in (True, False):
        com = tcmte.Committee(apply_fn, cparams, jit=jit)
        assert com.size == 4
        preds, mean, std = com.predict(x)
        for i, m in enumerate(members):
            np.testing.assert_allclose(preds[i].numpy(),
                                       apply_fn(m, x).numpy(), rtol=1e-6)
        wm, ws = tcmte.mean_std(preds)
        assert torch.equal(mean, wm) and torch.equal(std, ws)
    new = {"w": torch.ones(3, 2)}
    com.replace_member(2, new)
    assert torch.equal(com.params["w"][2], new["w"])
    assert torch.equal(com.params["w"][1], members[1]["w"])
    assert torch.equal(cparams["w"][2], members[2]["w"])


def test_lm_committee_uncertainty_zero_for_identical_members():
    """Mirrors tests/test_core.py::test_lm_committee_uncertainty_zero_for_
    identical_members."""
    logits = torch.from_numpy(np.random.RandomState(0).randn(1, 2, 8, 16))
    clogits = torch.cat([logits, logits], dim=0)
    labels = torch.zeros((2, 8), dtype=torch.int32)
    mean, std = tcmte.lm_committee_uncertainty(clogits, labels)
    np.testing.assert_allclose(std.numpy(), 0.0, atol=1e-6)
    assert tuple(mean.shape) == (2,)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_token_nll_and_committee_uncertainty_match_reference(dtype):
    """Labels below 0 read token 0 (the reference's clip); the NLL is fp32
    whatever the logits' dtype."""
    rng = np.random.RandomState(2)
    clogits = (rng.randn(3, 2, 8, 40) * 2).astype(np.float32)
    labels = rng.randint(0, 40, (2, 8)).astype(np.int32)
    labels[0, 2] = -1
    jl = jnp.asarray(clogits)
    tl = torch.from_numpy(clogits)
    if dtype == "bfloat16":
        jl, tl = jl.astype(jnp.bfloat16), tl.to(torch.bfloat16)
    nll = tcmte.lm_token_nll(tl[0], torch.from_numpy(labels))
    assert nll.dtype == torch.float32
    np.testing.assert_allclose(nll.numpy(), np.asarray(
        jcmte.lm_token_nll(jl[0], jnp.asarray(labels))), **MEAN)
    mean, std = tcmte.lm_committee_uncertainty(tl, torch.from_numpy(labels))
    jmean, jstd = jcmte.lm_committee_uncertainty(jl, jnp.asarray(labels))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), **MEAN)
    np.testing.assert_allclose(std.numpy(), np.asarray(jstd), **STD)


# ---------------------------------------------------------------------------
# the lm_active_distill twin
# ---------------------------------------------------------------------------


def test_distill_configuration_is_the_references(ref):
    """The same model configs, run config, rules and stop as the
    reference's example."""
    assert tdistill.SEQ == ref.SEQ and tdistill.VOCAB == ref.VOCAB
    for name in ("STUDENT", "TEACHER"):
        t, j = getattr(tdistill, name), getattr(ref, name)
        assert {f: getattr(t, f) for f in t.__dataclass_fields__} == \
            {f: getattr(j, f) for f in j.__dataclass_fields__}
    cfg = tdistill.run_config("x")
    for f in ("gene_process", "orcl_process", "pred_process", "ml_process",
              "retrain_size", "std_threshold", "patience",
              "weight_sync_every", "train_steps", "train_batch", "train_lr",
              "train_replay_capacity"):
        assert getattr(cfg, f) == {
            "gene_process": 8, "orcl_process": 2, "pred_process": 3,
            "ml_process": 3, "retrain_size": 24, "std_threshold": 0.08,
            "patience": 1000, "weight_sync_every": 1, "train_steps": 30,
            "train_batch": 16, "train_lr": 1e-3,
            "train_replay_capacity": 512}[f], f
    r = tdistill.rules(cfg)
    assert [type(x).__name__ for x in r] == ["ThresholdRule",
                                             "TopFractionRule"]
    assert r[0].threshold == 0.08 and r[1].fraction == 0.5
    assert tdistill.TARGET_LABELS == 120
    assert tdistill._STUDENT_MODEL.impl == "plain"
    # the prompts are the reference's, generator for generator
    for rank in (0, 3):
        tg, jg = tdistill.PromptGene(rank, ""), ref.PromptGene(rank, "")
        for _ in range(3):
            np.testing.assert_array_equal(tg.generate_new_data(None)[1],
                                          jg.generate_new_data(None)[1])


def _student_pair(ref, K=3):
    """The reference's student committee (members from PRNGKey(i)) and the
    same weights on the port."""
    spec = ref.make_student_committee(K)
    return spec, tdistill.make_student_committee(
        K, params_from_numpy(spec.cparams, "cpu"))


def _prompts(ref, n):
    gens = [ref.PromptGene(r, "") for r in range(n)]
    return [g.generate_new_data(None)[1] for g in gens]


@pytest.mark.parametrize("n", [5, 8, 13])
def test_student_member_nll_scored_by_both_fused_engines(ref, n):
    """The student committee's ``member_nll`` behind the fused engine, with
    the example's threshold + top-fraction pipeline: the port's CPU
    ``FusedEngine`` against the reference's on the same weights and
    prompts (mean NLL, both stds, the selection mask)."""
    jspec, tspec = _student_pair(ref)
    cfg = tdistill.run_config("x")
    thr = cfg.std_threshold
    jeng = jacq.FusedEngine(jspec.apply_fn, jspec.cparams, thr,
                            rules=(jacq.ThresholdRule(thr),
                                   jacq.TopFractionRule(0.5)))
    teng = tacq.FusedEngine(tspec.apply_fn, tspec.cparams, thr,
                            rules=tdistill.rules(cfg), device="cpu")
    rows = _prompts(ref, n)
    want, got = jeng.score(rows), teng.score(rows)
    np.testing.assert_allclose(got.mean, want.mean, **MEAN)
    np.testing.assert_allclose(got.scalar_std, want.scalar_std, **STD)
    np.testing.assert_allclose(got.component_std, want.component_std, **STD)
    assert got.mask.shape == want.mask.shape == (n,)
    away = np.abs(want.scalar_std - thr) > STD["atol"] + STD["rtol"] * thr
    np.testing.assert_array_equal(got.mask[away], want.mask[away])
    assert 0 < got.mask.sum() <= -(-n // 2)
    # the NLL itself: lm_token_nll of the member forward, member by member
    x = torch.from_numpy(np.stack(rows))
    for i in range(3):
        p = tcmte.member(tspec.cparams, i)
        np.testing.assert_allclose(
            tdistill.member_nll(p, x).numpy(),
            np.asarray(ref.make_student_committee(3).apply_fn(
                jax.tree.map(lambda a: a[i], jspec.cparams),
                jnp.asarray(np.stack(rows)))), **MEAN)


def test_student_loss_gradients_match_jax_grad(ref):
    """``student_loss`` and its gradient (torch.func.grad) against
    ``jax.grad`` of the reference's, on one member and a batch of
    teacher-labelled sequences, some ignored (-1 labels are not made by
    the teacher; the loss's own rule is held by test_torch_lm_zoo)."""
    jspec, tspec = _student_pair(ref, K=1)
    jp = jax.tree.map(lambda a: a[0], jspec.cparams)
    tp = tcmte.member(tspec.cparams, 0)
    rng = np.random.RandomState(4)
    y = rng.randint(0, tdistill.VOCAB, (6, tdistill.SEQ + 1)).astype(
        np.float32)
    jl, jg = jax.value_and_grad(lambda p: ref.student_loss(
        p, {"y": jnp.asarray(y)})[0])(jp)
    tl, tg = torch.func.grad_and_value(lambda p: tdistill.student_loss(
        p, {"y": torch.from_numpy(y)})[0])(tp)[::-1]
    np.testing.assert_allclose(float(tl), float(jl), **MEAN)
    jleaves = jax.tree_util.tree_leaves(jg)
    tleaves = tree_leaves(tg)
    assert len(jleaves) == len(tleaves)
    for t, j in zip(tleaves, jleaves):
        j = np.asarray(j)
        assert np.abs(j).max() > 0
        np.testing.assert_allclose(_t(t), j, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(j).max())


def test_teacher_relabel_matches_reference(ref):
    """The reference's TeacherOracle (its PRNGKey(42) weights) and the
    port's on those weights: the labelled sequence (prompt head + the
    teacher's greedy continuation) on prompts from the generators."""
    jor = ref.TeacherOracle(0, "")
    tor = tdistill.TeacherOracle(0, "", device="cpu",
                                 params=params_from_numpy(jor.params, "cpu"))
    for inp in _prompts(ref, 6):
        x_j, y_j = jor.run_calc(inp)
        x_t, y_t = tor.run_calc(inp)
        np.testing.assert_array_equal(x_t, x_j)
        assert y_t.dtype == np.float32 and y_t.shape == (tdistill.SEQ + 1,)
        # the teacher's own logits decide where a tie could flip a token
        logits = jor.model.forward(jor.params, {"tokens": jnp.asarray(
            inp.astype(np.int32))[None]})[0]
        top2 = np.sort(np.asarray(logits), axis=-1)[:, -2:]
        sure = np.concatenate([[True], (top2[:, 1] - top2[:, 0]) > 1e-4])
        np.testing.assert_array_equal(y_t[sure], y_j[sure])


def test_lm_active_distill_runs_on_the_cpu(capsys):
    """The twin's ``main`` on the CPU: labels, retrains and hands weights
    to the engine device to device, with no crash or unjoined thread."""
    rep = tdistill.main(["--device", "cpu", "--timeout", "30"])
    out = capsys.readouterr().out
    assert out.strip().endswith("OK")
    assert rep["labeled_total"] > 0
    c = rep["counters"]
    assert c.get("runtime.thread_crashes", 0) == 0
    assert c.get("runtime.unjoined_threads", 0) == 0
    assert rep["train_fused_steps"] > 0 and rep["device_weight_refreshes"] > 0


def test_distill_pal_engine_holds_the_trainers_weights_after_the_run():
    """A short run through ``make_pal`` / ``run_until``: it stops on its
    label target, the engine's weights equal the trainer's snapshot bit for
    bit, and every bucket ran its program once per build (the CPU engine
    runs eagerly)."""
    with tempfile.TemporaryDirectory() as tmp:
        pal = tdistill.make_pal(tmp, "cpu")
        stopped_by, wall = tdistill.run_until(pal, timeout=30.0, target=24)
        assert stopped_by == "labels" and wall < 30.0
        snap = pal.committee_trainer.snapshot_cparams()
        for a, b in zip(tree_leaves(pal.engine.cparams), tree_leaves(snap)):
            assert torch.equal(a, b)
        assert all(v == 1 for v in pal.engine.trace_counts.values())
