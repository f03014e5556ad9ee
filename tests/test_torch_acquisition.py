"""Port parity for the acquisition engine: ``repro_torch`` ``FusedEngine``
(on the CPU, where ``committee_uq`` runs its plain PyTorch version) against
the reference's unsharded ``FusedEngine(impl="xla")`` on the same weights
and inputs, over 20 drifting rounds for each rule pipeline, with the
``BudgetRule`` / ``RollingReweightRule`` state compared after every round
(mirrors tests/test_budget.py and tests/test_acquisition.py).

Tolerances: mean and stds rtol 1e-4, atol 1e-5; masks exact; carried rule
state — ``rounds`` exact, float leaves rtol 1e-5, atol 1e-7 (fp32 exp and
matmul orders differ by an ulp between the frameworks)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.pal_potential import PALRunConfig as JRunConfig
from repro.core import acquisition as jacq
from repro.core import budget as jbud
from repro.core import selection as jsel
from repro_torch.configs.pal_potential import PALRunConfig, PotentialConfig
from repro_torch.core import acquisition as tacq
from repro_torch.core import budget as tbud
from repro_torch.core import committee as tcmte
from repro_torch.core.weight_sync import WeightStore
from repro_torch.models import potential as tpot

K, IN_DIM, OUT_DIM = 5, 6, 3
TOL = dict(rtol=1e-4, atol=1e-5)
STATE_TOL = dict(rtol=1e-5, atol=1e-7)


def _weights(seed=0):
    rng = np.random.RandomState(seed)
    return np.stack([rng.randn(IN_DIM, OUT_DIM).astype(np.float32) * 0.5
                     for _ in range(K)])


def _apply_t(p, x):
    return x @ p["w"]


def _apply_j(p, x):
    return x @ p["w"]


def _pair(ws, threshold, jrules, trules, **kw):
    jeng = jacq.FusedEngine(_apply_j, {"w": jnp.asarray(ws)}, threshold,
                            rules=jrules, impl="xla", **kw)
    teng = tacq.FusedEngine(_apply_t, tcmte.params_from_numpy({"w": ws},
                                                              "cpu"),
                            threshold, rules=trules, device="cpu", **kw)
    return jeng, teng


def _drift_rounds(n_rounds, sizes, seed=1, scale0=0.5, scale1=2.0):
    """Input batches whose committee disagreement drifts 4x over the run
    (the linear committee's std scales with |x|); sizes cycle inside one
    shape bucket so the padding changes round to round."""
    rng = np.random.RandomState(seed)
    out = []
    for r in range(n_rounds):
        s = scale0 + (scale1 - scale0) * r / max(n_rounds - 1, 1)
        n = sizes[r % len(sizes)]
        out.append([(rng.randn(IN_DIM) * s).astype(np.float32)
                    for _ in range(n)])
    return out


def _assert_state_equal(tstate, jstate, where):
    assert len(tstate) == len(jstate), where
    for ts, js in zip(tstate, jstate):
        assert sorted(ts) == sorted(js), where
        for key in js:
            t, j = np.asarray(ts[key]), np.asarray(js[key])
            assert t.shape == j.shape and t.dtype == j.dtype, (where, key)
            if key == "rounds":
                assert int(t) == int(j), where
            else:
                np.testing.assert_allclose(t, j, err_msg=f"{where} {key}",
                                           **STATE_TOL)


PIPELINES = {
    "threshold": lambda m: None,
    "top_fraction": lambda m: (m.TopFractionRule(0.3),),
    "diversity": lambda m: (m.ThresholdRule(0.2), m.DiversityRule(0.8)),
    "budget": lambda m: (m.BudgetRule(target=0.3, thr_init=0.4, horizon=8),),
    "budget_per_stream": lambda m: (m.BudgetRule(
        target=0.2, thr_init=0.4, horizon=8, target_serve=0.45),),
    "reweight_threshold": lambda m: (
        m.RollingReweightRule(n_buckets=16, decay=0.8, boost=1.0),
        m.ThresholdRule(0.4)),
    "reweight_budget": lambda m: (
        m.RollingReweightRule(n_buckets=16, decay=0.8, boost=1.0),
        m.BudgetRule(target=0.25, thr_init=0.4, horizon=8)),
}


class _JaxRules:
    TopFractionRule, ThresholdRule = jacq.TopFractionRule, jacq.ThresholdRule
    DiversityRule = jacq.DiversityRule
    BudgetRule, RollingReweightRule = jbud.BudgetRule, jbud.RollingReweightRule


class _TorchRules:
    TopFractionRule, ThresholdRule = tacq.TopFractionRule, tacq.ThresholdRule
    DiversityRule = tacq.DiversityRule
    BudgetRule, RollingReweightRule = tbud.BudgetRule, tbud.RollingReweightRule


@pytest.mark.parametrize("pipeline", sorted(PIPELINES))
def test_score_matches_reference_over_drifting_rounds(pipeline):
    ws = _weights(seed=2)
    make = PIPELINES[pipeline]
    jeng, teng = _pair(ws, 0.4, make(_JaxRules), make(_TorchRules))
    picked = rows = 0
    for r, batch in enumerate(_drift_rounds(20, (16, 11, 13, 9), seed=5)):
        stream = tacq.STREAM_SERVE if r % 3 == 2 else tacq.STREAM_EXCHANGE
        want = jeng.score(batch, stream=stream)
        got = teng.score(batch, stream=stream)
        where = f"{pipeline} round {r}"
        np.testing.assert_allclose(got.mean, want.mean, err_msg=where, **TOL)
        np.testing.assert_allclose(got.scalar_std, want.scalar_std,
                                   err_msg=where, **TOL)
        np.testing.assert_allclose(got.component_std, want.component_std,
                                   err_msg=where, **TOL)
        np.testing.assert_array_equal(got.mask, want.mask, err_msg=where)
        np.testing.assert_array_equal(got.finite_members,
                                      want.finite_members, err_msg=where)
        _assert_state_equal(teng.state_dict(), jeng.state_dict(), where)
        picked, rows = picked + int(got.mask.sum()), rows + len(batch)
    assert 0 < picked < rows                  # the rules really decided
    assert teng.trace_counts == jeng.trace_counts == {16: 1}
    assert teng.bytes_to_device == jeng.bytes_to_device
    assert teng.bytes_to_host == jeng.bytes_to_host


@pytest.mark.parametrize("fraction", [0.0, 0.1, 0.25, 0.5, 0.7, 1.0])
def test_top_fraction_rule_matches_host(fraction):
    """Exact k = round(n * fraction) in float64, including 45 * 0.7
    (fp32 would round 31.5 up to 32; the host rounds 31.4999... to 31)."""
    ws = _weights(seed=6)
    eng = tacq.FusedEngine(_apply_t, tcmte.params_from_numpy({"w": ws},
                                                             "cpu"),
                           0.0, rules=(tacq.TopFractionRule(fraction),),
                           device="cpu")
    inputs = [r.astype(np.float32)
              for r in np.random.RandomState(7).randn(45, IN_DIM)]
    uq = eng.score(inputs)
    want = np.zeros(len(inputs), bool)
    want[jsel.top_fraction(uq.scalar_std, fraction)] = True
    np.testing.assert_array_equal(uq.mask, want)
    assert uq.mask.sum() == int(round(45 * fraction))


def test_top_fraction_rule_invariant_to_bucket_padding():
    eng = tacq.FusedEngine(_apply_t, tcmte.params_from_numpy(
        {"w": _weights(8)}, "cpu"), 0.0,
        rules=(tacq.TopFractionRule(0.5),), min_bucket=32, device="cpu")
    mask = eng.score([r.astype(np.float32) for r in
                      np.random.RandomState(9).randn(6, IN_DIM)]).mask
    assert mask.shape == (6,) and mask.sum() == 3


def test_budget_rate_uses_true_n_and_single_program_per_bucket():
    """An all-uncertain round of n=8 in a 32-wide bucket is rate 1.0 (the
    threshold must rise), and varying n reuses one program per bucket."""
    eng = tacq.FusedEngine(
        _apply_t, tcmte.params_from_numpy({"w": _weights(9)}, "cpu"), 1e-6,
        rules=(tbud.RollingReweightRule(n_buckets=8),
               tbud.BudgetRule(target=0.5, thr_init=1e-3, horizon=4)),
        min_bucket=32, device="cpu")
    rng = np.random.RandomState(10)
    uq = eng.score([(rng.randn(IN_DIM) * 5).astype(np.float32)
                    for _ in range(8)])
    assert uq.mask.all()
    st = eng.rule_state[1]
    assert float(st["threshold"]) > 1e-3
    assert float(st["ema_rate"]) == pytest.approx(0.5 + (1.0 - 0.5) / 4)
    for n in (5, 30, 3, 17):
        eng.score([rng.randn(IN_DIM).astype(np.float32) for _ in range(n)])
    assert eng.trace_counts == {32: 1}
    assert int(eng.rule_state[1]["rounds"]) == 5


def test_advance_false_is_read_only_and_state_dict_round_trips(caplog):
    rules = (tbud.BudgetRule(target=0.3, thr_init=0.4, horizon=8),)
    eng = tacq.FusedEngine(_apply_t, tcmte.params_from_numpy(
        {"w": _weights(3)}, "cpu"), 0.4, rules=rules, device="cpu")
    batches = _drift_rounds(4, (8,), seed=11)
    eng.score(batches[0])
    before = eng.state_dict()
    eng.score(batches[1], advance=False)
    _assert_state_equal(eng.state_dict(), before, "advance=False")
    eng.score(batches[2])
    snap = eng.state_dict()
    fresh = tacq.FusedEngine(_apply_t, eng.cparams, 0.4, rules=rules,
                             device="cpu")
    fresh.load_state_dict(snap)
    _assert_state_equal(fresh.state_dict(), snap, "restore")
    assert int(fresh.rule_state[0]["rounds"]) == 2
    # a snapshot of another pipeline is skipped with a warning
    other = tacq.FusedEngine(_apply_t, eng.cparams, 0.4, rules=(
        tbud.RollingReweightRule(n_buckets=4),), device="cpu")
    other.load_state_dict(snap)
    assert "does not match" in caplog.text
    assert sorted(other.rule_state[0]) == ["scores"]


@pytest.mark.parametrize("knobs", [
    dict(),
    dict(oracle_budget=0.2),
    dict(oracle_budget=0.2, reweight_buckets=64),
    dict(reweight_buckets=32, reweight_decay=0.7),
    dict(oracle_budget_exchange=0.1, oracle_budget_serve=0.4),
])
def test_rules_from_config_matches_reference(knobs):
    want = jbud.rules_from_config(JRunConfig(std_threshold=0.3, **knobs))
    got = tbud.rules_from_config(PALRunConfig(std_threshold=0.3, **knobs))
    if want is None:
        assert got is None
        return
    assert [type(r).__name__ for r in got] == \
        [type(r).__name__ for r in want]
    for g, w in zip(got, want):
        assert dataclasses.asdict(g) == dataclasses.asdict(w)


def _member_forces(cfg):
    def apply(p, flat_batch):
        def one(flat):
            _, f = tpot.energy_forces(p, flat.reshape(cfg.n_atoms, 3), cfg)
            return f.reshape(-1)
        return torch.func.vmap(one)(flat_batch)
    return apply


def test_potential_engine_matches_reference_and_ignores_grad_mode():
    """The serving path's own committee (forces of an MLP potential by
    autograd) through make_engine with the budget + re-weighting pipeline,
    against the reference engine on the same weights; then the same scores
    inside torch.no_grad() and torch.inference_mode()."""
    import jax

    from repro.configs.pal_potential import PotentialConfig as JPCfg
    from repro.models import potential as jpot

    small = dict(n_atoms=4, committee_size=3, hidden=(16, 16), n_rbf=8)
    jcfg, tcfg = JPCfg(**small), PotentialConfig(**small)
    jparams = jpot.init_committee(jcfg, jax.random.PRNGKey(0))

    def japply(p, flat_batch):
        def one(flat):
            _, f = jpot.energy_forces(p, flat.reshape(jcfg.n_atoms, 3), jcfg)
            return f.reshape(-1)
        return jax.vmap(one)(flat_batch)

    knobs = dict(std_threshold=0.5, oracle_budget=0.3, reweight_buckets=16)
    jeng = jacq.make_engine(JRunConfig(**knobs), committee=jacq.CommitteeSpec(
        japply, jparams))
    teng = tacq.make_engine(PALRunConfig(**knobs), committee=tacq.CommitteeSpec(
        _member_forces(tcfg), tcmte.params_from_numpy(jparams, "cpu")),
        device="cpu")
    rng = np.random.RandomState(3)
    lattice = np.stack(np.meshgrid([0, 1.3], [0, 1.3], [0, 1.3]),
                       -1).reshape(-1, 3)[:4].reshape(-1)
    batches = [[(lattice + rng.randn(12) * 0.1).astype(np.float32)
                for _ in range(10)] for _ in range(3)]
    for r, batch in enumerate(batches):
        want, got = jeng.score(batch), teng.score(batch)
        np.testing.assert_allclose(got.mean, want.mean, **TOL)
        np.testing.assert_allclose(got.scalar_std, want.scalar_std, **TOL)
        np.testing.assert_array_equal(got.mask, want.mask)
        _assert_state_equal(teng.state_dict(), jeng.state_dict(), f"r{r}")
    base = teng.score(batches[0], advance=False)
    for ctx in (torch.no_grad(), torch.inference_mode()):
        with ctx:
            again = teng.score(batches[0], advance=False)
        np.testing.assert_array_equal(again.mean, base.mean)
        np.testing.assert_array_equal(again.scalar_std, base.scalar_std)


def test_refresh_from_device_and_deferred_features():
    ws = _weights(4)
    eng = tacq.FusedEngine(_apply_t, tcmte.params_from_numpy({"w": ws},
                                                             "cpu"),
                           0.3, device="cpu")
    x = [np.ones(IN_DIM, np.float32)]
    before = eng.score(x).mean
    assert eng.refresh_from_device(
        tcmte.params_from_numpy({"w": ws * 2}, "cpu")) == 1
    assert eng.device_refreshes == 1 and eng.refresh_host_bytes == 0
    np.testing.assert_allclose(eng.score(x).mean, before * 2, rtol=1e-6)
    with pytest.raises(ValueError, match="committee size"):
        eng.refresh_from_device(tcmte.params_from_numpy({"w": ws[:2]},
                                                        "cpu"))
    # score_after (the exploration fleet's entry): the step's proposals
    # are scored as score() scores them, the react step is written into
    # the caller's carry in place, and score()'s program table is untouched
    carry = eng.place_carry({"x": torch.zeros(8, IN_DIM)}, 8)
    buf = carry["x"]
    traces = dict(eng.trace_counts)

    def step_fn(c):
        x = c["x"] + 1.0
        return x, dict(c, x=x)

    _, out = eng.score_after(step_fn, carry, 3, 8, cache_key="t")
    assert carry["x"] is buf and torch.equal(buf, torch.ones(8, IN_DIM))
    want = eng.score([np.ones(IN_DIM, np.float32)] * 3)
    np.testing.assert_allclose(out.mean.numpy()[:3], want.mean, rtol=1e-6)
    assert out.n_selected == int(want.mask.sum())
    assert eng.step_trace_counts == {("t", 8): 1} and eng.step_dispatches == 1
    assert eng.trace_counts == traces
    with pytest.raises(ValueError, match="never rebind"):
        eng.score_after(step_fn, {"x": buf.clone()}, 3, 8, cache_key="t")
    # refresh_from(WeightStore): K members from the store's trainers, into
    # the same buffers, version-gated
    store = WeightStore(K)
    assert eng.refresh_from(store) == 0            # nothing published
    ptr = eng.cparams["w"].data_ptr()
    for i in range(K):
        store.publish_packed(i, (ws[i] * 3).reshape(-1))
    assert eng.refresh_from(store) == 1 and eng.refresh_from(store) == 0
    assert eng.refresh_host_bytes == ws.nbytes
    assert eng.cparams["w"].data_ptr() == ptr
    np.testing.assert_allclose(eng.score(x).mean, before * 3, rtol=1e-6)
    # uq_impl="legacy": the per-member engine over predict_all
    spec = tacq.CommitteeSpec(_apply_t, eng.cparams)
    with pytest.raises(ValueError, match="predict_all"):
        tacq.make_engine(PALRunConfig(uq_impl="legacy"), committee=spec,
                         device="cpu")
    legacy = tacq.make_engine(
        PALRunConfig(uq_impl="legacy", std_threshold=0.3), committee=spec,
        predict_all=lambda rows: np.einsum("ni,kio->kno", np.stack(rows),
                                           ws * 3))
    assert isinstance(legacy, tacq.LegacyEngine)
    np.testing.assert_allclose(legacy.score(x).mean, before * 3, rtol=1e-6)
    # uq_mesh="host": the 1x1 mesh engine (the multi-device slice) scores
    # as the engine without a mesh; an unknown mesh name raises
    hosted = tacq.make_engine(PALRunConfig(uq_mesh="host", std_threshold=0.3),
                              committee=spec, device="cpu")
    assert dict(hosted.mesh.shape) == {"data": 1, "model": 1}
    np.testing.assert_array_equal(hosted.score(x).mean, eng.score(x).mean)
    with pytest.raises(ValueError, match="uq_mesh"):
        tacq.make_engine(PALRunConfig(uq_mesh="3z"), committee=spec,
                         device="cpu")
