"""The capturable bucket program of ``repro_torch`` ``FusedEngine``, on the
CPU: the program the card captures as one CUDA graph per shape bucket, run
eagerly with ``n_valid`` and ``stream`` as 0-d tensors.

* against the reference's unsharded ``FusedEngine(impl="xla")`` on the same
  weights over drifting rounds, for the default, budget, budget +
  re-weight, top-fraction and diversity pipelines (tolerances of
  tests/test_torch_acquisition.py: mean and stds rtol 1e-4 atol 1e-5,
  masks and finite counts exact, carried state rtol 1e-5 atol 1e-7);
* no host synchronisation: the program runs with ``Tensor.item``,
  ``__int__``, ``__float__``, ``__bool__``, ``__index__``, ``.cpu``,
  ``.numpy`` and ``.tolist`` patched to raise;
* the ``TopFractionRule`` k table against the reference's rule for every
  m <= the bucket (45 * 0.7 -> 31);
* the plain fused ``committee_uq`` entry: its packed bytes are the five
  outputs in the order the engine's download unpacks them, and they hold
  against the Pallas kernel in interpret mode (the reference's tolerances:
  mean rtol 1e-5 atol 1e-6, stds rtol 1e-4 atol 1e-6) with ``n_valid`` < n
  and non-finite members;
* the default pipeline's kernel mask == ``ThresholdRule`` & valid &
  finite > 0, bit for bit, negative thresholds included;
* ``refresh_from_device``, assigning ``cparams`` and ``load_state_dict``
  write into the engine's buffers (the same ``data_ptr``) and change the
  answers.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import acquisition as jacq
from repro.core import budget as jbud
from repro.kernels import ops as jops
from repro_torch.configs.pal_potential import PotentialConfig
from repro_torch.core import acquisition as tacq
from repro_torch.core import budget as tbud
from repro_torch.core import committee as tcmte
from repro_torch.kernels import ops, ref
from repro_torch.models import potential as tpot

K, IN_DIM, OUT_DIM = 5, 6, 3
TOL = dict(rtol=1e-4, atol=1e-5)
STATE_TOL = dict(rtol=1e-5, atol=1e-7)
MEAN_TOL = dict(rtol=1e-5, atol=1e-6)
STD_TOL = dict(rtol=1e-4, atol=1e-6)


def _weights(seed=0):
    rng = np.random.RandomState(seed)
    return np.stack([rng.randn(IN_DIM, OUT_DIM).astype(np.float32) * 0.5
                     for _ in range(K)])


def _apply(p, x):
    return x @ p["w"]


PIPELINES = {
    "default": lambda m: None,
    "budget": lambda m: (m.BudgetRule(target=0.2, thr_init=0.4, horizon=8,
                                      target_serve=0.45),),
    "budget_reweight": lambda m: (
        m.RollingReweightRule(n_buckets=16, decay=0.8, boost=1.0),
        m.BudgetRule(target=0.25, thr_init=0.4, horizon=8)),
    "top_fraction": lambda m: (m.TopFractionRule(0.3),),
    "diversity": lambda m: (m.ThresholdRule(0.2), m.DiversityRule(0.8)),
}


class _JaxRules:
    TopFractionRule, ThresholdRule = jacq.TopFractionRule, jacq.ThresholdRule
    DiversityRule = jacq.DiversityRule
    BudgetRule, RollingReweightRule = jbud.BudgetRule, jbud.RollingReweightRule


class _TorchRules:
    TopFractionRule, ThresholdRule = tacq.TopFractionRule, tacq.ThresholdRule
    DiversityRule = tacq.DiversityRule
    BudgetRule, RollingReweightRule = tbud.BudgetRule, tbud.RollingReweightRule


def _engine(ws, threshold, rules, **kw):
    return tacq.FusedEngine(_apply, tcmte.params_from_numpy({"w": ws}, "cpu"),
                            threshold, rules=rules, device="cpu", **kw)


def _run(eng, x, n, stream, state):
    """The bucket program on a padded batch, the run-time scalars as 0-d
    int32 tensors; returns the unpacked outputs and the new state."""
    packed, new_state = eng.program(
        eng.cparams, torch.from_numpy(x), torch.tensor(n, dtype=torch.int32),
        torch.tensor(stream, dtype=torch.int32), state)
    nb = x.shape[0]
    d = (packed.numel() - nb) // (4 * nb) - 3
    return ref.packed_uq_views(packed.numpy(), nb, d), new_state


def _drift_rounds(n_rounds, sizes, seed):
    rng = np.random.RandomState(seed)
    out = []
    for r in range(n_rounds):
        s = 0.5 + 1.5 * r / max(n_rounds - 1, 1)
        out.append((rng.randn(sizes[r % len(sizes)], IN_DIM) * s)
                   .astype(np.float32))
    return out


@pytest.mark.parametrize("pipeline", sorted(PIPELINES))
def test_bucket_program_matches_reference_over_drifting_rounds(pipeline):
    ws = _weights(seed=2)
    make = PIPELINES[pipeline]
    jeng = jacq.FusedEngine(_apply, {"w": jnp.asarray(ws)}, 0.4,
                            rules=make(_JaxRules), impl="xla")
    teng = _engine(ws, 0.4, make(_TorchRules))
    state = teng.rule_state
    picked = rows = 0
    for r, batch in enumerate(_drift_rounds(16, (16, 11, 13, 9), seed=5)):
        stream = tacq.STREAM_SERVE if r % 3 == 2 else tacq.STREAM_EXCHANGE
        advance = r % 5 != 4
        want = jeng.score(list(batch), stream=stream, advance=advance)
        x, n, nb = teng._pad_batch(batch)
        (mean, sstd, cstd, finite, mask), new_state = _run(
            teng, x, n, stream, state)
        if advance:
            state = new_state
        where = f"{pipeline} round {r}"
        np.testing.assert_allclose(mean[:n], want.mean, err_msg=where, **TOL)
        np.testing.assert_allclose(sstd[:n], want.scalar_std, err_msg=where,
                                   **TOL)
        np.testing.assert_allclose(cstd[:n], want.component_std,
                                   err_msg=where, **TOL)
        np.testing.assert_array_equal(mask[:n], want.mask, err_msg=where)
        np.testing.assert_array_equal(finite[:n], want.finite_members,
                                      err_msg=where)
        assert not mask[n:].any(), where
        for ts, js in zip(state, jeng.state_dict()):
            for key in js:
                np.testing.assert_allclose(np.asarray(ts[key]), js[key],
                                           err_msg=f"{where} {key}",
                                           **STATE_TOL)
        picked, rows = picked + int(mask.sum()), rows + n
    assert 0 < picked < rows                  # the rules really decided


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


def _potential_apply(cfg):
    def apply(p, flat_batch):
        def one(flat):
            _, f = tpot.energy_forces(p, flat.reshape(cfg.n_atoms, 3), cfg)
            return f.reshape(-1)
        return torch.func.vmap(one)(flat_batch)
    return apply


ALL_RULES = {**PIPELINES, "everything": lambda m: (
    m.RollingReweightRule(n_buckets=16),
    m.BudgetRule(target=0.3, thr_init=0.4, target_serve=0.5),
    m.TopFractionRule(0.5), m.DiversityRule(0.3))}


@pytest.mark.parametrize("pipeline", sorted(ALL_RULES))
def test_bucket_program_makes_no_host_sync(monkeypatch, pipeline):
    """The serving path's own committee (forces by torch.func.grad under
    vmap) and every rule: nothing in the program reads a tensor's value on
    the host, so the card can capture it and replay it with new n_valid
    and stream values."""
    cfg = PotentialConfig(n_atoms=4, committee_size=3, hidden=(16, 16),
                          n_rbf=8)
    cparams = tpot.init_committee(cfg, torch.Generator().manual_seed(1),
                                  device="cpu")
    eng = tacq.FusedEngine(_potential_apply(cfg), cparams, 0.4,
                           rules=ALL_RULES[pipeline](_TorchRules),
                           device="cpu")
    x = (np.random.RandomState(0).randn(16, 12) * 0.5).astype(np.float32)
    with _no_host_reads(monkeypatch):
        with pytest.raises(AssertionError, match="host read"):
            torch.ones(()).item()
        for n, stream in ((11, tacq.STREAM_EXCHANGE), (16, tacq.STREAM_SERVE)):
            packed, state = eng.program(
                eng.cparams, torch.from_numpy(x),
                torch.tensor(n, dtype=torch.int32),
                torch.tensor(stream, dtype=torch.int32), eng.rule_state)
    _, sstd, _, finite, mask = ref.packed_uq_views(packed.numpy(), 16, 12)
    assert (finite == 3).all() and np.isfinite(sstd).all()


@pytest.mark.parametrize("fraction", [0.0, 0.1, 0.25, 1 / 3, 0.5, 0.7, 1.0])
def test_k_table_equals_reference(fraction):
    """The port's table against the reference's rule, traced once with
    n_valid as a device scalar, for every m <= the 64-row bucket."""
    nb = 64
    table = tacq.k_table(nb, fraction, torch.device("cpu")).numpy()
    assert table.dtype == np.int32 and table.shape == (nb + 1,)
    rule = jacq.TopFractionRule(fraction)
    std = jnp.asarray(np.random.RandomState(0).permutation(nb) + 1.0,
                      jnp.float32)

    @jax.jit
    def selected(n_valid):
        valid = jnp.arange(nb) < n_valid
        stats = jacq.UQStats(x=None, mean=None, scalar_std=std,
                             component_std=std, valid=valid, n_valid=n_valid)
        return jnp.sum(rule.apply(stats, valid))

    want = [int(selected(jnp.int32(m))) for m in range(nb + 1)]
    np.testing.assert_array_equal(table, want)
    np.testing.assert_array_equal(
        table, [int(round(m * fraction)) for m in range(nb + 1)])
    if fraction == 0.7:
        assert table[45] == 31                 # fp32 would give 32
    # the rule indexes the table with a clipped device n_valid
    eng = _engine(_weights(6), 0.0, (tacq.TopFractionRule(fraction),),
                  min_bucket=64)
    x = np.random.RandomState(7).randn(45, IN_DIM).astype(np.float32)
    assert eng.score(x).mask.sum() == table[45]


def _poisoned(K_, n, d, seed):
    p = np.random.RandomState(seed).randn(K_, n, d).astype(np.float32)
    p[:, 2] = np.nan                          # no finite member
    if K_ > 1:
        p[0, 3, d - 1] = np.inf               # one member quarantined
        p[1:, 4] = -np.inf                    # one finite member
    return p


@pytest.mark.parametrize("K_,n,d", [(4, 64, 24), (3, 13, 5), (2, 8, 1)])
def test_plain_fused_entry_layout_and_pallas_parity(K_, n, d):
    preds = _poisoned(K_, n, d, seed=K_ + n)
    thr = 0.9
    n_valid = n - 3
    packed = ops.committee_uq_packed(torch.from_numpy(preds), thr,
                                     torch.tensor(n_valid, dtype=torch.int32))
    assert packed.dtype == torch.uint8
    assert packed.numel() == ref.packed_uq_nbytes(n, d) == n * (d + 3) * 4 + n
    # the bytes: the five outputs in the order the engine's one download
    # unpacks them (mean, scalar std, component std, finite, mask)
    mean, sstd, cstd, mask, finite = ref.committee_uq_ref(
        torch.from_numpy(preds), thr)
    mask = mask & (torch.arange(n) < n_valid)
    cat = torch.cat([p.reshape(-1).view(torch.uint8)
                     for p in (mean, sstd, cstd, finite, mask)])
    assert torch.equal(packed, cat)
    # the values: against the Pallas kernel in interpret mode
    got = ref.packed_uq_views(packed.numpy(), n, d)
    jm, js, jc, jk, jf = (np.asarray(o) for o in jops.committee_uq(
        jnp.asarray(preds), thr, impl="pallas_interpret", block_n=8))
    np.testing.assert_allclose(got[0], jm, **MEAN_TOL)
    np.testing.assert_allclose(got[1], js, **STD_TOL)
    np.testing.assert_allclose(got[2], jc, **STD_TOL)
    np.testing.assert_array_equal(got[3], jf)
    want_mask = jk & (np.arange(n) < n_valid)
    away = np.abs(js - thr) > STD_TOL["atol"] + STD_TOL["rtol"] * thr
    np.testing.assert_array_equal(got[4][away], want_mask[away])
    assert not got[4][n_valid:].any() and not got[4][2]
    # an out buffer of the right size is written and returned
    out = torch.zeros(packed.numel(), dtype=torch.uint8)
    assert ops.committee_uq_packed(torch.from_numpy(preds), thr,
                                   torch.tensor(n_valid, dtype=torch.int32),
                                   out=out) is out
    assert torch.equal(out, packed)
    with pytest.raises(ValueError, match="out must be"):
        ops.committee_uq_packed(torch.from_numpy(preds), thr,
                                torch.tensor(n_valid, dtype=torch.int32),
                                out=out[1:])


@pytest.mark.parametrize("thr", [-1.0, -0.0, 0.0, 0.3, 1.7])
def test_default_pipeline_kernel_mask_is_threshold_rule_mask(thr):
    """With a lone ThresholdRule at the engine's threshold the kernel's
    mask is the final mask: bit for bit ThresholdRule & valid & finite > 0
    (rows with no finite member and padding rows included)."""
    ws = _weights(seed=3)
    ws[1, 0, 0] = np.nan                      # member 1 poisons every row
    default = _engine(ws, thr, None)
    folded = _engine(ws, thr, (tacq.ThresholdRule(thr),
                               tacq.ThresholdRule(thr)))
    assert default._kernel_mask_final and not folded._kernel_mask_final
    x = np.random.RandomState(4).randn(16, IN_DIM).astype(np.float32)
    x[5] = np.nan                             # no finite member
    n = 13
    (mean, sstd, cstd, finite, mask), _ = _run(default, x, n, 0, ())
    (_, _, _, _, mask_f), _ = _run(folded, x, n, 0, ())
    m, s, c, _, f = ref.committee_uq_ref(
        default.apply(default.cparams, torch.from_numpy(x)), thr)
    valid = torch.arange(16) < n
    stats = tacq.UQStats(x=None, mean=m, scalar_std=s, component_std=c,
                         valid=valid, n_valid=torch.tensor(n))
    want = (tacq.ThresholdRule(thr).apply(stats, valid) & valid
            & (f > 0)).numpy()
    np.testing.assert_array_equal(mask, want)
    np.testing.assert_array_equal(mask_f, want)
    assert finite[5] == 0 and not mask[5] and not mask[n:].any()
    if thr < 0:
        assert mask[:n].sum() == n - 1        # every scored valid row
    got = default.score(x[:n]).mask
    np.testing.assert_array_equal(got, want[:n])


def test_refresh_and_restore_keep_buffers_and_change_answers():
    ws = _weights(seed=5)
    eng = _engine(ws, 0.4, (tbud.BudgetRule(target=0.3, thr_init=0.4),))
    ptrs = lambda: ([t.data_ptr() for t in eng.cparams.values()],  # noqa
                    [t.data_ptr() for s in eng.rule_state
                     for t in s.values()])
    before = ptrs()
    x = np.random.RandomState(6).randn(8, IN_DIM).astype(np.float32)
    first = eng.score(x)
    snap = eng.state_dict()
    eng.score(x)
    assert int(eng.rule_state[0]["rounds"]) == 2
    assert eng.refresh_from_device(
        tcmte.params_from_numpy({"w": ws * 2}, "cpu")) == 1
    assert eng.device_refreshes == 1 and eng.refresh_host_bytes == 0
    eng.load_state_dict(snap)
    assert int(eng.rule_state[0]["rounds"]) == 1
    again = eng.score(x, advance=False)
    np.testing.assert_allclose(again.mean, first.mean * 2, rtol=1e-6)
    np.testing.assert_allclose(again.scalar_std, first.scalar_std * 2,
                               rtol=1e-5)
    eng.cparams = tcmte.params_from_numpy({"w": ws}, "cpu")
    np.testing.assert_array_equal(eng.score(x, advance=False).mean,
                                  first.mean)
    assert ptrs() == before
    with pytest.raises(ValueError, match="keys and shapes"):
        eng.refresh_from_device({"w": torch.zeros(K, IN_DIM, 1)})
    assert eng.trace_counts == {8: 1}
