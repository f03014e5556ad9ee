"""Port parity for committee UQ: ``repro_torch.kernels`` against the JAX
reference ``repro.kernels.ops.committee_uq`` at impl='xla' and
impl='pallas_interpret', mirroring every case of tests/test_committee_uq.py
(kernel parity, ddof=1, K=1, any-component mask, member quarantine, 0/1
finite members), plus the port's engine-level UQ checks.  The CUDA
kernel's own tests are in tests/test_torch_kernels_cuda.py.

Tolerances are the reference's own: mean rtol 1e-5 atol 1e-6; both stds
rtol 1e-4 atol 1e-6; masks and finite counts exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core import acquisition as tacq
from repro_torch.core import committee as tcmte
from repro_torch.kernels import ops as tops

IMPLS = ["xla", "pallas_interpret"]
# one compiled program per case instead of op-by-op eager dispatch
_ref_uq = jax.jit(jops.committee_uq, static_argnums=(1,),
                  static_argnames=("impl",))
MEAN_TOL = dict(rtol=1e-5, atol=1e-6)
STD_TOL = dict(rtol=1e-4, atol=1e-6)


def _both(preds_np, t, impl):
    """(port outputs, reference outputs) as numpy, same inputs."""
    got = [o.numpy() for o in tops.committee_uq(torch.from_numpy(preds_np),
                                                t)]
    want = [np.asarray(o) for o in _ref_uq(jnp.asarray(preds_np), t,
                                               impl=impl)]
    return got, want


def _assert_uq_equal(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.dtype, w.dtype)
    np.testing.assert_allclose(got[0], want[0], **MEAN_TOL)
    np.testing.assert_allclose(got[1], want[1], **STD_TOL)
    np.testing.assert_allclose(got[2], want[2], **STD_TOL)
    np.testing.assert_array_equal(got[3], want[3])     # mask: exact
    np.testing.assert_array_equal(got[4], want[4])     # finite: exact


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("K,n,d", [
    (8, 64, 4), (4, 33, 8), (3, 10, 5), (2, 1, 1), (16, 128, 16),
])
def test_committee_uq_port_matches_reference(K, n, d, impl):
    preds = np.random.RandomState(0).randn(K, n, d).astype(np.float32)
    got, want = _both(preds, 0.8, impl)
    _assert_uq_equal(got, want)
    assert (got[4] == K).all()


def test_committee_uq_port_matches_numpy_ddof1():
    rng = np.random.RandomState(1)
    preds = rng.randn(6, 24, 3).astype(np.float32)
    mean, sstd, cstd, mask, _ = (o.numpy() for o in tops.committee_uq(
        torch.from_numpy(preds), 0.7))
    std64 = preds.astype(np.float64).std(axis=0, ddof=1)
    np.testing.assert_allclose(mean, preds.mean(axis=0), **MEAN_TOL)
    np.testing.assert_allclose(sstd, std64.max(axis=-1), **STD_TOL)
    np.testing.assert_allclose(cstd, std64.mean(axis=-1), **STD_TOL)
    np.testing.assert_array_equal(mask, std64.max(axis=-1) > 0.7)


@pytest.mark.parametrize("impl", IMPLS)
def test_committee_uq_port_k1_zero_std(impl):
    preds = np.random.RandomState(2).randn(1, 16, 4).astype(np.float32)
    got, want = _both(preds, 1e-9, impl)
    _assert_uq_equal(got, want)
    assert (got[4] == 1).all() and (got[1] == 0).all() and (got[2] == 0).all()
    np.testing.assert_allclose(got[0], preds[0], rtol=1e-6)   # exact copy
    assert not got[3].any()


def test_committee_uq_port_mask_equals_anycomponent_semantics():
    preds = np.random.RandomState(3).randn(5, 20, 6).astype(np.float32)
    _, _, _, mask, _ = tops.committee_uq(torch.from_numpy(preds), 0.9)
    want = (preds.std(axis=0, ddof=1) > 0.9).any(axis=-1)
    np.testing.assert_array_equal(mask.numpy(), want)


@pytest.mark.parametrize("impl", IMPLS)
def test_committee_uq_port_quarantines_nonfinite_members(impl):
    rng = np.random.RandomState(7)
    preds = rng.randn(5, 40, 3).astype(np.float32)
    bad = preds.copy()
    bad[2, :10] = np.nan            # member 2 diverged on rows 0..9
    bad[4, 10, 1] = np.inf          # member 4: one bad component on row 10
    got, want = _both(bad, 0.5, impl)
    _assert_uq_equal(got, want)
    want_f = np.full(40, 5, np.int32)
    want_f[:11] = 4
    np.testing.assert_array_equal(got[4], want_f)
    keep = preds[[0, 1, 3, 4], :10].astype(np.float64)
    np.testing.assert_allclose(got[0][:10], keep.mean(axis=0), **MEAN_TOL)
    np.testing.assert_allclose(got[1][:10],
                               keep.std(axis=0, ddof=1).max(axis=-1),
                               **STD_TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_committee_uq_port_zero_and_one_finite_member_rows(impl):
    preds = np.random.RandomState(8).randn(4, 12, 2).astype(np.float32)
    preds[:, 3] = np.nan            # row 3: no finite member at all
    preds[1:, 5] = np.nan           # row 5: exactly one finite member
    got, want = _both(preds, 0.0, impl)
    _assert_uq_equal(got, want)
    m, s, _, k, f = got
    assert f[3] == 0 and f[5] == 1 and s[3] == 0 and s[5] == 0
    assert not k[3] and np.isfinite(m).all()
    np.testing.assert_allclose(m[5], preds[0, 5], rtol=1e-6)


def test_committee_uq_output_dtypes_and_empty_rows():
    """The reference's 5-tuple dtypes, including n = 0."""
    for n in (0, 3):
        out = tops.committee_uq(torch.zeros(2, n, 4), 0.1)
        assert [o.dtype for o in out] == [torch.float32, torch.float32,
                                          torch.float32, torch.bool,
                                          torch.int32]
        assert out[0].shape == (n, 4) and out[4].shape == (n,)


# ---------------------------------------------------------------------------
# engine-level UQ (port engine on the CPU vs the reference's numbers)
# ---------------------------------------------------------------------------


def _linear_committee(seed=0, k=4, in_dim=6, out_dim=3):
    rng = np.random.RandomState(seed)
    ws = np.stack([rng.randn(in_dim, out_dim).astype(np.float32) * 0.5
                   for _ in range(k)])
    return ws, tcmte.params_from_numpy({"w": ws}, "cpu")


def _apply(p, x):
    return x @ p["w"]


def test_port_engine_matches_reference_uq():
    ws, cparams = _linear_committee()
    eng = tacq.FusedEngine(_apply, cparams, 0.3, device="cpu")
    inputs = [r.astype(np.float32)
              for r in np.random.RandomState(4).randn(7, 6)]
    uq = eng.score(inputs)
    preds = np.stack([np.stack(inputs) @ w for w in ws])
    std = preds.std(axis=0, ddof=1)
    # engine results: rtol 1e-4, atol 1e-5 (the reference test's tolerance)
    np.testing.assert_allclose(uq.mean, preds.mean(axis=0), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(uq.scalar_std, std.max(axis=-1), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(uq.component_std, std.mean(axis=-1),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(uq.mask, std.max(axis=-1) > 0.3)


def test_port_engine_bucket_cache_and_quarantine_single_program():
    """One program per bucket; a poisoned member changes the finite count
    and the quarantine counters, never the program cache."""
    _, cparams = _linear_committee()
    eng = tacq.FusedEngine(_apply, cparams, 0.3, device="cpu")
    rng = np.random.RandomState(0)
    gen = lambda n: [rng.randn(6).astype(np.float32) for _ in range(n)]
    for n in (5, 8, 3, 7, 8, 1):
        uq = eng.score(gen(n))
        assert uq.mean.shape == (n, 3) and uq.scalar_std.shape == (n,)
    assert eng.trace_counts == {8: 1}
    eng.score(gen(20))
    eng.score(gen(9))
    assert eng.trace_counts == {8: 1, 32: 1, 16: 1}
    assert eng.last_finite_min == 4 and eng.quarantine_rounds == 0
    eng.cparams = {"w": eng.cparams["w"].clone()}
    eng.cparams["w"][1] = float("nan")
    uq = eng.score(gen(8))
    assert (uq.finite_members == 3).all() and np.isfinite(uq.mean).all()
    assert eng.last_finite_min == 3 and eng.quarantine_rounds == 1
    assert eng.trace_counts == {8: 1, 32: 1, 16: 1}
    assert eng.dispatches == 9


def test_shape_bucket_and_weight_packing_match_reference():
    from repro.core import committee as jcmte

    for n, m in ((1, 8), (8, 8), (9, 8), (100, 8), (3, 2)):
        assert tcmte.shape_bucket(n, m) == jcmte.shape_bucket(n, m)
    rng = np.random.RandomState(5)
    tree = {"b": rng.randn(4).astype(np.float32),
            "a": rng.randn(2, 3).astype(np.float32)}
    want = jcmte.get_weight({k: jnp.asarray(v) for k, v in tree.items()})
    ttree = tcmte.params_from_numpy(tree, "cpu")
    buf = np.zeros(tcmte.get_weight_size(ttree), np.float32)
    got = tcmte.get_weight(ttree, out=buf)
    assert got is buf
    np.testing.assert_array_equal(got, want)        # same wire format
    back = tcmte.update(ttree, got * 2)
    np.testing.assert_array_equal(back["a"].numpy(), tree["a"] * 2)
    with pytest.raises(ValueError):
        tcmte.get_weight(ttree, out=np.zeros(3, np.float32))
