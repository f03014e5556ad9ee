"""Port parity for the ``ssd`` plain versions and ``ops.ssd`` (its CPU
path) against the JAX package's ``repro.kernels.ref`` and the Pallas
kernel in interpret mode, on the same numpy inputs.  Mirrors
tests/test_kernels.py:184-218.  The CUDA kernel is held against the same
plain version on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py).

Tolerances: the reference's ssd atol, 5e-3 in fp32 and 1e-1 in bf16 (its
tests/test_kernels.py); the plain versions against the reference's, which
differ only in summation order, 1e-4 (fp32 outputs and states) and 1e-1
(a bf16 output, one ulp at its magnitude).  bf16 inputs are made by
rounding the same fp32 numpy arrays in both frameworks (both round to
nearest even)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd as jssd
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd as kernel

SSD_ATOL = {"float32": 5e-3, "bfloat16": 1e-1}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return x.to(torch.float32).numpy()


def _ssd_inputs(B, T, H, P, N, dtype="float32", seed=8, a_lo=0.3, a_hi=1.0,
                state=True):
    """(jax arrays, torch tensors) of x, a, Bm, Cm, state0 from numpy: x,
    B, C normal and a uniform in [a_lo, a_hi), rounded to ``dtype``; the
    state fp32."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, H, P).astype(np.float32)
    a = rng.uniform(a_lo, a_hi, (B, T, H)).astype(np.float32)
    Bm, Cm = (rng.randn(B, T, H, N).astype(np.float32) for _ in range(2))
    s0 = rng.randn(B, H, N, P).astype(np.float32) if state else None
    jd, td = DT[dtype]
    jx = [jnp.asarray(v).astype(jd) for v in (x, a, Bm, Cm)] + [
        None if s0 is None else jnp.asarray(s0)]
    tx = [torch.from_numpy(v).to(td) for v in (x, a, Bm, Cm)] + [
        None if s0 is None else torch.from_numpy(s0)]
    return jx, tx


# the reference's sweep (tests/test_kernels.py:184-187), plus Jamba's head
# shape (P = 128, N = 16, chunk 64)
SWEEP = [(1, 64, 2, 16, 8, 16), (2, 128, 4, 32, 16, 32),
         (1, 128, 2, 128, 16, 64)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,P,N,chunk", SWEEP)
def test_ssd_plain_versions_match_reference(B, T, H, P, N, chunk, dtype):
    """ref.ssd_ref / ssd_chunked_ref against the reference's, and the
    chunked form against the sequential oracle at the reference's atol."""
    jx, tx = _ssd_inputs(B, T, H, P, N, dtype)
    y_s, s_s = ref.ssd_ref(*tx)
    jy_s, js_s = jax.jit(jref.ssd_ref)(*jx)
    assert y_s.dtype == DT[dtype][1] and s_s.dtype == torch.float32
    bf_atol = 1e-4 if dtype == "float32" else 1e-1
    np.testing.assert_allclose(_t(s_s), _np(js_s), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_t(y_s), _np(jy_s), rtol=1e-4, atol=bf_atol)
    y_c, s_c = ref.ssd_chunked_ref(*tx, chunk=chunk)
    jy_c, js_c = jax.jit(jref.ssd_chunked_ref,
                         static_argnames="chunk")(*jx, chunk=chunk)
    np.testing.assert_allclose(_t(s_c), _np(js_c), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_t(y_c), _np(jy_c), rtol=1e-4, atol=bf_atol)
    atol = SSD_ATOL[dtype]
    np.testing.assert_allclose(_t(y_c), _np(jy_s), atol=atol)
    np.testing.assert_allclose(_t(s_c), _np(js_s), atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,P,N,chunk", SWEEP)
def test_ops_ssd_matches_pallas_kernel_interpret(B, T, H, P, N, chunk, dtype):
    """Mirrors test_ssd_pallas_matches_sequential: ops.ssd on the CPU
    against the Pallas kernel run in interpret mode, and both against the
    sequential oracle, at the reference's atol."""
    jx, tx = _ssd_inputs(B, T, H, P, N, dtype)
    before = kernel.launches
    y, s = ops.ssd(*tx, chunk=chunk)
    assert kernel.launches == before           # the CPU path runs no kernel
    assert y.dtype == DT[dtype][1] and tuple(y.shape) == (B, T, H, P)
    assert s.dtype == torch.float32 and tuple(s.shape) == (B, H, N, P)
    jy, js = jssd(*jx, chunk=chunk, interpret=True)
    jy_s, js_s = jax.jit(jref.ssd_ref)(*jx)
    atol = SSD_ATOL[dtype]
    np.testing.assert_allclose(_t(y), _np(jy), atol=atol)
    np.testing.assert_allclose(_t(s), _np(js), atol=atol)
    np.testing.assert_allclose(_t(y), _np(jy_s), atol=atol)
    np.testing.assert_allclose(_t(s), _np(js_s), atol=atol)


@pytest.mark.parametrize("a_lo,a_hi", [(1e-4, 2e-4), (0.999, 1.0)],
                         ids=["strong", "near-one"])
def test_ssd_decay_extremes_stable(a_lo, a_hi):
    """a near 1e-4 (exp(incl) underflows; the clipped ratios must not
    overflow) and a near 1 (nothing decays), against the sequential
    oracle and the Pallas kernel (atol 5e-3)."""
    jx, tx = _ssd_inputs(1, 128, 2, 32, 16, a_lo=a_lo, a_hi=a_hi, seed=5)
    y, s = ops.ssd(*tx, chunk=32)
    jy, js = jssd(*jx, chunk=32, interpret=True)
    jy_s, js_s = jax.jit(jref.ssd_ref)(*jx)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    np.testing.assert_allclose(_t(y), _np(jy_s), atol=5e-3)
    np.testing.assert_allclose(_t(s), _np(js_s), atol=5e-3)
    np.testing.assert_allclose(_t(y), _np(jy), atol=5e-3)
    np.testing.assert_allclose(_t(s), _np(js), atol=5e-3)


def test_ssd_state_chaining_equals_full_run():
    """Two halves with the state carried == one run (atol 1e-4)."""
    _, (x, a, Bm, Cm, _) = _ssd_inputs(2, 128, 2, 32, 16, state=False,
                                       seed=6)
    y_full, s_full = ref.ssd_chunked_ref(x, a, Bm, Cm, None, chunk=32)
    h = 64
    y1, s1 = ops.ssd(x[:, :h], a[:, :h], Bm[:, :h], Cm[:, :h], None,
                     chunk=32)
    y2, s2 = ops.ssd(x[:, h:], a[:, h:], Bm[:, h:], Cm[:, h:], s1, chunk=32)
    np.testing.assert_allclose(_t(torch.cat([y1, y2], 1)), _t(y_full),
                               atol=1e-4)
    np.testing.assert_allclose(_t(s2), _t(s_full), atol=1e-4)


def test_ssd_decode_step_matches_scan_and_reference():
    """Mirrors test_ssd_decode_step_matches_scan: 8 single steps == the
    sequential scan (atol 1e-4), each step == the reference's."""
    jx, tx = _ssd_inputs(2, 8, 2, 8, 4, state=False, seed=9)
    x, a, Bm, Cm, _ = tx
    y_ref, s_ref = ref.ssd_ref(x, a, Bm, Cm, None)
    S = torch.zeros(2, 2, 4, 8)
    jS = jnp.zeros((2, 2, 4, 8))
    ys = []
    for t in range(8):
        y, S = ops.ssd_decode(x[:, t], a[:, t], Bm[:, t], Cm[:, t], S)
        jy, jS = jref.ssd_decode_ref(*(v[:, t] for v in jx[:4]), jS)
        np.testing.assert_allclose(_t(y), _np(jy), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_t(S), _np(jS), rtol=1e-5, atol=1e-5)
        ys.append(y)
    np.testing.assert_allclose(_t(torch.stack(ys, 1)), _t(y_ref), atol=1e-4)
    np.testing.assert_allclose(_t(S), _t(s_ref), atol=1e-4)


def test_ssd_raises_unless_the_chunk_divides_T():
    """The reference's contract (src/repro/kernels/ssd_scan.py:76-79): the
    chunk is cut to T, and must divide it."""
    jx, tx = _ssd_inputs(1, 96, 1, 16, 8, state=False)
    with pytest.raises(ValueError, match="not divisible"):
        jssd(*jx, chunk=64, interpret=True)
    for fn in (ops.ssd, ops.plain_ssd):
        with pytest.raises(ValueError, match="not divisible"):
            fn(*tx, chunk=64)
    with pytest.raises(ValueError, match="not divisible"):
        ref.ssd_chunked_ref(*tx, chunk=64)
    y, _ = ops.ssd(*(v[:, :48] if v is not None else v for v in tx),
                   chunk=64)                               # chunk cut to T
    assert tuple(y.shape) == (1, 48, 1, 16)


def test_ssd_writes_its_state_into_state_out_even_when_aliased():
    _, (x, a, Bm, Cm, s0) = _ssd_inputs(2, 64, 2, 16, 8, seed=8)
    y_want, s_want = ops.ssd(x, a, Bm, Cm, s0, chunk=16)
    buf = s0.clone()
    y, s = ops.ssd(x, a, Bm, Cm, buf, chunk=16, state_out=buf)
    assert s is buf
    assert torch.equal(y, y_want) and torch.equal(buf, s_want)
    out = torch.empty_like(s0)
    y2, s2 = ops.plain_ssd(x, a, Bm, Cm, s0, chunk=16, state_out=out)
    assert s2 is out and torch.equal(out, s_want) and torch.equal(y2, y)


def test_ssd_takes_B_and_C_broadcast_across_heads():
    """Jamba's mixer hands the scan one (B, T, N) projection expanded over
    the heads (stride 0); the result equals the materialized one's."""
    rng = np.random.RandomState(10)
    x = torch.from_numpy(rng.randn(2, 64, 4, 16).astype(np.float32))
    a = torch.from_numpy(rng.uniform(0.3, 1.0, (2, 64, 4)).astype(
        np.float32))
    b1, c1 = (torch.from_numpy(rng.randn(2, 64, 1, 8).astype(np.float32))
              for _ in range(2))
    Bm, Cm = b1.expand(2, 64, 4, 8), c1.expand(2, 64, 4, 8)
    assert Bm.stride(2) == 0
    y, s = ops.ssd(x, a, Bm, Cm, chunk=32)
    y2, s2 = ops.ssd(x, a, Bm.contiguous(), Cm.contiguous(), chunk=32)
    assert torch.equal(y, y2) and torch.equal(s, s2)


def test_ssd_rejects_other_devices_and_needs_cuda_for_the_kernel(
        monkeypatch):
    _, tx = _ssd_inputs(1, 16, 1, 16, 8, state=False)
    meta = [v.to("meta") if v is not None else None for v in tx]
    with pytest.raises(ValueError, match="no implementation"):
        ops.ssd(*meta, chunk=16)
    with pytest.raises(ValueError, match="expected the CUDA device"):
        kernel.ssd(*tx, chunk=16, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kernel.ssd(*tx, chunk=16)


def test_cpu_path_never_touches_the_kernel_loader(monkeypatch):
    from repro_torch.kernels import _build

    def boom(*a, **k):
        raise AssertionError("kernel loader touched on the CPU path")

    monkeypatch.setattr(_build, "load", boom)
    monkeypatch.setattr(_build, "build_all", boom)
    _, tx = _ssd_inputs(1, 32, 2, 16, 8)
    ops.ssd(*tx, chunk=16)
    ops.plain_ssd(*tx, chunk=16)
