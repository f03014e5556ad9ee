"""The arithmetic of the CUDA ``ssd`` kernel's bf16 path, on the CPU.

``ssd.mma_model`` runs that path's steps in plain PyTorch: each chunk
staged as a 64-row tile (rows past the chunk as x = B = C = 0 and a = 1),
G = C B^T, A = G * exp(clip(incl_t - incl_j, -60, 0)) masked to j <= t,
y = exp(incl) * (C S) + A x and S' = exp(total) S + (B * dec)^T x, and,
with ``split=3``, every product as the kernel's ``mma.sync`` forms it from
three bf16 terms of each fp32 operand (S, A, B * dec).  It is held against
the sequential oracle ``ref.ssd_ref`` and against the JAX package's Pallas
kernel in interpret mode (as tests/test_kernels.py:197 runs it), at
inputs of magnitude 1 and 100, a = 1e-4, U[0.3, 1), 0.999 and exactly 1,
chunks 1, 16, 48 and 64, N 8 and 16, P 16 and 128, with and without an
incoming state, and B and C broadcast across the heads (at magnitude
100 each entry within the tolerance of each reference or, where that
fp32 reference is itself further off, of the recurrence in float64).  The kernel itself runs on
the card (tests/test_torch_kernels_cuda.py, chip_smoke.py).

Tolerances: the reference's atol, 5e-3 in fp32 and 1e-1 in bf16, with the
card gate's rtol (1e-4 in fp32, 2e-2 in bf16) for outputs above 1, where
one bf16 ulp of y exceeds the atol (chip_smoke.SSD_TOL)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd as jssd
from repro_torch.kernels import ref
from repro_torch.kernels import ssd as kernel

TOL = {"float32": dict(rtol=1e-4, atol=5e-3),
       "bfloat16": dict(rtol=2e-2, atol=1e-1)}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(B, T, H, P, N, dtype, seed=11, a=None, state=True,
            broadcast=False, scale=1.0):
    """(jax arrays, torch tensors) of x, a, Bm, Cm, state0 from numpy: x,
    B, C normal times ``scale``; a uniform in [0.3, 1) or the constant
    ``a``; rounded to ``dtype``; the state fp32.  ``broadcast``: B and C
    one (B, T, N) projection across the heads (expanded with stride 0 for
    the port, materialized for the reference)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, H, P).astype(np.float32) * scale
    av = (np.full((B, T, H), a, np.float32) if a is not None
          else rng.uniform(0.3, 1.0, (B, T, H)).astype(np.float32))
    hb = 1 if broadcast else H
    Bm, Cm = (rng.randn(B, T, hb, N).astype(np.float32) * scale
              for _ in range(2))
    s0 = rng.randn(B, H, N, P).astype(np.float32) if state else None
    jd, td = DT[dtype]
    jx = [jnp.asarray(v).astype(jd) for v in
          (x, av, np.broadcast_to(Bm, (B, T, H, N)),
           np.broadcast_to(Cm, (B, T, H, N)))]
    tx = [torch.from_numpy(v).to(td) for v in (x, av, Bm, Cm)]
    tx[2], tx[3] = (t.expand(B, T, H, N) for t in tx[2:])
    return (jx + [None if s0 is None else jnp.asarray(s0)],
            tx + [None if s0 is None else torch.from_numpy(s0)])


def _close(got, want, dtype):
    want = (want.float().numpy() if isinstance(want, torch.Tensor)
            else np.asarray(jnp.asarray(want, jnp.float32)))
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])


def _outside(got, want, dtype):
    tol = TOL[dtype]
    got, want = got.double(), want.double()
    return (got - want).abs() > tol["atol"] + tol["rtol"] * want.abs()


def _misses(got, want, dtype, exact=None):
    """Entries of ``got`` outside the tolerance of ``want`` (and, given
    ``exact``, outside the tolerance of ``exact`` too)."""
    bad = _outside(got, want, dtype)
    if exact is not None:
        bad &= _outside(got, exact, dtype)
    return int(bad.sum())


def _exact(x, a, Bm, Cm, s0):
    """The recurrence S_t = a_t S_{t-1} + B_t^T x_t, y_t = C_t S_t
    evaluated in float64 on the same inputs: (y, S)."""
    B, T, H, P = x.shape
    S = (torch.zeros((B, H, Bm.shape[-1], P), dtype=torch.float64)
         if s0 is None else s0.double())
    ys = []
    for t in range(T):
        S = a[:, t, :, None, None].double() * S + \
            Bm[:, t, :, :, None].double() * x[:, t, :, None, :].double()
        ys.append(torch.einsum("bhn,bhnp->bhp", Cm[:, t].double(), S))
    return torch.stack(ys, 1), S


CASES = [
    ((1, 64, 2, 16, 8, 16), {}),                         # the reference's
    ((2, 128, 2, 128, 16, 64), dict(broadcast=True)),    # Jamba's heads
    ((1, 128, 2, 128, 16, 64), dict(a=1e-4)),            # past the clip
    ((1, 96, 2, 16, 16, 48), dict(a=0.999)),             # near one
    ((1, 64, 2, 128, 8, 64), dict(a=1.0)),               # no decay
    ((1, 8, 2, 16, 8, 1), {}),                           # chunk 1
    ((2, 64, 2, 16, 16, 16), dict(state=False)),         # no state
    ((1, 128, 2, 128, 16, 16), dict(a=1.0, broadcast=True)),
]
IDS = ["sweep", "broadcast", "strong-decay", "near-one-c48", "a-one-n8",
       "c1", "no-state", "a-one-c16"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,kw", CASES, ids=IDS)
def test_mma_model_matches_reference_and_pallas(shape, kw, dtype):
    """The kernel's arithmetic (three bf16 terms per fp32 operand) against
    the sequential oracle and the Pallas kernel in interpret mode."""
    B, T, H, P, N, chunk = shape
    jx, tx = _inputs(B, T, H, P, N, dtype, **kw)
    y, s = kernel.mma_model(*tx, chunk=chunk, split=3)
    assert y.dtype == DT[dtype][1] and tuple(y.shape) == (B, T, H, P)
    assert s.dtype == torch.float32 and tuple(s.shape) == (B, H, N, P)
    assert torch.isfinite(y.float()).all() and torch.isfinite(s).all()
    y_seq, s_seq = ref.ssd_ref(*tx)
    _close(y, y_seq, dtype)
    _close(s, s_seq, dtype)
    jy, js = jssd(*jx, chunk=chunk, interpret=True)
    _close(y, jy, dtype)
    _close(s, js, dtype)


X100 = [
    ((1, 128, 2, 32, 16, 32), {}),
    ((1, 128, 2, 128, 8, 64), dict(a=1e-4)),
    ((2, 128, 2, 128, 16, 64), dict(broadcast=True)),
    ((1, 96, 2, 16, 16, 48), dict(a=0.999, state=False)),
    ((1, 128, 2, 128, 16, 16), dict(a=1.0)),
]
X100_IDS = ["p32", "strong-decay-n8", "broadcast", "near-one-c48",
            "a-one-c16"]


@pytest.mark.parametrize("shape,kw", X100, ids=X100_IDS)
def test_mma_model_holds_x100_inputs(shape, kw):
    """|x|, |B|, |C| ~ 100 in bf16 (the card sweep's case): sums of large
    terms that cancel, where the bf16 tolerance is relative.  On an entry
    where terms of ~1e6 cancel to ~1e2, one ulp of one fp32 log moves y by
    more than that tolerance, so two fp32 evaluations of the recurrence
    (the chunked plain version, the sequential oracle, the Pallas kernel)
    can disagree there beyond it.  Each entry of the model (three bf16
    terms per fp32 operand) must lie within the tolerance of each of them,
    or of the recurrence evaluated in float64 where that reference is
    itself further off."""
    B, T, H, P, N, chunk = shape
    jx, tx = _inputs(B, T, H, P, N, "bfloat16", scale=100.0, **kw)
    y, s = kernel.mma_model(*tx, chunk=chunk, split=3)
    y64, s64 = _exact(*tx)
    jy, js = jssd(*jx, chunk=chunk, interpret=True)
    jy, js = (torch.from_numpy(np.asarray(jnp.asarray(v, jnp.float32)))
              for v in (jy, js))
    for want_y, want_s in (ref.ssd_chunked_ref(*tx, chunk=chunk),
                           ref.ssd_ref(*tx), (jy, js)):
        assert _misses(y, want_y, "bfloat16", y64) == 0
        assert _misses(s, want_s, "bfloat16", s64) == 0


@pytest.mark.parametrize("a", [None, 1.0], ids=["decay", "a-one"])
def test_fewer_bf16_terms_miss_where_three_hold(a):
    """Why three terms: at |x|, |B|, |C| ~ 100 with Jamba's head shape,
    one bf16 term per fp32 operand (each rounded to bf16) leaves many
    entries of y outside the bf16 tolerance of both the chunked plain
    version and the exact recurrence, two terms (16 of its 24 bits) still
    some; three leave none."""
    _, tx = _inputs(2, 128, 4, 128, 16, "bfloat16", seed=0, a=a,
                    scale=100.0)
    y_want, _ = ref.ssd_chunked_ref(*tx, chunk=64)
    y64, _ = _exact(*tx)
    misses = [_misses(kernel.mma_model(*tx, chunk=64, split=k)[0], y_want,
                      "bfloat16", y64) for k in (1, 2, 3)]
    assert misses[0] > 20 and misses[1] > 0 and misses[2] == 0, misses


@pytest.mark.parametrize("chunk", [1, 7, 16, 48, 64])
def test_mma_model_padding_is_exact_in_fp32(chunk):
    """The padded rows add nothing: with fp32 products the model is the
    chunked plain version on the same chunk up to rounding, whatever the
    chunk (7 leaves 57 padded rows a tile)."""
    T = 336 if chunk == 48 else 448 if chunk != 1 else 8
    _, tx = _inputs(1, T, 2, 32, 16, "float32", seed=3)
    y, s = kernel.mma_model(*tx, chunk=chunk, split=0)
    y_want, s_want = ref.ssd_chunked_ref(*tx, chunk=chunk)
    np.testing.assert_allclose(y.numpy(), y_want.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(s.numpy(), s_want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_mma_model_state_chaining_equals_full_run():
    """Two halves with the state carried == one run: the state is all that
    crosses a chunk, as it is all that crosses a call."""
    _, (x, a, Bm, Cm, s0) = _inputs(2, 128, 2, 32, 16, "bfloat16", seed=6)
    y, s = kernel.mma_model(x, a, Bm, Cm, s0, chunk=32, split=3)
    h = 64
    y1, s1 = kernel.mma_model(x[:, :h], a[:, :h], Bm[:, :h], Cm[:, :h], s0,
                              chunk=32, split=3)
    y2, s2 = kernel.mma_model(x[:, h:], a[:, h:], Bm[:, h:], Cm[:, h:], s1,
                              chunk=32, split=3)
    assert torch.equal(torch.cat([y1, y2], 1), y)
    np.testing.assert_allclose(s2.numpy(), s.numpy(), rtol=1e-6, atol=1e-6)


def test_mma_model_raises_unless_the_chunk_fits_a_tile_and_divides_T():
    _, tx = _inputs(1, 96, 1, 16, 8, "bfloat16", state=False)
    with pytest.raises(ValueError, match="chunk"):
        kernel.mma_model(*tx, chunk=64)
    _, tx = _inputs(1, 128, 1, 16, 8, "bfloat16", state=False)
    with pytest.raises(ValueError, match="chunk"):
        kernel.mma_model(*tx, chunk=128)


def test_fp32_reference_misses_fp32_tolerance_at_x100():
    """Why the x100 cases are bf16 only: at |x|, |B|, |C| ~ 100 in fp32 the
    chunked plain version itself lies outside fp32's tolerance (rtol 1e-4,
    atol 5e-3) of the recurrence evaluated in float64 on some entries, so
    no fp32 kernel could be held to it against that plain version."""
    _, (x, a, Bm, Cm, s0) = _inputs(1, 128, 2, 32, 16, "float32", seed=2,
                                    scale=100.0)
    y, _ = ref.ssd_chunked_ref(x, a, Bm, Cm, s0, chunk=64)
    y64, _ = _exact(x, a, Bm, Cm, s0)
    bad = _misses(y, y64, "float32")
    # a few entries miss, and only a few: the float64 evaluation is the
    # same recurrence
    assert 0 < bad < y64.numel() // 100
