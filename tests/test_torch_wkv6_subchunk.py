"""The arithmetic of the CUDA ``wkv6`` kernel's bf16 path, on the CPU.

``wkv6.subchunk_model`` runs that path's steps in plain PyTorch: the
recurrence over sub-chunks of 8 rows carried through the state, the decays
as running products of w (no exp or log), the (8 x 8) diagonal blocks of A
formed directly, and, with ``split=3``, every product as the kernel's
``mma.sync`` forms it from three bf16 terms of each fp32 operand.  It is
held against the sequential oracle ``ref.wkv6_ref`` and against the JAX
package's Pallas kernel in interpret mode (as tests/test_kernels.py:111
runs it), at w = 1e-12 (the log's clip), 1e-4, U[0.2, 0.999) and exactly 1,
strong and no decay mixed per key channel, chunks 1, 7, 16, 48 and 64
(sub-chunks need not divide the chunk), N 16, 32 and 64, with and without
an incoming state.  The kernel itself runs on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).

Tolerances: the reference's atol, 5e-3 in fp32 and 1e-1 in bf16, with the
card gate's rtol (1e-4 in fp32, 2e-2 in bf16) for outputs above 1, where
one bf16 ulp of y exceeds the atol (chip_smoke.WKV_TOL)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6 import wkv6 as jwkv6
from repro_torch.kernels import bf16_terms, ref
from repro_torch.kernels import wkv6 as kernel

TOL = {"float32": dict(rtol=1e-4, atol=5e-3),
       "bfloat16": dict(rtol=2e-2, atol=1e-1)}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(B, T, H, N, dtype, seed=4, w=None, mixed=False, state=True,
            scale=1.0):
    """(jax arrays, torch tensors) of r, k, v, w, u, state0 from numpy: r,
    k, v normal times ``scale``; w uniform in [0.2, 0.999), or the constant
    ``w``, or (``mixed``) per key channel 1e-12, exactly 1 or uniform in
    turn; rounded to ``dtype``; u and the state fp32."""
    rng = np.random.RandomState(seed)
    r, k, v = (rng.randn(B, T, H, N).astype(np.float32) * scale
               for _ in range(3))
    wa = (np.full((B, T, H, N), w, np.float32) if w is not None
          else rng.uniform(0.2, 0.999, (B, T, H, N)).astype(np.float32))
    if mixed:
        wa[..., 0::3] = 1e-12
        wa[..., 1::3] = 1.0
    u = rng.randn(H, N).astype(np.float32)
    s0 = rng.randn(B, H, N, N).astype(np.float32) if state else None
    jd, td = DT[dtype]
    jx = [jnp.asarray(a).astype(jd) for a in (r, k, v, wa)] + [
        jnp.asarray(u), None if s0 is None else jnp.asarray(s0)]
    tx = [torch.from_numpy(a).to(td) for a in (r, k, v, wa)] + [
        torch.from_numpy(u), None if s0 is None else torch.from_numpy(s0)]
    return jx, tx


def _close(got, want, dtype):
    want = (want.float().numpy() if isinstance(want, torch.Tensor)
            else np.asarray(jnp.asarray(want, jnp.float32)))
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])


CASES = [
    ((1, 64, 2, 16, 16), {}),                        # the reference's sweep
    ((2, 128, 3, 32, 32), {}),
    ((1, 96, 1, 64, 32), {}),
    ((1, 64, 2, 64, 64), dict(w=1e-12)),             # the log's clip
    ((1, 128, 2, 16, 32), dict(w=1e-4, state=False)),  # strong decay
    ((1, 96, 2, 32, 48), dict(w=1.0)),               # no decay at all
    ((2, 64, 2, 64, 64), dict(mixed=True)),          # both, per channel
    ((1, 8, 2, 16, 1), {}),                          # chunk 1
    ((1, 77, 2, 32, 7), dict(mixed=True)),           # T, chunk not of 8
    ((2, 64, 2, 32, 64), dict(state=False)),         # no incoming state
]
IDS = ["sweep-n16", "sweep-n32", "sweep-n64", "w-clip", "strong-decay",
       "w-one", "mixed-decay", "c1", "ragged", "no-state"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,kw", CASES, ids=IDS)
def test_subchunk_model_matches_reference_and_pallas(shape, kw, dtype):
    """The kernel's arithmetic (three bf16 terms per product) against the
    sequential oracle and the Pallas kernel in interpret mode."""
    B, T, H, N, chunk = shape
    jx, tx = _inputs(B, T, H, N, dtype, **kw)
    y, s = kernel.subchunk_model(*tx, split=3)
    assert y.dtype == DT[dtype][1] and tuple(y.shape) == (B, T, H, N)
    assert s.dtype == torch.float32 and tuple(s.shape) == (B, H, N, N)
    assert torch.isfinite(y.float()).all() and torch.isfinite(s).all()
    y_seq, s_seq = ref.wkv6_ref(*tx)
    _close(y, y_seq, dtype)
    _close(s, s_seq, dtype)
    jy, js = jwkv6(*jx, chunk=chunk, interpret=True)
    _close(y, jy, dtype)
    _close(s, js, dtype)


@pytest.mark.parametrize("sub", [1, 3, 8, 16])
def test_subchunk_model_is_the_recurrence_at_any_sub_chunk(sub):
    """The sub-chunk length changes only the rounding (fp32 products): 1
    is the plain recurrence, 3 leaves a ragged last sub-chunk."""
    _, tx = _inputs(2, 40, 2, 16, "float32", seed=8, mixed=True)
    y, s = kernel.subchunk_model(*tx, sub=sub)
    y_seq, s_seq = ref.wkv6_ref(*tx)
    np.testing.assert_allclose(y.numpy(), y_seq.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(s.numpy(), s_seq.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("shape,mixed", [
    ((1, 64, 2, 32, 32), False), ((1, 64, 2, 32, 32), True),
    ((1, 64, 1, 64, 64), False), ((1, 64, 1, 64, 64), True),
], ids=["n32", "n32-mixed", "n64", "n64-mixed"])
def test_three_bf16_terms_hold_cancelling_products(shape, mixed):
    """|r|, |k|, |v| ~ 100 in bf16 (the card sweep's case): sums of large
    terms that cancel, where the bf16 tolerance is relative.  Three bf16
    terms per fp32 operand hold the chunked plain version's tolerance; one
    term (each operand rounded to bf16) misses it on many entries, so the
    case tells the two apart."""
    B, T, H, N, chunk = shape
    _, tx = _inputs(B, T, H, N, "bfloat16", scale=100.0, mixed=mixed)
    y_want, s_want = ref.wkv6_chunked_ref(*tx, chunk=chunk)
    y, s = kernel.subchunk_model(*tx, split=3)
    _close(y, y_want, "bfloat16")
    _close(s, s_want, "bfloat16")
    y1, s1 = kernel.subchunk_model(*tx, split=1)
    tol = TOL["bfloat16"]
    bad = ((y1.double() - y_want.double()).abs()
           > tol["atol"] + tol["rtol"] * y_want.double().abs())
    assert int(bad.sum()) > 20


def test_split_bf16_terms_add_back_to_the_operand():
    """Each term is exact in bf16; three of them keep 24 bits of x (the
    remainder is below 2^-24 |x|), two keep 16."""
    x = torch.from_numpy(np.random.RandomState(0).randn(4096)
                         .astype(np.float32) * 1e3)
    terms = bf16_terms.split_bf16(x, 3)
    for t in terms:
        assert torch.equal(t, t.to(torch.bfloat16).float())
    err3 = (x.double() - sum(t.double() for t in terms)).abs()
    err2 = (x.double() - terms[0].double() - terms[1].double()).abs()
    assert bool((err3 <= 2.0 ** -24 * x.double().abs()).all())
    assert bool((err2 <= 2.0 ** -16 * x.double().abs()).all())


def test_subchunk_model_state_chaining_equals_full_run():
    """Two halves with the state carried == one run: the state is all that
    crosses a sub-chunk, as it is all that crosses a call."""
    _, (r, k, v, w, u, s0) = _inputs(2, 80, 2, 32, "float32", seed=6,
                                     mixed=True)
    y, s = kernel.subchunk_model(r, k, v, w, u, s0, split=3)
    h = 36                                # not a multiple of the sub-chunk
    y1, s1 = kernel.subchunk_model(r[:, :h], k[:, :h], v[:, :h], w[:, :h],
                                   u, s0, split=3)
    y2, s2 = kernel.subchunk_model(r[:, h:], k[:, h:], v[:, h:], w[:, h:],
                                   u, s1, split=3)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s2.numpy(), s.numpy(), rtol=1e-5, atol=1e-5)


def test_fp32_reference_misses_fp32_tolerance_where_products_cancel():
    """Why the x100 cases are bf16 only: at |r|, |k|, |v| ~ 100 in fp32 the
    chunked plain version itself lies outside fp32's tolerance (rtol 1e-4,
    atol 5e-3) of the recurrence evaluated in float64 on some entries, so
    no fp32 kernel could be held to it against that plain version."""
    _, (r, k, v, w, u, s0) = _inputs(1, 64, 2, 32, "float32", scale=100.0)
    y, s = ref.wkv6_chunked_ref(r, k, v, w, u, s0, chunk=32)
    S = s0.double()
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None].double() * v[:, t, :, None, :].double()
        ys.append(torch.einsum("bhn,bhnm->bhm", r[:, t].double(),
                               S + u.double()[None, :, :, None] * kv))
        S = w[:, t, :, :, None].double() * S + kv
    y64 = torch.stack(ys, 1)
    tol = TOL["float32"]
    bad = (y.double() - y64).abs() > tol["atol"] + tol["rtol"] * y64.abs()
    # a few entries miss, and only a few: the float64 evaluation is the
    # same recurrence
    assert 0 < int(bad.sum()) < bad.numel() // 100
