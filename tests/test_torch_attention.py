"""Port parity for attention: ``repro_torch.kernels.ops.attention`` (its CPU
path) and ``ref.attention_ref`` / ``attention_chunked_ref`` against the JAX
package's ``repro.kernels.ref`` on the same numpy inputs, over the sweep of
tests/test_kernels.py:29-90; on three of those cases also against the
Pallas kernel itself, run in interpret mode as the reference's own tests
run it.  The CUDA kernel is held against the same plain versions on the
card (tests/test_torch_kernels_cuda.py, chip_smoke.py).

Tolerances: the reference's TOL, 2e-4 in fp32 and 2e-2 in bf16 (rtol and
atol); bf16 inputs are made by rounding the same fp32 numpy arrays in both
frameworks (both round to nearest even, so the bits agree)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import flash_attention as kernel

TOL = {"float32": 2e-4, "bfloat16": 2e-2}
_STATIC = ("causal", "window", "chunk")


def _jit(fn):
    """The reference function compiled once per mask setting (eager JAX
    dispatches every op on its own, which is slow on the CPU)."""
    def call(*args, **kw):
        static = {k: kw.pop(k) for k in _STATIC if k in kw}
        return jax.jit(lambda *a, **k: fn(*a, **static, **k))(*args, **kw)
    return call


jattention_ref = _jit(jref.attention_ref)
jattention_chunked_ref = _jit(jref.attention_chunked_ref)

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(shapes, dtype, seed):
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(*s).astype(np.float32) for s in shapes]
    jd, td = DT[dtype]
    return ([jnp.asarray(a).astype(jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs])


def _close(got, want, tol):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("B,T,H,KV,D", [
    (1, 128, 4, 4, 64),     # MHA
    (2, 256, 8, 2, 64),     # GQA 4:1
    (1, 128, 4, 1, 128),    # MQA, head_dim 128
])
@pytest.mark.parametrize("causal,window", [
    (True, None), (True, 64), (False, None),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_matches_reference(B, T, H, KV, D, causal, window, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(
        [(B, T, H, D), (B, T, KV, D), (B, T, KV, D)], dtype, 0)
    want = jattention_ref(jq, jk, jv, causal=causal, window=window)
    got = ops.attention(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and tuple(got.shape) == (B, T, H, D)
    _close(got, want, TOL[dtype])
    _close(ref.attention_ref(q, k, v, causal=causal, window=window), want,
           TOL[dtype])


@pytest.mark.parametrize("window", [None, 128])
def test_attention_chunked_ref_matches_reference(window):
    """T > q_chunk takes the chunked schedule, as the reference's ops."""
    B, T, H, KV, D = 2, 512, 8, 4, 64
    (jq, jk, jv), (q, k, v) = _inputs(
        [(B, T, H, D), (B, T, KV, D), (B, T, KV, D)], "float32", 3)
    want = jattention_chunked_ref(jq, jk, jv, causal=True, window=window,
                                  chunk=128)
    _close(ref.attention_chunked_ref(q, k, v, causal=True, window=window,
                                     chunk=128), want, TOL["float32"])
    _close(ops.attention(q, k, v, causal=True, window=window, q_chunk=128),
           want, TOL["float32"])
    _close(ops.attention(q, k, v, causal=True, window=window, q_chunk=128),
           jattention_ref(jq, jk, jv, causal=True, window=window),
           TOL["float32"])


def test_attention_chunked_ref_bf16_reads_probabilities_in_bf16():
    B, T, H, KV, D = 1, 128, 4, 2, 64
    (jq, jk, jv), (q, k, v) = _inputs(
        [(B, T, H, D), (B, T, KV, D), (B, T, KV, D)], "bfloat16", 4)
    want = jattention_chunked_ref(jq, jk, jv, causal=True, chunk=32)
    got = ref.attention_chunked_ref(q, k, v, causal=True, chunk=32)
    assert got.dtype == torch.bfloat16
    _close(got, want, TOL["bfloat16"])


def test_attention_decode_kv_len_matches_reference():
    B, S, H, KV, D = 3, 192, 8, 4, 64
    (jq, jk, jv), (q, k, v) = _inputs(
        [(B, 1, H, D), (B, S, KV, D), (B, S, KV, D)], "float32", 1)
    kv_len = np.array([50, 192, 1], np.int32)
    want = jattention_ref(jq, jk, jv, causal=False,
                          kv_len=jnp.asarray(kv_len), q_offset=191)
    got = ops.attention(q, k, v, causal=False,
                        kv_len=torch.from_numpy(kv_len), q_offset=191)
    _close(got, want, TOL["float32"])


def test_attention_sliding_window_decode_matches_reference():
    B, S, H, D, W = 2, 256, 4, 64, 64
    (jq, jk, jv), (q, k, v) = _inputs(
        [(B, 1, H, D), (B, S, H, D), (B, S, H, D)], "float32", 2)
    kv_len = np.array([200, 256], np.int32)
    want = jattention_ref(jq, jk, jv, causal=False, window=W,
                          kv_len=jnp.asarray(kv_len), q_offset=255)
    got = ops.attention(q, k, v, causal=False, window=W,
                        kv_len=torch.from_numpy(kv_len), q_offset=255)
    _close(got, want, TOL["float32"])


@pytest.mark.parametrize("T,S,causal,q_offset", [
    (100, 100, True, 0), (1, 577, False, 576), (37, 200, True, 163)])
def test_attention_ragged_shapes_match_reference(T, S, causal, q_offset):
    """Ragged T and S, which the Pallas kernel refuses and the port's
    kernel takes; the plain path must agree with the reference there."""
    (jq, jk, jv), (q, k, v) = _inputs(
        [(2, T, 4, 16), (2, S, 2, 16), (2, S, 2, 16)], "float32", 5)
    want = jattention_ref(jq, jk, jv, causal=causal, q_offset=q_offset)
    _close(ops.attention(q, k, v, causal=causal, q_offset=q_offset), want,
           TOL["float32"])


def test_fully_masked_rows_give_zero():
    (_, _, _), (q, k, v) = _inputs(
        [(1, 4, 2, 16), (1, 8, 2, 16), (1, 8, 2, 16)], "float32", 6)
    out = ops.attention(q, k, v, causal=False,
                        kv_len=torch.zeros(1, dtype=torch.int32))
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("B,T,S,H,KV,D,kw,blocks", [
    (1, 128, 128, 4, 4, 64, dict(causal=True), (64, 64)),
    (3, 1, 192, 8, 4, 64,
     dict(causal=False, kv_len=[50, 192, 1], q_offset=191), (1, 64)),
    (1, 128, 128, 4, 2, 64, dict(causal=True, window=64), (64, 64)),
], ids=["causal", "decode_kv_len", "window"])
def test_plain_version_matches_the_pallas_kernel(B, T, S, H, KV, D, kw,
                                                 blocks):
    """The port's plain version against the TPU kernel itself, in
    interpret mode (as tests/test_kernels.py runs it)."""
    (jq, jk, jv), (q, k, v) = _inputs(
        [(B, T, H, D), (B, S, KV, D), (B, S, KV, D)], "float32", 7)
    jkw, tkw = dict(kw), dict(kw)
    if "kv_len" in kw:
        jkw["kv_len"] = jnp.asarray(kw["kv_len"], jnp.int32)
        tkw["kv_len"] = torch.tensor(kw["kv_len"], dtype=torch.int32)
    want = jflash(jq, jk, jv, interpret=True, block_q=blocks[0],
                  block_k=blocks[1], **jkw)
    _close(ops.attention(q, k, v, **tkw), want, TOL["float32"])


def test_kv_seq_shard_raises_naming_the_multi_device_item():
    # the flag without rules (or with rules that do not split the cache)
    # is the plain call, as in the reference (ops.py acts on it only with
    # rules); the sharded case is tests/test_torch_mesh.py's
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 1, 2, 16, generator=g)
    k, v = torch.randn(2, 1, 8, 2, 16, generator=g)
    want = ops.attention(q, k, v, causal=False)
    assert torch.equal(ops.attention(q, k, v, causal=False,
                                     kv_seq_shard=True), want)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.rules import MeshRules

    assert torch.equal(ops.attention(q, k, v, causal=False,
                                     kv_seq_shard=True,
                                     rules=MeshRules(make_host_mesh())),
                       want)


def test_cpu_attention_never_touches_the_kernel(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("kernel loader touched on the CPU path")

    monkeypatch.setattr(_build, "load", boom)
    monkeypatch.setattr(_build, "build_all", boom)
    before = kernel.launches
    q = torch.zeros(1, 3, 2, 16)
    k = v = torch.zeros(1, 3, 2, 16)
    assert ops.attention(q, k, v).shape == (1, 3, 2, 16)
    assert kernel.launches == before


def test_kernel_wrapper_defaults_to_cuda_and_rejects_cpu_tensors(monkeypatch):
    q = torch.zeros(1, 3, 2, 16)
    with pytest.raises(ValueError, match="expected the CUDA device"):
        kernel.flash_attention(q, q, q, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kernel.flash_attention(q, q, q)
