"""The split-KV decode path of the CUDA ``flash_attention`` and the wrapper's
path rule, on the CPU.

``flash_attention.split_kv_model`` runs the split path's arithmetic in plain
PyTorch (fp32 partials m, l, acc per key range, merged in split order); it
is held against ``ref.attention_ref`` and against the JAX package's Pallas
kernel in interpret mode (as tests/test_kernels.py runs it), across split
counts, empty splits, ``kv_len`` 0 and fully masked rows.  ``plan`` is
checked at the llama3.2-1b and Jamba serving shapes.  The kernels
themselves run on the card (tests/test_torch_kernels_cuda.py).

Tolerances: the reference's TOL, 2e-4 in fp32 and 2e-2 in bf16 (rtol and
atol)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


def _inputs(B, T, S, H, KV, D, seed, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(*s).astype(np.float32)
            for s in ((B, T, H, D), (B, S, KV, D), (B, S, KV, D))]
    return arrs, [torch.from_numpy(a).to(dtype) for a in arrs]


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want,
                               np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("splits", [1, 2, 3, 9, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_split_model_matches_reference_across_split_counts(splits, dtype):
    """Decode (T = 1, G = 4) with kv_len on, below and above the split
    boundaries and 0; ranges past kv_len are empty splits."""
    B, T, S, H, KV, D = 6, 1, 576, 8, 2, 64
    _, (q, k, v) = _inputs(B, T, S, H, KV, D, 0, dtype)
    kv_len = torch.tensor([0, 1, 63, 64, 65, 576], dtype=torch.int32)
    kw = dict(causal=False, q_offset=575, kv_len=kv_len)
    keys = -(-S // splits)
    got = fa.split_kv_model(q, k, v, splits=-(-S // keys),
                            keys_per_split=keys, **kw)
    want = ref.attention_ref(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == want.shape
    _close(got, want.float().numpy(), TOL[dtype])
    assert torch.equal(got[0], torch.zeros_like(got[0]))      # kv_len 0


@pytest.mark.parametrize("T,q_offset,causal,window", [
    (1, 255, False, 64),      # sliding-window decode
    (2, 254, True, None),     # two-token decode, causal within
    (8, 100, True, 50),       # rows whose windows miss whole splits
])
def test_split_model_masks_like_the_reference(T, q_offset, causal, window):
    B, S, H, KV, D = 2, 256, 4, 4, 16
    _, (q, k, v) = _inputs(B, T, S, H, KV, D, 1)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_len=torch.tensor([200, 256], dtype=torch.int32))
    got = fa.split_kv_model(q, k, v, splits=4, keys_per_split=64, **kw)
    _close(got, ref.attention_ref(q, k, v, **kw).numpy(), TOL[torch.float32])


def test_split_model_gives_zero_for_fully_masked_rows():
    """Rows whose every key is hidden (causal queries placed before the
    first key) give 0, as the reference's l == 0 rows do."""
    _, (q, k, v) = _inputs(2, 1, 128, 8, 2, 64, 2)
    out = fa.split_kv_model(q, k, v, splits=2, keys_per_split=64,
                            causal=True, q_offset=-5)
    assert torch.equal(out, torch.zeros_like(out))
    want = ref.attention_ref(q, k, v, causal=True, q_offset=-5)
    assert torch.equal(want, torch.zeros_like(want))


@pytest.mark.parametrize("kv_len,splits", [
    ([64, 128], 2), ([0, 256], 4), ([1, 65], 4), ([256, 192], 1)],
    ids=["on-boundaries", "zero-and-full", "one-past", "one-split"])
def test_split_model_matches_the_pallas_kernel(kv_len, splits):
    """Against the TPU kernel itself, in interpret mode (T = 1 against a
    256-slot cache, blocks (1, 64))."""
    B, T, S, H, KV, D = 2, 1, 256, 8, 2, 64
    (jq, jk, jv), (q, k, v) = _inputs(B, T, S, H, KV, D, 3)
    want = jflash(jnp.asarray(jq), jnp.asarray(jk), jnp.asarray(jv),
                  causal=False, q_offset=255,
                  kv_len=jnp.asarray(kv_len, jnp.int32), interpret=True,
                  block_q=1, block_k=64)
    got = fa.split_kv_model(q, k, v, splits=splits,
                            keys_per_split=-(-S // splits), causal=False,
                            q_offset=255,
                            kv_len=torch.tensor(kv_len, dtype=torch.int32))
    _close(got, np.asarray(want), TOL[torch.float32])


@pytest.mark.parametrize("shape,want", [
    # llama3.2-1b decode and prefill: G = 4
    ((8, 1, 576, 32, 8), fa.Plan("split", 5, 116)),
    ((8, 512, 512, 32, 8), fa.Plan("tiled", 1, 512)),
    # the Jamba one-card cut: G = 8, hd 128
    ((8, 1, 576, 64, 8), fa.Plan("split", 5, 116)),
    ((8, 512, 512, 64, 8), fa.Plan("tiled", 1, 512)),
    # a multi-token decode past the row limit takes the tiled path
    ((2, 8, 256, 8, 2), fa.Plan("tiled", 1, 256)),
    # two tokens at G = 4: 8 rows, still split
    ((8, 2, 576, 32, 8), fa.Plan("split", 5, 116)),
    # short caches: one range; an empty cache: one range of one key
    ((8, 1, 100, 32, 8), fa.Plan("split", 1, 100)),
    ((2, 1, 0, 4, 2), fa.Plan("split", 1, 1)),
    # one sequence, one kv head, a long cache: capped splits
    ((1, 1, 65536, 4, 1), fa.Plan("split", 128, 512)),
], ids=["llama-decode", "llama-prefill", "jamba-decode", "jamba-prefill",
        "multi-token", "two-token", "short", "empty", "long"])
def test_plan_at_the_serving_shapes(shape, want):
    assert fa.plan(*shape) == want


def test_plan_covers_the_cache_with_enough_keys_and_blocks():
    """Every split plan covers S, has >= 64 keys a range when S has them,
    and at the llama decode shape puts well over 132 blocks on the card."""
    for B in (1, 2, 8, 32):
        for KV in (1, 8):
            for S in (0, 1, 63, 64, 65, 576, 577, 4096, 100000):
                p = fa.plan(B, 1, S, 4 * KV, KV)
                assert p.path == "split"
                assert p.splits * p.keys_per_split >= S
                assert (p.splits - 1) * p.keys_per_split < max(S, 1)
                if S >= fa.SPLIT_MIN_KEYS:
                    assert p.keys_per_split >= fa.SPLIT_MIN_KEYS
    p = fa.plan(8, 1, 576, 32, 8)
    assert p.splits * 8 * 8 >= 2 * 132


@pytest.mark.parametrize("symbol", [
    "void (anonymous namespace)::tiled::flash_tiled_kernel<64>("
    "__nv_bfloat16 const*, __nv_bfloat16 const*)",
    "void (anonymous namespace)::split::flash_split_mma_kernel<128>("
    "__nv_bfloat16 const*, float*)",
    "void (anonymous namespace)::split::flash_split_kernel<float, 128, 8>("
    "float const*, float*)",
    "void (anonymous namespace)::split::flash_combine_kernel<float, 64>("
    "float const*, float*, int)",
    "void (anonymous namespace)::flash_attention_kernel<float, 64>("
    "float const*, float*)"],
    ids=["tiled", "split-mma", "split-fp32", "combine", "fp32"])
def test_lm_profile_counts_every_flash_kernel_as_flash(symbol):
    """The profiler's split of device time must put each flash kernel
    symbol under flash_attention, not under "other"."""
    from repro_torch.launch import lm_profile

    assert lm_profile._group(symbol) == "flash_attention"
