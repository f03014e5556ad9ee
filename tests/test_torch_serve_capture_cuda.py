"""The captured LM serving path and the captured oracles, on the card.

``ServeEngine`` runs its prefill and decode programs as CUDA graphs (one
per prefill shape, one decode graph per batch size) with the decode
position on the device; the flash kernel takes that position from
``kv_len`` on the device; the LJ and teacher oracles replay one graph per
input shape per worker.  Every test here needs a CUDA card and ``nvcc``
(the kernels have no CPU or interpret mode), so each is marked ``cuda``
and skips without one.  This file imports no JAX, so it also runs where
JAX is absent:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_serve_capture_cuda.py

The CPU side (tensor index == host int, the plain versions with a tensor
offset, the eager engine against the reference) is
``tests/test_torch_serve_capture.py``.  Tolerances: flash_attention's
(2e-4 in fp32, 2e-2 in bf16, rtol and atol, as the reference's TOL);
captured against eager: the same bits, tokens and labels equal.
"""
import warnings

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

FA_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
ARCHS = ["llama3.2-1b", "qwen2-moe-a2.7b", "rwkv6-7b",
         "jamba-1.5-large-398b", "whisper-small", "internvl2-2b"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU or interpret mode, and CUDA graphs need the card")
    return torch.device("cuda")


def _model(arch, **kw):
    """``arch`` at its smoke widths with heads of 64 (a head dim of the
    flash kernel's), bf16 activations; the MoE groups with room for every
    choice (a decode step's group then routes as the prefill's)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import reduced_config
    from repro_torch.models import model_zoo

    cfg = reduced_config(get_arch(arch).model, "smoke").replace(
        head_dim=64, dtype="bfloat16", **kw)
    if cfg.moe_num_experts:
        cfg = cfg.replace(moe_capacity_factor=8.0)
    return cfg, model_zoo.build_model(cfg, max_seq=64)


def _batch(cfg, B, P, seed=2):
    rng = np.random.RandomState(seed)
    out = {"tokens": rng.randint(0, cfg.vocab_size, (B, P)).astype(np.int32)}
    if cfg.family == "encdec":
        out["enc_embeds"] = (rng.randn(B, cfg.encoder_seq, cfg.d_model)
                             * 0.02).astype(np.float32)
    if cfg.family == "vlm":
        out["patch_embeds"] = (rng.randn(B, cfg.vision_tokens, cfg.d_model)
                               * 0.02).astype(np.float32)
    return out


def _engine(arch, device, temperature=0.0, seed=0, **kw):
    from repro_torch.serving import ServeEngine

    cfg, m = _model(arch, **kw)
    params = m.init(torch.Generator(device=device).manual_seed(0),
                    device=device)
    n_prefix = cfg.vision_tokens if cfg.family == "vlm" else 0
    eng = ServeEngine(m, params, max_seq=n_prefix + 48, batch=4,
                      temperature=temperature, seed=seed, device=device)
    return cfg, m, eng, n_prefix


def _eager_loop(eng, batch, gen, temperature=0.0, seed=0):
    """The engine's loop op by op on the default stream, as the engine ran
    before it was captured: ``make_prefill_fn``/``make_decode_fn`` with a
    host int position; greedy, or multinomial from a generator seeded
    ``seed``.  Returns the new tokens (B, gen)."""
    from repro_torch.models import common as cm
    from repro_torch.models import model_zoo

    m, dev = eng.model, eng.device
    dt = cm.torch_dtype(m.cfg.dtype)
    inputs = {k: (torch.from_numpy(v).to(dev) if k == "tokens"
                  else torch.from_numpy(v).to(dev, dt))
              for k, v in batch.items()}
    B, P = batch["tokens"].shape
    n_prefix = m.cfg.vision_tokens if m.cfg.family == "vlm" else 0
    gen_ = torch.Generator(device=dev).manual_seed(seed)

    def sample(logits):
        if temperature <= 0:
            return torch.argmax(logits, -1).to(torch.int32)
        probs = torch.softmax(logits.float() / temperature, -1)
        return torch.multinomial(probs, 1, generator=gen_)[:, 0].to(
            torch.int32)

    prefill, decode = (model_zoo.make_prefill_fn(m),
                       model_zoo.make_decode_fn(m))
    cache = m.init_cache(B, eng.max_seq, device=dev)
    logits, cache = prefill(eng.params, inputs, cache)
    cur = sample(logits)[:, None]
    out = [cur]
    for i in range(gen - 1):
        logits, cache = decode(eng.params, cur, cache, n_prefix + P + i)
        cur = sample(logits)[:, None]
        out.append(cur)
    return torch.cat(out, 1).cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_captured_generate_equals_eager_loop(cuda_device, arch):
    """Greedy: the captured prefill and decode graphs give the eager
    loop's tokens, every one; a second generate replays the same graphs
    (one prefill and one decode capture in all)."""
    cfg, _, eng, _ = _engine(arch, cuda_device)
    batch = _batch(cfg, 4, 16)
    res = eng.generate(batch, max_new_tokens=12)
    want = _eager_loop(eng, batch, 12)
    np.testing.assert_array_equal(res.tokens[:, :16], batch["tokens"])
    np.testing.assert_array_equal(res.tokens[:, 16:], want)
    again = eng.generate(batch, max_new_tokens=12)
    np.testing.assert_array_equal(again.tokens, res.tokens)
    assert eng.captures == 2 and eng.replays == 2 * 12


@pytest.mark.cuda
def test_captured_generate_with_a_sliding_window(cuda_device):
    """A dense model with a 16-token window over a 24-token prompt: every
    decode step's window mask follows the position the kernel reads on the
    device (kv_len - 1), as the eager loop's host offsets give it."""
    cfg, _, eng, _ = _engine("llama3.2-1b", cuda_device, sliding_window=16)
    batch = _batch(cfg, 4, 24, seed=5)
    res = eng.generate(batch, max_new_tokens=16)
    np.testing.assert_array_equal(res.tokens[:, 24:],
                                  _eager_loop(eng, batch, 16))


@pytest.mark.cuda
def test_temperature_sampling_between_replays_equals_eager(cuda_device):
    """temperature > 0: the graphs stop at the logits and the engine's
    generator draws between the replays, so a seeded engine draws the
    eager loop's tokens from the same seed."""
    cfg, _, eng, _ = _engine("llama3.2-1b", cuda_device, temperature=1.3,
                             seed=7)
    batch = _batch(cfg, 4, 16)
    res = eng.generate(batch, max_new_tokens=10)
    want = _eager_loop(eng, batch, 10, temperature=1.3, seed=7)
    np.testing.assert_array_equal(res.tokens[:, 16:], want)


@pytest.mark.cuda
def test_one_capture_per_shape(cuda_device):
    """One prefill graph per (B, prompt length), one decode graph per B:
    a new prompt length adds one graph, a new batch size two, a repeat
    none."""
    cfg, _, eng, _ = _engine("llama3.2-1b", cuda_device)
    eng.generate(_batch(cfg, 4, 16), max_new_tokens=4)
    eng.generate(_batch(cfg, 4, 16, seed=3), max_new_tokens=6)
    assert eng.captures == 2
    eng.generate(_batch(cfg, 4, 20), max_new_tokens=4)
    assert eng.captures == 3
    eng.generate(_batch(cfg, 2, 16), max_new_tokens=4)
    assert eng.captures == 5
    slot = eng._slots[4]
    assert len(slot.prefills) == 2 and slot.decode is not None


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-7b",
                                  "jamba-1.5-large-398b"])
def test_counters_count_replays(cuda_device, arch):
    """After the capturing generate, a generate of 6 new tokens launches
    nothing eagerly: each replay adds its graph's launches, flash's per
    path (the prefill's tiled calls, each decode step's split calls),
    wkv6's and ssd's once per layer of the prefill."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd, wkv6

    cfg, _, eng, _ = _engine(arch, cuda_device)
    batch = _batch(cfg, 4, 16)
    eng.generate(batch, max_new_tokens=6)
    attn = {"dense": cfg.num_layers, "rwkv6": 0,
            "hybrid": cfg.num_layers // 8}[cfg.family]
    scans = {"dense": (0, 0), "rwkv6": (cfg.num_layers, 0),
             "hybrid": (0, 7 * cfg.num_layers // 8)}[cfg.family]
    before = (fa.launches, fa.launches_tiled, fa.launches_split,
              wkv6.launches, ssd.launches)
    captured = (dict(fa.captured), wkv6.captured, ssd.captured)
    eng.generate(batch, max_new_tokens=6)
    after = (fa.launches, fa.launches_tiled, fa.launches_split,
             wkv6.launches, ssd.launches)
    assert [a - b for a, b in zip(after, before)] == [
        6 * attn, attn, 5 * attn, *scans]
    assert (dict(fa.captured), wkv6.captured, ssd.captured) == captured


def _syncs(fn):
    """Messages of the synchronizing CUDA operations ``fn`` performs, as
    PyTorch's sync debug mode reports them (not its one-time notice that
    the mode is a prototype)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [str(w.message) for w in caught
            if "called a synchronizing" in str(w.message)]


@pytest.mark.cuda
def test_decode_loop_makes_no_host_sync(cuda_device):
    """A generate of 17 new tokens syncs as often as one of 2: the decode
    loop between the timers reads nothing back to the host."""
    cfg, _, eng, _ = _engine("llama3.2-1b", cuda_device)
    batch = _batch(cfg, 4, 16)
    eng.generate(batch, max_new_tokens=17)
    short = _syncs(lambda: eng.generate(batch, max_new_tokens=2))
    long = _syncs(lambda: eng.generate(batch, max_new_tokens=17))
    assert len(long) == len(short), (short, long)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,T,S,H,KV,D,causal,window,kv_len", [
    (8, 1, 576, 32, 8, 64, False, None, list(range(512, 576, 9))),
    (4, 1, 256, 8, 4, 64, False, 64, [1, 64, 200, 256]),
    (2, 2, 300, 8, 2, 64, True, 100, [300, 250]),
    (2, 8, 256, 8, 2, 64, True, None, [208, 150]),
    (4, 1, 576, 16, 2, 128, False, 100, [0, 64, 300, 576]),
], ids=["llama-decode", "window", "two-tokens", "tiled", "d128-window"])
def test_device_offset_kernel_matches_plain_version(
        cuda_device, dtype, B, T, S, H, KV, D, causal, window, kv_len):
    """The decode entry with the position on the device (q_offset a
    tensor, the kernel taking kv_len[b] - T) against ``ref.attention_ref``
    with those per-row offsets, on the split path and (T*G > 8) the tiled
    one; and bit for bit against the host-offset entry where every row
    has one offset."""
    from repro_torch.kernels import flash_attention as kernel

    rng = np.random.RandomState(11)
    q, k, v = (torch.from_numpy(rng.randn(*s).astype(np.float32)).to(
        cuda_device, dtype) for s in ((B, T, H, D), (B, S, KV, D),
                                      (B, S, KV, D)))
    kvl = torch.tensor(kv_len, dtype=torch.int32, device=cuda_device)
    off = kvl - T
    kw = dict(causal=causal, window=window, kv_len=kvl)
    before = kernel.launches
    got = kernel.flash_attention(q, k, v, q_offset=off, **kw)
    assert kernel.launches == before + 1
    want = ref.attention_ref(q, k, v, q_offset=off, **kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               rtol=FA_TOL[dtype], atol=FA_TOL[dtype])
    same = torch.full((B,), kv_len[-1], dtype=torch.int32,
                      device=cuda_device)
    a = kernel.flash_attention(q, k, v, q_offset=same - T, causal=causal,
                               window=window, kv_len=same)
    b = kernel.flash_attention(q, k, v, q_offset=kv_len[-1] - T,
                               causal=causal, window=window, kv_len=same)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_device_offset_kernel_refuses_a_tensor_offset_without_kv_len(
        cuda_device):
    from repro_torch.kernels import flash_attention as kernel

    q = torch.zeros(1, 1, 4, 64, device=cuda_device)
    k = torch.zeros(1, 8, 4, 64, device=cuda_device)
    with pytest.raises(ValueError, match="needs kv_len"):
        kernel.flash_attention(q, k, k, q_offset=torch.tensor(
            7, device=cuda_device))


@pytest.mark.cuda
def test_captured_lj_oracle_labels_equal_the_eager_ones(cuda_device):
    """One graph per input shape per worker, replayed on the worker's own
    stream: the labels are the eager ``lj_energy_forces``'s bit for bit,
    and a second shape adds one capture."""
    from repro_torch.examples import quickstart
    from repro_torch.models import potential as pot

    oracle = quickstart.LJOracle(0, "")
    assert oracle.device.type == "cuda"
    rng = np.random.RandomState(4)
    for n in (6, 6, 6, 8):
        x = (quickstart.lattice(8)[:n] + rng.randn(n, 3) * 0.05).astype(
            np.float32).reshape(-1)
        inp, label = oracle.run_calc(x)
        _, f = pot.lj_energy_forces(torch.from_numpy(x.reshape(-1, 3)).to(
            cuda_device))
        assert inp is x
        np.testing.assert_array_equal(label, f.reshape(-1).cpu().numpy())
    assert oracle.captures == 2


@pytest.mark.cuda
def test_captured_teacher_labels_equal_the_eager_ones(cuda_device):
    """The teacher's relabel as one graph per worker at (1, SEQ): labels
    equal the eager relabel's bit for bit, and each label adds the
    teacher's 4 flash launches by replay."""
    from repro_torch.examples import lm_active_distill as distill
    from repro_torch.kernels import flash_attention as fa

    oracle = distill.TeacherOracle(0, "", device=cuda_device)
    prompts = [distill.PromptGene(r, "").generate_new_data(None)[1]
               for r in range(5)]
    oracle.run_calc(prompts[0])
    before = fa.launches
    for x in prompts:
        inp, label = oracle.run_calc(x)
        toks = torch.from_numpy(x.astype(np.int32))[None].to(cuda_device)
        want = oracle.relabel(toks)[0].cpu().numpy()
        np.testing.assert_array_equal(label[1:], want.astype(np.float32))
        assert label[0] == x[0]
    layers = distill.TEACHER.num_layers
    # the eager relabels above launch the kernel too
    assert fa.launches - before == 2 * layers * len(prompts)
    assert oracle.captures == 1
