"""The port's data and checkpoint substrate (``repro_torch.data``,
``repro_torch.checkpoint``) against the reference's.  Mirrors
tests/test_optim_data_ckpt.py (synthetic data determinism and sharding,
prefetcher, host replay buffer, checkpoints: atomicity, retention,
resume, async errors): the synthetic streams are held bit for bit against
``repro.data.synthetic`` on the same seeds and steps."""
import os
import pickle
import tempfile

import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data import synthetic as jsyn
from repro_torch.checkpoint import (
    AsyncCheckpointer, BF16Bits, load_checkpoint, save_checkpoint,
)
from repro_torch.checkpoint import pytree_ckpt
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data import synthetic as tsyn
from repro_torch.data.prefetch import Prefetcher
from repro_torch.data.replay import ALReplayBuffer

CFG = ModelConfig(name="t", family="dense", num_layers=1, d_model=32,
                  num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=1000)
SHAPE = ShapeConfig("s", 16, 8, "train")
JCFG = JModelConfig(name="t", family="dense", num_layers=1, d_model=32,
                    num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=1000)
JSHAPE = JShapeConfig("s", 16, 8, "train")


# ---------------------------------------------------------------------------
# synthetic data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,step,rank,size", [(0, 0, 0, 1), (3, 7, 0, 1),
                                                 (3, 7, 2, 4), (11, 123, 1, 2)])
def test_synthetic_batch_bits_equal_reference(seed, step, rank, size):
    a = tsyn.synthetic_batch(CFG, SHAPE, step, seed=seed, dp_rank=rank,
                             dp_size=size)
    b = jsyn.synthetic_batch(JCFG, JSHAPE, step, seed=seed, dp_rank=rank,
                             dp_size=size)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == b[k].dtype


@pytest.mark.parametrize("family", ["encdec", "vlm"])
def test_synthetic_frontend_stubs_equal_reference(family):
    kw = dict(name="t", family=family, num_layers=1, d_model=32, num_heads=2,
              num_kv_heads=2, d_ff=64, vocab_size=1000, encoder_seq=12,
              vision_tokens=4)
    a = tsyn.synthetic_batch(ModelConfig(**kw), SHAPE, 5, seed=2)
    b = jsyn.synthetic_batch(JModelConfig(**kw), JSHAPE, 5, seed=2)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])


def test_splitmix_and_floats_equal_reference():
    x = np.arange(0, 2 ** 40, 2 ** 33 + 12345, dtype=np.uint64)
    np.testing.assert_array_equal(tsyn._splitmix64(x), jsyn._splitmix64(x))
    np.testing.assert_array_equal(tsyn.synthetic_floats(4, 9, (3, 5), 0.5),
                                  jsyn.synthetic_floats(4, 9, (3, 5), 0.5))


def test_synthetic_labels_shifted_and_in_vocab():
    b = tsyn.synthetic_batch(CFG, SHAPE, step=0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert b["tokens"].min() >= 0 and b["tokens"].max() < CFG.vocab_size
    full = tsyn.synthetic_batch(CFG, SHAPE, step=0)
    parts = [tsyn.synthetic_batch(CFG, SHAPE, step=0, dp_rank=r, dp_size=4)
             for r in range(4)]
    np.testing.assert_array_equal(
        full["tokens"], np.concatenate([p["tokens"] for p in parts]))


def test_stream_resume_bit_exact():
    s1 = tsyn.SyntheticTokenStream(CFG, SHAPE, seed=1)
    for _ in range(5):
        next(s1)
    s2 = tsyn.SyntheticTokenStream(CFG, SHAPE)
    s2.load_state_dict(s1.state_dict())
    np.testing.assert_array_equal(next(s1)["tokens"], next(s2)["tokens"])


def test_prefetcher_preserves_order_and_surfaces_errors():
    it = Prefetcher(iter(range(10)), depth=2)
    assert list(it) == list(range(10))

    def bad():
        yield 1
        raise RuntimeError("boom")

    it2 = Prefetcher(bad(), depth=2)
    assert next(it2) == 1
    with pytest.raises(RuntimeError):
        next(it2)


def test_al_replay_buffer_sampling_and_eviction():
    buf = ALReplayBuffer(capacity=4, seq_len=8)
    buf.add([np.arange(10) + i for i in range(6)])
    assert len(buf) == 4 and buf.evicted == 2
    batch = buf.sample(3, np.random.RandomState(0))
    assert batch["tokens"].shape == (3, 8)
    np.testing.assert_array_equal(batch["tokens"][:, 1:],
                                  batch["labels"][:, :-1])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_save_load_roundtrip_bf16_bits():
    tmp = tempfile.mkdtemp()
    bf = torch.tensor([1.0, -2.5, 3.14159, float("nan"), 1e-40]).to(
        torch.bfloat16)
    tree = {"w": torch.arange(6).reshape(2, 3), "s": torch.tensor(2.5),
            "b": bf}
    save_checkpoint(tmp, 5, tree, extra={"note": "x"})
    snap = load_checkpoint(tmp)
    assert snap["step"] == 5 and snap["extra"]["note"] == "x"
    np.testing.assert_array_equal(snap["tree"]["w"],
                                  np.arange(6).reshape(2, 3))
    assert isinstance(snap["tree"]["b"], BF16Bits)
    back = pytree_ckpt.leaf_from_host(snap["tree"]["b"], "cpu")
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.view(torch.int16), bf.view(torch.int16))
    # np.asarray gives the float32 values of the bf16 entries
    np.testing.assert_array_equal(np.asarray(snap["tree"]["b"])[:3],
                                  bf.float().numpy()[:3])
    assert pickle.loads(pickle.dumps(snap["tree"]["b"])).bits.tobytes() \
        == snap["tree"]["b"].bits.tobytes()


def test_checkpoint_retention_keeps_newest():
    tmp = tempfile.mkdtemp()
    ck = AsyncCheckpointer(tmp, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, {"x": torch.ones(2) * s})
    ck.wait()
    assert pytree_ckpt.list_steps(tmp) == [3, 4]
    assert pytree_ckpt.latest_step(tmp) == 4
    assert all(not f.startswith(".tmp_") for f in os.listdir(tmp))


def test_async_checkpointer_resume():
    tmp = tempfile.mkdtemp()
    ck = AsyncCheckpointer(tmp)
    ck.save(7, {"x": torch.ones(2) * 7})
    snap = ck.restore_latest()
    assert snap["step"] == 7
    np.testing.assert_array_equal(snap["tree"]["x"], [7.0, 7.0])


def test_async_checkpointer_surfaces_worker_errors(monkeypatch):
    tmp = tempfile.mkdtemp()
    ck = AsyncCheckpointer(tmp)

    def bomb(*a, **k):
        raise IOError("disk full")

    monkeypatch.setattr(pytree_ckpt, "save_checkpoint", bomb)
    ck.save(1, {"x": torch.ones(1)})
    with pytest.raises(IOError):
        ck.wait()
