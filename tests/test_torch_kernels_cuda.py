"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Needs a CUDA card and ``nvcc`` (the kernels have no CPU or
interpret mode), so every test here is marked ``cuda`` and skips without
one.  This file imports no JAX, so it also runs where JAX is absent:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances are the reference's: for committee_uq mean rtol 1e-5 atol 1e-6,
both stds rtol 1e-4 atol 1e-6, mask and finite counts exact; for
flash_attention its TOL, 2e-4 in fp32 and 2e-2 in bf16 (rtol and atol);
for wkv6 its atol, 5e-3 in fp32 and 1e-1 in bf16, with an rtol (1e-4 in
fp32, 2e-2 in bf16) for outputs of magnitude above 1, where one bf16 ulp
exceeds the atol; for ssd the reference's atol, 5e-3 in fp32 and 1e-1 in
bf16, with the same rtols as wkv6; all against the plain version on the
same CUDA tensors."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

MEAN_TOL = dict(rtol=1e-5, atol=1e-6)
STD_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU or interpret mode")
    return torch.device("cuda")


def _preds(K, n, d, seed=9):
    preds = np.random.RandomState(seed).randn(K, n, d).astype(np.float32)
    preds[:, 5 % n] = np.nan                  # a row with no finite member
    if K > 1 and n > 7:
        preds[0, 7, 0] = np.inf               # one quarantined member
        preds[1:, 3] = -np.inf                # a row with one finite member
    return preds


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("K,n,d", [(4, 64, 24), (1, 33, 3), (2, 1, 1),
                                   (64, 4096, 200), (8, 65536, 24)])
def test_committee_uq_kernel_matches_plain_version(cuda_device, K, n, d,
                                                   dtype):
    """The kernel loads bf16 and fp16 members itself, converting each
    element to fp32 (no cast in the wrapper): it must agree with the plain
    version on the same tensor in every input type."""
    from repro_torch.kernels import committee_uq as kernel

    x = torch.from_numpy(_preds(K, n, d)).to(dtype)
    before = kernel.launches
    got = [o.cpu().numpy() for o in ops.committee_uq(x.to(cuda_device), 0.9)]
    assert kernel.launches == before + 1
    want = [o.numpy() for o in ref.committee_uq_ref(x, 0.9)]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
    np.testing.assert_allclose(got[0], want[0], **MEAN_TOL)
    np.testing.assert_allclose(got[1], want[1], **STD_TOL)
    np.testing.assert_allclose(got[2], want[2], **STD_TOL)
    np.testing.assert_array_equal(got[4], want[4])
    away = np.abs(want[1] - 0.9) > STD_TOL["atol"] + STD_TOL["rtol"] * 0.9
    np.testing.assert_array_equal(got[3][away], want[3][away])


def _syncs(fn):
    """Messages of the synchronizing CUDA operations ``fn`` performs, as
    PyTorch's sync debug mode reports them."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [str(w.message).splitlines()[0] for w in caught
            if "synchroniz" in str(w.message)]


@pytest.mark.cuda
def test_engine_score_syncs_only_for_its_two_transfers(cuda_device):
    """One upload of the padded batch and one download of the five outputs
    per score: the stateful rules, TopFractionRule's ranking and
    DiversityRule's loop over the bucket never wait on the host.  Counted
    in steady state (the first measured call may carry one-time syncs)."""
    from repro_torch.core import acquisition as acq
    from repro_torch.core import budget
    from repro_torch.core.committee import params_from_numpy

    rng = np.random.RandomState(0)
    cparams = params_from_numpy(
        {"w": rng.randn(4, 6, 3).astype(np.float32)}, cuda_device)
    rows = [r.astype(np.float32) for r in rng.randn(40, 6)]
    apply = lambda p, x: x @ p["w"]                        # noqa: E731
    plain = acq.FusedEngine(apply, cparams, 0.5, device=cuda_device)
    full = acq.FusedEngine(apply, cparams, 0.5, device=cuda_device, rules=(
        budget.RollingReweightRule(n_buckets=16),
        budget.BudgetRule(target=0.3, thr_init=0.5),
        acq.TopFractionRule(0.5), acq.DiversityRule(0.3)))
    seen = {}
    for name, eng in (("plain", plain), ("full", full)):
        seen[name] = [_syncs(lambda: eng.score(rows)) for _ in range(3)]
    steady = {name: runs[-1] for name, runs in seen.items()}
    assert len(steady["full"]) == len(steady["plain"]) <= 2, seen


@pytest.mark.cuda
def test_committee_uq_kernel_rejects_what_it_does_not_take(cuda_device):
    from repro_torch.kernels import committee_uq as kernel

    with pytest.raises(TypeError):
        kernel.committee_uq(torch.zeros(2, 4, 3, dtype=torch.float64,
                                        device=cuda_device), 0.1,
                            device=cuda_device)
    with pytest.raises(ValueError, match="d <= 256"):
        kernel.committee_uq(torch.zeros(2, 4, 257, device=cuda_device), 0.1,
                            device=cuda_device)
    with pytest.raises(ValueError, match="d <= 256"):
        kernel.committee_uq(torch.zeros(2, 4, 257, dtype=torch.bfloat16,
                                        device=cuda_device), 0.1,
                            device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.committee_uq(torch.zeros(2, 3, 4, device=cuda_device)
                            .transpose(1, 2), 0.1, device=cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.uint8],
                         ids=["int32", "int64", "uint8"])
def test_committee_uq_kernel_refuses_integer_input(cuda_device, dtype):
    """The bf16/fp16 load path takes floats only: integer members raise
    (the wrapper checks the device first, so only the card reaches it)."""
    from repro_torch.kernels import committee_uq as kernel

    before = kernel.launches
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        kernel.committee_uq(torch.ones((4, 64, 24), dtype=dtype,
                                       device=cuda_device), 0.1,
                            device=cuda_device)
    assert kernel.launches == before


def _packed_case(K, n, d, dtype):
    x = torch.from_numpy(_preds(K, n, d, seed=K * 1000 + n + d)).to(dtype)
    return x, torch.tensor((2 * n) // 3, dtype=torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("d", [3, 24, 256])
@pytest.mark.parametrize("n", [1, 7, 64, 4096])
@pytest.mark.parametrize("K", [1, 2, 4, 8])
def test_committee_uq_packed_matches_plain_version(cuda_device, K, n, d,
                                                   dtype):
    """The engine's fused entry: the statistics, the finite counts and
    mask = row < n_valid & finite > 0 & scalar_std > threshold, written
    into the caller's packed buffer (non-finite members, n_valid < n)."""
    from repro_torch.kernels import committee_uq as kernel

    x, n_valid = _packed_case(K, n, d, dtype)
    out = torch.full((ref.packed_uq_nbytes(n, d),), 7, dtype=torch.uint8,
                     device=cuda_device)
    before = kernel.launches
    got = ops.committee_uq_packed(x.to(cuda_device), 0.9,
                                  n_valid.to(cuda_device), out=out)
    assert got is out and kernel.launches == before + 1
    want = ref.packed_uq_views(
        ref.committee_uq_packed_ref(x, 0.9, n_valid).numpy(), n, d)
    got = ref.packed_uq_views(out.cpu().numpy(), n, d)
    np.testing.assert_allclose(got[0], want[0], **MEAN_TOL)
    np.testing.assert_allclose(got[1], want[1], **STD_TOL)
    np.testing.assert_allclose(got[2], want[2], **STD_TOL)
    np.testing.assert_array_equal(got[3], want[3])
    away = np.abs(want[1] - 0.9) > STD_TOL["atol"] + STD_TOL["rtol"] * 0.9
    np.testing.assert_array_equal(got[4][away], want[4][away])
    assert not got[4][int(n_valid):].any()


@pytest.mark.cuda
def test_committee_uq_packed_rejects_what_it_does_not_take(cuda_device):
    from repro_torch.kernels import committee_uq as kernel

    x = torch.zeros(4, 8, 3, device=cuda_device)
    nv = torch.tensor(5, dtype=torch.int32, device=cuda_device)
    size = ref.packed_uq_nbytes(8, 3)
    before = kernel.launches
    for bad in (torch.empty(size - 1, dtype=torch.uint8, device=cuda_device),
                torch.empty(size, dtype=torch.uint8),
                torch.empty(size // 4, dtype=torch.int32,
                            device=cuda_device)):
        with pytest.raises(ValueError, match="out must be"):
            kernel.committee_uq_packed(x, 0.1, nv, out=bad,
                                       device=cuda_device)
    for bad in (nv.long(), nv.cpu(), torch.zeros(2, dtype=torch.int32,
                                                 device=cuda_device)):
        with pytest.raises(ValueError, match="n_valid"):
            kernel.committee_uq_packed(x, 0.1, bad, device=cuda_device)
    assert kernel.launches == before


# the engine on the card: the serving path's own committee (forces of an MLP
# potential by autograd), cut to test size
ENGINE_TOL = dict(rtol=1e-4, atol=1e-5)


def _potential_engines(rules, **kw):
    """A captured and an eager engine on the card and one on the CPU, all
    with the same weights."""
    from repro_torch.configs.pal_potential import PotentialConfig
    from repro_torch.core import acquisition as acq
    from repro_torch.models import potential as pot

    cfg = PotentialConfig(n_atoms=4, committee_size=3, hidden=(16, 16),
                          n_rbf=8)

    def apply(p, flat_batch):
        def one(flat):
            _, f = pot.energy_forces(p, flat.reshape(cfg.n_atoms, 3), cfg)
            return f.reshape(-1)
        return torch.func.vmap(one)(flat_batch)

    cparams = pot.init_committee(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    make = lambda dev, capture=True: acq.FusedEngine(  # noqa: E731
        apply, cparams, 0.5, rules=rules(), device=dev, capture=capture,
        **kw)
    return make("cuda"), make("cuda", False), make("cpu"), cparams


def _configs(n, seed):
    rng = np.random.RandomState(seed)
    lattice = np.stack(np.meshgrid([0, 1.3], [0, 1.3], [0, 1.3]),
                       -1).reshape(-1, 3)[:4].reshape(-1)
    return (lattice + rng.randn(n, 12) * 0.1).astype(np.float32)


def _assert_uq_equal(got, want, where, exact=False):
    for key in ("mean", "scalar_std", "component_std"):
        g, w = getattr(got, key), getattr(want, key)
        if exact:
            np.testing.assert_array_equal(g, w, err_msg=f"{where} {key}")
        else:
            np.testing.assert_allclose(g, w, err_msg=f"{where} {key}",
                                       **ENGINE_TOL)
    np.testing.assert_array_equal(got.mask, want.mask, err_msg=where)
    np.testing.assert_array_equal(got.finite_members, want.finite_members,
                                  err_msg=where)


def _engine_pipelines():
    from repro_torch.core import acquisition as acq
    from repro_torch.core import budget

    return {
        "default": lambda: None,
        "budget_reweight": lambda: (
            budget.RollingReweightRule(n_buckets=16, decay=0.8),
            budget.BudgetRule(target=0.3, thr_init=0.5, horizon=8,
                              target_serve=0.45)),
        "top_fraction": lambda: (acq.TopFractionRule(0.3),),
        "diversity": lambda: (acq.ThresholdRule(0.2),
                              acq.DiversityRule(0.05)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", ["default", "budget_reweight",
                                      "top_fraction", "diversity"])
def test_captured_engine_matches_eager_and_cpu(cuda_device, pipeline):
    """Captured engine == eager engine on the card (the same kernels in the
    same order: the same bits) == the CPU engine, over rounds that advance
    and rounds that do not, across buckets and both streams; one capture
    per bucket, one committee_uq launch per replay."""
    from repro_torch.core import acquisition as acq
    from repro_torch.kernels import committee_uq as kernel

    graph, eager, cpu, _ = _potential_engines(_engine_pipelines()[pipeline])
    for r, n in enumerate((10, 3, 16, 9, 20, 16, 5, 31)):
        batch = _configs(n, seed=r)
        stream = acq.STREAM_SERVE if r % 3 == 2 else acq.STREAM_EXCHANGE
        advance = r % 4 != 3
        before, d0 = kernel.launches, graph.dispatches
        got = graph.score(batch, advance=advance, stream=stream)
        if r >= 5:                     # every bucket captured by now
            assert kernel.launches - before == graph.dispatches - d0 == 1
        _assert_uq_equal(got, eager.score(batch, advance=advance,
                                          stream=stream), f"r{r}", exact=True)
        _assert_uq_equal(got, cpu.score(batch, advance=advance,
                                        stream=stream), f"r{r} vs CPU")
        for a, b in zip(graph.state_dict(), cpu.state_dict()):
            for key in b:
                np.testing.assert_allclose(a[key], b[key], rtol=1e-5,
                                           atol=1e-7, err_msg=f"r{r} {key}")
    assert graph.trace_counts == {8: 1, 16: 1, 32: 1}
    assert all(b.launches == 1 for b in graph._buckets.values())


@pytest.mark.cuda
def test_captured_engine_ignores_grad_mode_at_capture(cuda_device):
    """A bucket captured inside torch.no_grad() or torch.inference_mode()
    (forces by torch.func.grad under vmap) gives the same bits."""
    base, _, _, cparams = _potential_engines(
        _engine_pipelines()["budget_reweight"])
    batch = _configs(12, seed=3)
    want = base.score(batch, advance=False)
    for ctx in (torch.no_grad, torch.inference_mode):
        eng, _, _, _ = _potential_engines(
            _engine_pipelines()["budget_reweight"])
        with ctx():
            got = eng.score(batch, advance=False)
        _assert_uq_equal(got, want, ctx.__name__, exact=True)
        assert eng.trace_counts == {16: 1}


@pytest.mark.cuda
def test_captured_engine_two_threads_at_once(cuda_device):
    """Two threads score one engine at once, both capturing buckets at
    first use: the advancing thread's results and the final state equal
    the same rounds on the CPU; the read-only thread's statistics equal
    the CPU's (its masks follow whichever state it read)."""
    import threading

    graph, _, cpu, _ = _potential_engines(
        _engine_pipelines()["budget_reweight"])
    adv = [_configs(n, seed=10 + i) for i, n in enumerate((12, 16, 9) * 4)]
    ro = [_configs(n, seed=50 + i) for i, n in enumerate((30, 20, 7) * 4)]
    got_adv, got_ro, errors = [], [], []

    def run(batches, out, advance):
        try:
            for b in batches:
                out.append(graph.score(b, advance=advance))
        except Exception as e:               # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(adv, got_adv, True)),
               threading.Thread(target=run, args=(ro, got_ro, False))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    for i, b in enumerate(adv):
        _assert_uq_equal(got_adv[i], cpu.score(b), f"advancing {i}")
    for a, b in zip(graph.state_dict(), cpu.state_dict()):
        for key in b:
            np.testing.assert_allclose(a[key], b[key], rtol=1e-5, atol=1e-7)
    for i, b in enumerate(ro):
        want = cpu.score(b, advance=False)
        for key in ("mean", "scalar_std", "component_std"):
            np.testing.assert_allclose(getattr(got_ro[i], key),
                                       getattr(want, key), **ENGINE_TOL)
    assert graph.trace_counts == {8: 1, 16: 1, 32: 1}


@pytest.mark.cuda
def test_captured_engine_sees_refresh_and_restore(cuda_device):
    """After capture, refresh_from_device and load_state_dict copy into the
    buffers the graphs read: the answers change to the CPU engine's with
    the same weights and state, and no buffer moves."""
    graph, _, cpu, cparams = _potential_engines(
        _engine_pipelines()["budget_reweight"])
    batch = _configs(16, seed=7)
    graph.score(batch)
    cpu.score(batch)
    ptrs = [t.data_ptr() for t in graph.cparams.values()]
    sptrs = [t.data_ptr() for s in graph.rule_state for t in s.values()]
    new = {k: v * 1.5 for k, v in cparams.items()}
    graph.refresh_from_device({k: v.to(cuda_device) for k, v in new.items()})
    cpu.refresh_from_device(new)
    snap = cpu.state_dict()
    cpu.score(batch)
    graph.score(batch)
    graph.load_state_dict(snap)
    cpu.load_state_dict(snap)
    _assert_uq_equal(graph.score(batch), cpu.score(batch), "refreshed")
    assert [t.data_ptr() for t in graph.cparams.values()] == ptrs
    assert [t.data_ptr() for s in graph.rule_state
            for t in s.values()] == sptrs
    assert graph.device_refreshes == 1 and graph.refresh_host_bytes == 0
    assert graph.trace_counts == {16: 1}


# the committee trainer on the card: one captured CUDA graph per trainer,
# the potential's force loss (a double backward) at test size
TRAIN_LOSS_TOL = {"fp32": 1e-4, "bf16": 1e-3, "int8": 1e-3}


def _force_cfg(k=3):
    from repro_torch.configs.pal_potential import PotentialConfig

    return PotentialConfig(n_atoms=4, committee_size=k, hidden=(16, 16),
                           n_rbf=8)


def _forces(p, flat_batch):
    """A small MLP potential's forces over flat 4-atom geometries."""
    from repro_torch.models import potential as pot

    cfg = _force_cfg()

    def one(flat):
        _, f = pot.energy_forces(p, flat.reshape(cfg.n_atoms, 3), cfg)
        return f.reshape(-1)
    return torch.func.vmap(one)(flat_batch)


def _force_loss(p, b):
    return torch.mean((_forces(p, b["x"]) - b["y"]) ** 2), {}


def _force_cparams(k=3):
    from repro_torch.models import potential as pot

    return pot.init_committee(_force_cfg(k), torch.Generator().manual_seed(0),
                              device="cpu")


def _force_trainer(device, policy="fp32", capture=True, k=3):
    """A committee trainer on the force loss of a small MLP potential,
    with labelled near-lattice geometries in its ring; the same weights
    and data on every device."""
    from repro_torch.models import potential as pot
    from repro_torch.training import CommitteeTrainer

    forces, cparams = _forces, _force_cparams(k)
    tr = CommitteeTrainer(_force_loss, cparams, batch=16, lr=1e-3, seed=3,
                          replay_capacity=128, memory_policy=policy,
                          device=device, capture=capture)
    xs = _configs(96, seed=21)
    ys = np.stack([pot.lj_energy_forces(torch.from_numpy(c).reshape(4, 3))[1]
                   .reshape(-1).numpy() for c in xs])
    tr.add_blocks(list(zip(xs, ys)))
    return tr, forces, cparams


def _cpu_state(tr):
    import torch.utils._pytree as pytree
    return [t.cpu() for t in pytree.tree_leaves(tr.cstate)]


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["fp32", "bf16", "int8"])
def test_captured_trainer_matches_eager_and_cpu(cuda_device, policy):
    """Captured trainer == eager trainer on the card bit for bit (the same
    kernels in the same order) over 10 steps, and the CPU's losses within
    rtol 1e-4 (fp32; 1e-3 with bf16/int8 moments, where one rounding of a
    stored moment may fall the other way); one capture, one replay a
    step."""
    cap, _, _ = _force_trainer("cuda", policy)
    eager, _, _ = _force_trainer("cuda", policy, capture=False)
    cpu, _, _ = _force_trainer("cpu", policy)
    for t in range(10):
        lc = cap.train(steps=1)["loss"]
        np.testing.assert_array_equal(lc, eager.train(steps=1)["loss"])
        np.testing.assert_allclose(lc, cpu.train(steps=1)["loss"],
                                   rtol=TRAIN_LOSS_TOL[policy],
                                   err_msg=f"step {t}")
    for a, b in zip(_cpu_state(cap), _cpu_state(eager)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert cap.captures == 1 and cap.graph_replays == 10
    assert eager.captures == 0 and eager.graph_replays == 0
    if policy == "fp32":
        for a, b in zip(_cpu_state(cap), _cpu_state(cpu)):
            if a.is_floating_point():
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                           atol=1e-5)


@pytest.mark.cuda
def test_trainer_captures_once_in_any_grad_mode(cuda_device):
    """Rounds with an interrupt, a round inside torch.inference_mode() and
    blocks added after the capture: one capture, one replay per step, the
    ring's buffer never moves and the graph sees its new rows."""
    class Stop:
        def __init__(self):
            self.n = 0

        def test(self):
            self.n += 1
            return self.n % 4 == 0

    tr, _, cparams = _force_trainer("cuda")
    ptr, gen = tr.replay._buf.data_ptr(), tr.replay.generation
    first = tr.train(steps=10, interrupt=Stop())["loss"]
    assert tr.steps_done == 4 and tr.captures == 1
    with torch.inference_mode():
        tr.train(steps=30)
    tr.add_blocks(list(zip(_configs(40, seed=5), np.zeros((40, 12),
                                                          np.float32))))
    assert len(tr.replay) == 128 and int(tr.replay.size_dev) == 128
    tr.train(steps=5)
    assert tr.captures == 1 and tr.graph_replays == tr.steps_done == 39
    assert tr.replay._buf.data_ptr() == ptr and tr.replay.generation == gen
    assert not torch.equal(tr.cparams["w0"].cpu(), cparams["w0"])
    assert np.isfinite(first).all()


@pytest.mark.cuda
def test_trainer_restore_and_poison_after_capture(cuda_device):
    """load_state_dict and poison_member write into the buffers the graph
    reads: a restored captured trainer continues bit for bit as another
    one restored from the same snapshot, and a poisoned member is rolled
    back by the replayed quarantine."""
    a, _, _ = _force_trainer("cuda", "int8")
    b, _, _ = _force_trainer("cuda", "int8")
    a.train(steps=3)
    b.train(steps=1)                       # b captured too
    snap = a.state_dict()
    a.train(steps=4)
    ptrs = [t.data_ptr() for t in _leaves(a)]
    a.load_state_dict(snap)
    b.load_state_dict(snap)
    assert [t.data_ptr() for t in _leaves(a)] == ptrs
    a.train(steps=3)
    b.train(steps=3)
    for x, y in zip(_cpu_state(a), _cpu_state(b)):
        assert torch.equal(x, y)
    a.poison_member(1)
    opt1 = [t[1].cpu() for t in _leaves(a.cstate.opt)]
    out = a.train(steps=3)
    assert not out["member_ok"][1] and out["member_ok"][[0, 2]].all()
    assert all(torch.equal(x, y[1].cpu())
               for x, y in zip(opt1, _leaves(a.cstate.opt)))
    assert a.captures == b.captures == 1


def _leaves(tree):
    import torch.utils._pytree as pytree
    return pytree.tree_leaves(tree.cstate if hasattr(tree, "cstate")
                              else tree)


@pytest.mark.cuda
def test_trainer_handoff_then_score_on_another_thread(cuda_device):
    """Steps enqueued on the trainer's stream with no host sync, then
    ``snapshot_cparams``; another thread refreshes the captured engine with
    the snapshot and scores at once: the engine holds exactly the trained
    weights, answers as the CPU engine with them, moves 0 host bytes and
    captures nothing new."""
    import threading

    from repro_torch.core import acquisition as acq

    tr, forces, cparams = _force_trainer("cuda")
    tr.train(steps=2)
    eng = acq.FusedEngine(forces, cparams, 0.5, device="cuda")
    batch = _configs(16, seed=8)
    eng.score(batch)
    counts = dict(eng.trace_counts)
    with torch.inference_mode(False), tr._state_lock:
        for _ in range(20):
            tr._step()                       # enqueued, not synced
    snap = tr.snapshot_cparams()
    out, errors = [], []

    def consume():
        try:
            eng.refresh_from_device(snap)
            out.append(eng.score(batch))
        except Exception as e:               # surfaced below
            errors.append(e)

    t = threading.Thread(target=consume)
    t.start()
    t.join(timeout=300)
    assert not t.is_alive() and not errors, errors
    for k, v in tr.cparams.items():
        assert torch.equal(eng.cparams[k].cpu(), v.cpu()), k
    cpu = acq.FusedEngine(forces, {k: v.cpu() for k, v in
                                   tr.cparams.items()}, 0.5, device="cpu")
    _assert_uq_equal(out[0], cpu.score(batch), "after the handoff")
    assert eng.refresh_host_bytes == 0 and eng.device_refreshes == 1
    assert eng.trace_counts == counts


# PAL on the card: the engine's bucket graphs and the trainer's step graph
# captured by different threads of one run

class _CardGene:
    """A jittered 4-atom lattice walking on the committee-mean forces,
    ``limit`` proposals, then the generator's stop criterion."""

    def __init__(self, rank, result_dir, limit=300):
        self.rng = np.random.RandomState(rank)
        self.x = _configs(1, seed=40 + rank)[0]
        self.n, self.limit = 0, limit

    def generate_new_data(self, data_to_gene):
        self.n += 1
        if self.n > self.limit:
            return True, self.x
        if data_to_gene is not None:
            self.x = (self.x + 0.002 * np.clip(data_to_gene, -20, 20)
                      + self.rng.randn(12) * 0.01).astype(np.float32)
        return False, self.x

    def save_progress(self):
        pass

    def stop_run(self):
        pass


class _CardOracle:
    """Lennard-Jones forces of a flat 4-atom geometry, on the card."""

    def __init__(self, rank, result_dir):
        pass

    def run_calc(self, x):
        from repro_torch.models import potential as pot

        c = torch.from_numpy(np.asarray(x, np.float32)).cuda().reshape(4, 3)
        return x, pot.lj_energy_forces(c)[1].reshape(-1).cpu().numpy()

    def stop_run(self):
        pass


def _card_pal(tmp, device="cuda", limit=300, resume=False, **kw):
    from repro_torch.configs.pal_potential import PALRunConfig
    from repro_torch.core import PAL, CommitteeSpec

    cfg = PALRunConfig(result_dir=tmp, gene_process=4, orcl_process=2,
                       retrain_size=8, std_threshold=0.05, patience=3,
                       train_steps=40, train_batch=16, train_lr=1e-3,
                       train_replay_capacity=128, **kw)
    return PAL(cfg, make_generator=lambda r, d: _CardGene(r, d, limit),
               make_oracle=_CardOracle,
               committee=CommitteeSpec(_forces, _force_cparams()),
               loss_fn=_force_loss, resume=resume, device=device)


@pytest.mark.cuda
def test_pal_fused_run_on_the_card(cuda_device):
    """A fused PAL run on the card, its generators' stop criterion ending
    it: one capture per engine bucket and one for the trainer, committee_uq
    launches == engine dispatches (counted over replays) + the captures'
    warm-up launches, 0 refresh host bytes, no thread crash, every thread
    joined."""
    import tempfile

    from repro_torch.kernels import committee_uq as kernel

    pal = _card_pal(tempfile.mkdtemp())
    launches0 = kernel.launches
    tok = pal.run(timeout=120)
    rep = pal.report()
    assert tok is not None and "generator" in tok.origin, tok
    c = rep["counters"]
    assert c.get("runtime.thread_crashes", 0) == 0
    assert c.get("runtime.unjoined_threads", 0) == 0
    assert rep["labeled_total"] > 0 and c["train.retrains"] >= 1
    assert rep["device_weight_refreshes"] >= 1
    assert pal.engine.refresh_host_bytes == 0
    assert pal.engine.trace_counts and all(
        v == 1 for v in pal.engine.trace_counts.values()), \
        pal.engine.trace_counts
    tr = pal.committee_trainer
    assert tr.captures == 1 and tr.graph_replays == tr.steps_done > 0
    # two warm-up launches per in-run capture, then one replay a dispatch
    assert kernel.launches - launches0 == \
        pal.engine.dispatches + 2 * len(pal.engine.trace_counts)


@pytest.mark.cuda
def test_engine_and_trainer_capture_together_from_two_threads(cuda_device):
    """An engine's first bucket captures and a trainer's step capture,
    started together from two threads: both succeed (one capture each),
    the engine answers as the CPU engine with the same weights and the
    captured trainer trains as an eager one, bit for bit."""
    import threading

    from repro_torch.core import acquisition as acq

    tr, forces, cparams = _force_trainer("cuda")
    eager, _, _ = _force_trainer("cuda", capture=False)
    eng = acq.FusedEngine(forces, cparams, 0.5, device="cuda")
    batches = [_configs(n, seed=60 + n) for n in (5, 16, 30)]
    start = threading.Barrier(2)
    out, errors = {}, []

    def train():
        try:
            start.wait()
            out["loss"] = tr.train(steps=6)["loss"]
        except Exception as e:               # surfaced below
            errors.append(e)

    def score():
        try:
            start.wait()
            out["uq"] = [eng.score(b, advance=False) for b in batches]
        except Exception as e:               # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=f) for f in (train, score)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert tr.captures == 1 and tr.graph_replays == 6
    assert eng.trace_counts == {8: 1, 16: 1, 32: 1}
    np.testing.assert_array_equal(out["loss"], eager.train(steps=6)["loss"])
    for a, b in zip(_cpu_state(tr), _cpu_state(eager)):
        assert torch.equal(a, b)
    cpu = acq.FusedEngine(forces, cparams, 0.5, device="cpu")
    for b, got in zip(batches, out["uq"]):
        _assert_uq_equal(got, cpu.score(b, advance=False), "two threads")


@pytest.mark.cuda
def test_pal_resume_on_the_card_is_bit_for_bit(cuda_device):
    """A card PAL's checkpoint (trainer mid-schedule, advanced budget
    state) resumed by a new card PAL: the trainer's snapshot, the engine's
    rule state and the iteration come back bit for bit, the engine scores
    on the restored weights, and both trainers continue identically."""
    import tempfile

    tmp = tempfile.mkdtemp()
    a = _card_pal(tmp, oracle_budget=0.3)
    rows = _configs(96, seed=21)
    ys = np.stack([_CardOracle(0, tmp).run_calc(x)[1] for x in rows])
    a.committee_trainer.add_blocks(list(zip(rows, ys)))
    a.committee_trainer.train(steps=9)
    for n in (6, 13, 13):
        a.engine.score(_configs(n, seed=n))
    a.exchange.iteration = 23
    a.checkpoint()
    b = _card_pal(tmp, oracle_budget=0.3, resume=True)
    assert b.exchange.iteration == 23
    sa, sb = a.committee_trainer.state_dict(), b.committee_trainer.state_dict()
    assert sa["steps_done"] == sb["steps_done"] == 9
    for x, y in zip(_cpu_state(a.committee_trainer),
                    _cpu_state(b.committee_trainer)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    for x, y in zip(a.engine.state_dict(), b.engine.state_dict()):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    for k, v in a.committee_trainer.cparams.items():
        assert torch.equal(b.engine.cparams[k].cpu(), v.cpu()), k
    assert b.engine.refresh_host_bytes == 0
    probe = _configs(16, seed=77)
    a.engine.refresh_from_device(a.committee_trainer.snapshot_cparams())
    _assert_uq_equal(b.engine.score(probe, advance=False),
                     a.engine.score(probe, advance=False), "resumed")
    la = a.committee_trainer.train(steps=3)["loss"]
    lb = b.committee_trainer.train(steps=3)["loss"]
    np.testing.assert_array_equal(la, lb)
    assert a.committee_trainer.captures == b.committee_trainer.captures == 1


# the exploration fleet on the card: FusedEngine.score_after, one captured
# graph per (fleet, bucket), on the small potential's forces
FLEET_POS_ATOL = 5e-5


def _fleet_x0(n, seed=4):
    return _configs(n, seed)


def _fleet_threshold(engine, x0):
    """A threshold inside the committee's std range over ``x0``, so that
    walkers are both selected and restarted."""
    return float(np.quantile(engine.score(x0, advance=False).scalar_std,
                             0.4))


def _fleets(noise, n=5, patience=3, seed=0):
    """A fleet on a captured engine, one on an eager engine on the card and
    one on the CPU, all with the same weights, walkers and threshold."""
    from repro_torch.core import acquisition as acq
    from repro_torch.exploration import FleetConfig, WalkerFleet

    cparams = _force_cparams()
    x0 = _fleet_x0(n)
    thr = _fleet_threshold(acq.FusedEngine(_forces, cparams, 0.0,
                                           device="cpu"), x0)
    cfg = FleetConfig(noise=noise, patience=patience, seed=seed)
    out = []
    for dev, capture in (("cuda", True), ("cuda", False), ("cpu", True)):
        eng = acq.FusedEngine(_forces, cparams, thr, device=dev,
                              capture=capture)
        out.append(WalkerFleet(eng, x0, cfg))
    return out, thr


def _fleet_states_equal(a, b, where):
    sa, sb = a.state_dict(), b.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and np.array_equal(sa[k], sb[k]), \
            f"{where} {k}"


@pytest.mark.cuda
def test_captured_fleet_matches_eager_and_cpu(cuda_device):
    """A captured fleet == an eager fleet on the card, bit for bit, at
    noise 0.01 (the draws are a hash of the carry's counters); one capture
    per (fleet, bucket) and score()'s table untouched; one committee_uq
    launch per step after the capture's two warm-up launches; 0 bytes
    uploaded per step and 4 + the selected rows' bytes downloaded."""
    from repro_torch.kernels import committee_uq as kernel

    (graph, eager, _), _ = _fleets(noise=0.01)
    eng = graph.engine
    for i in range(20):
        before, up, down = kernel.launches, eng.bytes_to_device, \
            eng.bytes_to_host
        a = graph.step()
        # the first step: the capture's 2 warm-up launches, then a replay
        assert kernel.launches - before == (3 if i == 0 else 1)
        b = eager.step()
        assert eng.bytes_to_device == up
        assert eng.bytes_to_host - down == 4 + a.selected.nbytes
        assert a.n_selected == b.n_selected
        np.testing.assert_array_equal(a.selected, b.selected)
        for key in ("mask", "mean", "scalar_std", "component_std",
                    "finite_members"):
            assert torch.equal(getattr(a, key), getattr(b, key)), (i, key)
        _fleet_states_equal(graph, eager, f"step {i}")
    assert eng.step_trace_counts == {(graph._cache_key, 8): 1}
    assert eng.trace_counts == {} and eng.step_dispatches == 20
    assert all(sb.launches == 1 for sb in eng._step_buckets.values())


@pytest.mark.cuda
def test_captured_fleet_matches_the_cpu_at_noise_0(cuda_device):
    """The card's fleet follows the CPU's over 40 steps at noise 0:
    positions atol 5e-5, masks equal on rows further than 1e-4 relative
    from the threshold, restarts and counts exact; and the noise draws of
    the two devices are the same numbers."""
    from repro_torch.exploration import fleet as tfleet

    (graph, _, cpu), thr = _fleets(noise=0.0)
    n, selected = graph.n_walkers, 0
    for i in range(40):
        a, c = graph.step(), cpu.step()
        np.testing.assert_allclose(graph.positions(), cpu.positions(),
                                   atol=FLEET_POS_ATOL, rtol=0,
                                   err_msg=f"step {i}")
        std = c.scalar_std.numpy()[:n]
        away = np.abs(std - np.float32(thr)) > 1e-4 * thr
        assert np.array_equal(a.mask.cpu().numpy()[:n][away],
                              c.mask.numpy()[:n][away])
        sa, sc = graph.state_dict(), cpu.state_dict()
        for k in ("counts", "restarts", "flag", "step", "nan_resets"):
            assert np.array_equal(sa[k], sc[k]), (i, k)
        selected += a.n_selected
    assert selected > 0 and graph.stats()["restarts"] > 0
    key = tfleet.stream_keys(3, 64)
    assert torch.equal(tfleet.normal_draws(key.cuda(), 24).cpu(),
                       tfleet.normal_draws(key, 24))


@pytest.mark.cuda
def test_fleet_and_score_from_two_threads_on_the_card(cuda_device):
    """One thread steps a fleet while another scores batches on the same
    engine (both capturing at first use): the fleet follows a CPU fleet and
    the scores equal the CPU engine's."""
    import threading

    (graph, _, cpu), _ = _fleets(noise=0.0)
    batches = [_configs(n, seed=80 + i) for i, n in enumerate((9, 16, 30)
                                                               * 4)]
    got, errors, start = [], [], threading.Barrier(2)

    def step():
        try:
            start.wait()
            for _ in range(30):
                graph.step()
        except Exception as e:               # surfaced below
            errors.append(e)

    def score():
        try:
            start.wait()
            got.extend(graph.engine.score(b, advance=False) for b in batches)
        except Exception as e:               # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=f) for f in (step, score)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for _ in range(30):
        cpu.step()
    np.testing.assert_allclose(graph.positions(), cpu.positions(),
                               atol=FLEET_POS_ATOL, rtol=0)
    for b, g in zip(batches, got):
        _assert_uq_equal(g, cpu.engine.score(b, advance=False), "score")
    assert graph.engine.trace_counts == {16: 1, 32: 1}
    assert list(graph.engine.step_trace_counts.values()) == [1]


@pytest.mark.cuda
def test_fleet_sees_refresh_between_steps(cuda_device):
    """refresh_from_device between two steps copies into the buffers the
    fleet's graph reads: the next replay scores with the new weights, as
    the CPU fleet does, and nothing is captured again."""
    (graph, _, cpu), _ = _fleets(noise=0.0)
    for _ in range(3):
        graph.step()
        cpu.step()
    new = {k: v * 1.5 for k, v in _force_cparams().items()}
    ptrs = [t.data_ptr() for t in graph.engine.cparams.values()]
    graph.engine.refresh_from_device(
        {k: v.to(cuda_device) for k, v in new.items()})
    cpu.engine.refresh_from_device(new)
    for _ in range(3):
        a, c = graph.step(), cpu.step()
        np.testing.assert_allclose(a.mean.cpu().numpy(), c.mean.numpy(),
                                   **ENGINE_TOL)
    np.testing.assert_allclose(graph.positions(), cpu.positions(),
                               atol=FLEET_POS_ATOL, rtol=0)
    assert [t.data_ptr() for t in graph.engine.cparams.values()] == ptrs
    assert list(graph.engine.step_trace_counts.values()) == [1]


@pytest.mark.cuda
def test_fleet_nan_walker_and_state_roundtrip_on_the_card(cuda_device):
    """A poisoned walker resets to its trusted state once, on the card;
    a state_dict snapshot loaded into the captured fleet (and into a new
    fleet on the same engine) replays the same 6 steps bit for bit."""
    from repro_torch.core.chaos import ChaosInjector, FaultEvent, FaultPlan
    from repro_torch.exploration import FleetConfig, WalkerFleet

    (graph, _, _), _ = _fleets(noise=0.02, seed=9)
    chaos = ChaosInjector(FaultPlan(events=(
        FaultEvent("fleet.step", 3, "nan_walker", arg=1.0),)))
    graph.chaos = chaos
    for _ in range(3):
        graph.step()
    assert len(chaos.fired) == 1 and graph.stats()["nan_resets"] == 1
    np.testing.assert_array_equal(graph.positions()[1], _fleet_x0(5)[1])
    for _ in range(4):
        graph.step()
    assert np.isfinite(graph.positions()).all()
    assert graph.stats()["nan_resets"] == 1
    snap = graph.state_dict()
    for _ in range(6):
        graph.step()
    want = graph.state_dict()
    ptrs = [t.data_ptr() for t in graph._carry.values()]
    graph.load_state_dict(snap)
    assert [t.data_ptr() for t in graph._carry.values()] == ptrs
    other = WalkerFleet(graph.engine, np.zeros((5, 12), np.float32),
                        FleetConfig(noise=0.02, patience=3, seed=9))
    other.load_state_dict(snap)
    for _ in range(6):
        graph.step()
        other.step()
    for f in (graph, other):
        got = f.state_dict()
        for k in want:
            assert np.array_equal(got[k], want[k]), k
    assert list(graph.engine.step_trace_counts.values()) == [1, 1]


@pytest.mark.cuda
def test_pal_fleet_run_on_the_card(cuda_device):
    """PAL(fleet_walkers=16) on the card until the fleet's step limit: no
    crash, every thread joined, one capture per engine bucket, per fleet
    bucket and for the trainer, committee_uq launches == the engine's
    dispatches + fleet steps + two warm-up launches per capture, the
    engine holding the trainer's weights bit for bit."""
    import tempfile

    from repro_torch.kernels import committee_uq as kernel

    pal = _card_pal(tempfile.mkdtemp(), fleet_walkers=16,
                    fleet_max_steps=300)
    assert pal.generators == [] and pal.fleet.n_walkers == 16
    launches0 = kernel.launches
    tok = pal.run(timeout=120)
    rep = pal.report()
    assert tok is not None and tok.origin == "fleet", tok
    c = rep["counters"]
    assert c.get("runtime.thread_crashes", 0) == 0
    assert c.get("runtime.unjoined_threads", 0) == 0
    assert rep["fleet"]["steps"] == 300 == c["exchange.iterations"]
    assert rep["labeled_total"] > 0
    eng, tr = pal.engine, pal.committee_trainer
    assert all(v == 1 for v in eng.trace_counts.values())
    assert list(eng.step_trace_counts.values()) == [1]
    assert tr.captures == min(tr.steps_done, 1)
    assert tr.graph_replays == tr.steps_done
    assert kernel.launches - launches0 == (
        eng.dispatches + eng.step_dispatches
        + 2 * (len(eng.trace_counts) + len(eng.step_trace_counts)))
    if tr.steps_done:
        for k, v in tr.snapshot_cparams().items():
            assert torch.equal(eng.cparams[k], v), k


FA_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,T,S,H,KV,D,kw", [
    (2, 256, 256, 8, 2, 64, dict(causal=True)),
    (1, 128, 128, 4, 1, 128, dict(causal=True, window=64)),
    (1, 128, 128, 4, 4, 64, dict(causal=False)),
    (3, 1, 192, 8, 4, 64, dict(causal=False, kv_len=[50, 192, 1],
                               q_offset=191)),
    (2, 1, 256, 4, 4, 64, dict(causal=False, window=64, kv_len=[200, 256],
                               q_offset=255)),
    (2, 100, 200, 4, 2, 16, dict(causal=True, q_offset=100)),
    (1, 577, 577, 8, 8, 120, dict(causal=True, window=200)),
], ids=["gqa-causal", "mqa-window-d128", "mha-full", "decode-kv_len",
        "decode-window", "ragged-d16", "ragged-d120"])
def test_flash_attention_kernel_matches_plain_version(cuda_device, dtype, B,
                                                      T, S, H, KV, D, kw):
    from repro_torch.kernels import flash_attention as kernel

    rng = np.random.RandomState(11)
    q, k, v = (torch.from_numpy(rng.randn(*s).astype(np.float32)).to(
        cuda_device, dtype) for s in ((B, T, H, D), (B, S, KV, D),
                                      (B, S, KV, D)))
    kw = dict(kw)
    if "kv_len" in kw:
        kw["kv_len"] = torch.tensor(kw["kv_len"], dtype=torch.int32,
                                    device=cuda_device)
    before = kernel.launches
    got = ops.attention(q, k, v, **kw)
    assert kernel.launches == before + 1
    want = ref.attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               rtol=FA_TOL[dtype], atol=FA_TOL[dtype])


FA_PATH_CASES = {
    # the tiled path: a prefill with a window; a multi-token decode
    "tiled-prefill": ((2, 200, 200, 8, 2), dict(causal=True, window=64)),
    "tiled-multi-token": ((2, 8, 256, 8, 2), dict(
        causal=True, q_offset=200, kv_len=[208, 150])),
    # the split path: one token at G = 8 over 9 splits (kv_len 0, on a
    # boundary, inside, full); two tokens at G = 4 with a window
    "split-decode": ((4, 1, 576, 16, 2), dict(
        causal=False, q_offset=575, kv_len=[0, 64, 300, 576])),
    "split-two-token": ((2, 2, 300, 8, 2), dict(
        causal=True, q_offset=298, window=100, kv_len=[300, 250])),
    # sharp attention over large values that cancel (q x4, v x100), as a
    # random-weight LM's activations give: P must keep more than 8 bits
    "tiled-sharp": ((2, 256, 256, 16, 2), dict(causal=True)),
    "split-sharp": ((4, 1, 576, 16, 2), dict(
        causal=False, q_offset=575, kv_len=[1, 64, 300, 576])),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FA_PATH_CASES))
@pytest.mark.parametrize("D", [16, 64, 120, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_flash_attention_each_path_matches_plain_version(cuda_device, dtype,
                                                         D, case):
    """Each path of the wrapper's rule at every head dim: the call is
    counted on its path, matches the plain version, and (split path) gives
    the same bits when repeated."""
    from repro_torch.kernels import flash_attention as kernel

    (B, T, S, H, KV), kw = FA_PATH_CASES[case]
    path = case.split("-")[0]
    assert kernel.plan(B, T, S, H, KV).path == path
    rng = np.random.RandomState(12)
    sharp = case.endswith("sharp")
    q, k, v = (torch.from_numpy(rng.randn(*s).astype(np.float32) * x).to(
        cuda_device, dtype) for s, x in (
            ((B, T, H, D), 4.0 if sharp else 1.0), ((B, S, KV, D), 1.0),
            ((B, S, KV, D), 100.0 if sharp else 1.0)))
    kw = dict(kw)
    if "kv_len" in kw:
        kw["kv_len"] = torch.tensor(kw["kv_len"], dtype=torch.int32,
                                    device=cuda_device)
    before = (kernel.launches, kernel.launches_tiled, kernel.launches_split)
    got = ops.attention(q, k, v, **kw)
    after = (kernel.launches, kernel.launches_tiled, kernel.launches_split)
    assert after[0] == before[0] + 1
    assert (after[1] - before[1], after[2] - before[2]) == (
        (1, 0) if path == "tiled" else (0, 1))
    want = ref.attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               rtol=FA_TOL[dtype], atol=FA_TOL[dtype])
    if path == "split":
        assert torch.equal(got, ops.attention(q, k, v, **kw))


# A sequence-sharded cache: each rank's key range through the partials
# entry, then every rank's partials through the combine entry.  Cases:
# (B, T, S, H, KV), the ranks, the masks (kv_len per batch row)
FA_SHARD_CASES = {
    "decode-2-ranks": ((4, 1, 576, 16, 2), 2, dict(
        causal=True, q_offset=575, kv_len=[0, 64, 300, 576])),
    "decode-4-ranks-window": ((2, 1, 512, 8, 2), 4, dict(
        causal=True, q_offset=511, window=100, kv_len=[512, 200])),
    "two-token-2-ranks": ((2, 2, 300, 8, 2), 2, dict(
        causal=True, q_offset=298, kv_len=[300, 250])),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FA_SHARD_CASES))
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_flash_partials_and_combine_match_split_kv_model(cuda_device, dtype,
                                                         D, case):
    """Each rank's partials (its key range; q_offset and kv_len shifted to
    its start) against ``split_kv_partials`` with the same split plan, and
    the combine of every rank's partials against ``split_kv_model`` over
    the same key ranges and the plain attention over the whole cache."""
    from repro_torch.kernels import flash_attention as kernel

    (B, T, S, H, KV), n, kw = FA_SHARD_CASES[case]
    rng = np.random.RandomState(13)
    q, k, v = (torch.from_numpy(rng.randn(*s).astype(np.float32)).to(
        cuda_device, dtype) for s in ((B, T, H, D), (B, S, KV, D),
                                      (B, S, KV, D)))
    kv_len = torch.tensor(kw["kv_len"], dtype=torch.int32,
                          device=cuda_device)
    mask = dict(causal=kw["causal"], window=kw.get("window"))
    tol = FA_TOL[dtype]
    S_loc, parts, splits0 = S // n, [], None
    before = (kernel.launches_partials, kernel.launches_combine)
    for r in range(n):
        lo = r * S_loc
        kl, vl = (t[:, lo:lo + S_loc].contiguous() for t in (k, v))
        kvl = (kv_len - lo).clamp(min=0)
        part, splits = kernel.flash_partials(
            q, kl, vl, q_offset=kw["q_offset"] - lo, kv_len=kvl,
            device=cuda_device, **mask)
        p = kernel.plan(B, T, S_loc, H, KV)
        want = kernel.pack_partials(*kernel.split_kv_partials(
            q, kl, vl, splits=splits, keys_per_split=p.keys_per_split,
            q_offset=kw["q_offset"] - lo, kv_len=kvl, **mask))
        torch.cuda.synchronize()
        assert splits == p.splits and part.shape == want.shape
        assert torch.equal(torch.isfinite(part), torch.isfinite(want))
        fin = torch.isfinite(want)
        np.testing.assert_allclose(part[fin].cpu().numpy(),
                                   want[fin].cpu().numpy(), rtol=tol,
                                   atol=tol)
        parts.append(part)
        splits0 = splits
    got = kernel.flash_combine(torch.cat(parts), ranks=n, splits=splits0,
                               B=B, T=T, H=H, KV=KV, D=D, dtype=dtype,
                               device=cuda_device)
    assert (kernel.launches_partials - before[0],
            kernel.launches_combine - before[1]) == (n, 1)
    model = kernel.split_kv_model(q, k, v, splits=n * splits0,
                                  keys_per_split=-(-S_loc // splits0),
                                  q_offset=kw["q_offset"], kv_len=kv_len,
                                  **mask) if S_loc % splits0 == 0 else None
    plain = ref.attention_ref(q, k, v, q_offset=kw["q_offset"],
                              kv_len=kv_len, **mask)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == plain.shape
    for want in (model, plain):
        if want is not None:
            np.testing.assert_allclose(got.float().cpu().numpy(),
                                       want.float().cpu().numpy(),
                                       rtol=tol, atol=tol)
    # the same bits on a repeat (splits merged in a fixed order)
    assert torch.equal(got, kernel.flash_combine(
        torch.cat(parts), ranks=n, splits=splits0, B=B, T=T, H=H, KV=KV,
        D=D, dtype=dtype, device=cuda_device))


@pytest.mark.cuda
def test_flash_partials_and_combine_reject_what_they_do_not_take(
        cuda_device):
    from repro_torch.kernels import flash_attention as kernel

    q = torch.zeros(1, 4, 8, 64, device=cuda_device)    # T*G = 16 rows
    k = torch.zeros(1, 32, 2, 64, device=cuda_device)
    with pytest.raises(ValueError, match="split kernel holds"):
        kernel.flash_partials(q, k, k, device=cuda_device)
    part, splits = kernel.flash_partials(q[:, :1], k, k, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous float32"):
        kernel.flash_combine(part[:-1], ranks=1, splits=splits, B=1, T=1,
                             H=8, KV=2, D=64, dtype=torch.float32,
                             device=cuda_device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kernel.flash_combine(part, ranks=1, splits=splits, B=1, T=1, H=8,
                             KV=2, D=64, dtype=torch.float16,
                             device=cuda_device)


@pytest.mark.cuda
def test_mesh_engine_and_trainer_on_a_one_rank_nccl_group(cuda_device,
                                                          tmp_path):
    """World size 1 over NCCL: the 1x1 mesh engine and trainer equal the
    unsharded ones on the card bit for bit; the committee axis of a 1-rank
    mesh needs no collective."""
    from repro_torch.core import acquisition as acq
    from repro_torch.core import budget
    from repro_torch.core.committee import params_from_numpy
    from repro_torch.launch import distributed
    from repro_torch.launch.mesh import make_host_mesh, make_scaleout_mesh
    from repro_torch.training.committee_trainer import CommitteeTrainer

    distributed._join(f"file://{tmp_path / 'store'}", 1, 0, "nccl",
                      cuda_device)
    try:
        one = torch.ones(1, device=cuda_device)
        torch.distributed.all_reduce(one)
        assert float(one) == 1.0
        rng = np.random.RandomState(3)
        ws = {"w": rng.randn(4, 6, 6).astype(np.float32)}

        def rules():
            return (budget.RollingReweightRule(n_buckets=8),
                    budget.BudgetRule(target=0.25, thr_init=0.4, horizon=8))

        engines = [acq.FusedEngine(lambda p, x: torch.tanh(x @ p["w"]),
                                   params_from_numpy(ws, cuda_device), 0.4,
                                   rules=rules(), mesh=m,
                                   device=cuda_device)
                   for m in (None, make_host_mesh(), make_scaleout_mesh())]
        for r in range(4):
            x = rng.randn(29, 6).astype(np.float32)
            outs = [e.score(x) for e in engines]
            for o in outs[1:]:
                for f in ("mean", "scalar_std", "component_std", "mask"):
                    np.testing.assert_array_equal(getattr(o, f),
                                                  getattr(outs[0], f))
        for e in engines[1:]:
            for a, b in zip(e.state_dict(), engines[0].state_dict()):
                for x, y in zip(a.values(), b.values()):
                    np.testing.assert_array_equal(x, y)
            assert e.trace_counts == {32: 1}
            assert e.collective_host_bytes == 0

        def loss(p, b):
            return torch.mean((torch.tanh(b["x"] @ p["w"]) - b["y"]) ** 2), {}

        trs = [CommitteeTrainer(loss, params_from_numpy(ws, cuda_device),
                                batch=8, lr=1e-2, replay_capacity=64,
                                mesh=m, device=cuda_device)
               for m in (None, make_host_mesh())]
        xs = rng.randn(40, 6).astype(np.float32)
        for t in trs:
            t.add_blocks(list(zip(xs, np.tanh(xs))))
            t.train(steps=20)
        assert torch.equal(trs[0].cparams["w"], trs[1].cparams["w"])
        assert trs[1].captures == 1
        engines[1].refresh_from_device(trs[1].snapshot_cparams())
        assert engines[1].refresh_host_bytes == 0
    finally:
        distributed.shutdown()


@pytest.mark.cuda
def test_flash_attention_kernel_rejects_what_it_does_not_take(cuda_device):
    from repro_torch.kernels import flash_attention as kernel

    def qkv(D=64, dtype=torch.float32):
        return (torch.zeros(1, 8, 4, D, dtype=dtype, device=cuda_device),
                torch.zeros(1, 8, 2, D, dtype=dtype, device=cuda_device))

    q, k = qkv(D=32)
    with pytest.raises(ValueError, match="head dims"):
        kernel.flash_attention(q, k, k, device=cuda_device)
    q, k = qkv(dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kernel.flash_attention(q, k, k, device=cuda_device)
    q, k = qkv()
    with pytest.raises(TypeError):
        kernel.flash_attention(q, k.to(torch.bfloat16), k,
                               device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.flash_attention(q.transpose(1, 2).contiguous().transpose(
            1, 2), k, k, device=cuda_device)
    with pytest.raises(ValueError, match="H % KV"):
        kernel.flash_attention(torch.zeros(1, 8, 3, 64, device=cuda_device),
                               k, k, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernel.flash_attention(q.flatten()[1:1 + 7 * 4 * 64].view(
            1, 7, 4, 64), k[:, :7], k[:, :7], device=cuda_device)
    before = kernel.launches
    kernel.flash_attention(q, k, k, device=cuda_device)
    kernel.flash_attention(q, k, k, causal=False, device=cuda_device)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2


WKV_TOL = {torch.float32: dict(rtol=1e-4, atol=5e-3),
           torch.bfloat16: dict(rtol=2e-2, atol=1e-1)}


def _wkv_inputs(B, T, H, N, dtype, device, seed=4, w_const=None,
                state=True, scale=1.0, mixed=False):
    """r, k, v normal times ``scale``; w uniform in [0.2, 0.999), or
    ``w_const``, or (``mixed``) per key channel 1e-12 (the log's clip),
    exactly 1 (bf16's rounding of w > 0.998) or uniform, in turn."""
    rng = np.random.RandomState(seed)
    r, k, v = (rng.randn(B, T, H, N).astype(np.float32) * scale
               for _ in range(3))
    w = (np.full((B, T, H, N), w_const, np.float32) if w_const is not None
         else rng.uniform(0.2, 0.999, (B, T, H, N)).astype(np.float32))
    if mixed:
        w[..., 0::3] = 1e-12
        w[..., 1::3] = 1.0
    u = rng.randn(H, N).astype(np.float32)
    s0 = rng.randn(B, H, N, N).astype(np.float32) if state else None
    xs = [torch.from_numpy(a).to(device, dtype) for a in (r, k, v, w)]
    return xs + [torch.from_numpy(u).to(device),
                 None if s0 is None else torch.from_numpy(s0).to(device)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,T,H,N,chunk,kw", [
    (1, 64, 2, 16, 16, {}),
    (2, 128, 3, 32, 32, {}),
    (1, 96, 1, 64, 32, {}),
    (2, 64, 4, 32, 64, {}),                   # the smoke preset's N = 32
    (2, 512, 8, 64, 64, {}),                  # rwkv6-7b's N, serving T
    (1, 96, 2, 64, 48, {}),                   # C < 64, not a power of two
    (1, 8, 2, 16, 1, {}),                     # C = 1
    (1, 128, 2, 16, 32, dict(w_const=1e-4)),  # strong decay
    (2, 64, 2, 32, 64, dict(state=False)),    # no incoming state
    (2, 128, 2, 64, 64, dict(w_const=1e-12)),  # the log's clip
    (2, 128, 2, 64, 32, dict(w_const=1.0)),   # no decay at all
    (2, 96, 3, 64, 48, dict(mixed=True)),     # both, per key channel
    (1, 77, 2, 32, 7, dict(mixed=True)),      # T not a multiple of 8
], ids=["sweep-n16", "sweep-n32", "sweep-n64", "smoke-n32", "serve-n64",
        "c48", "c1", "strong-decay", "no-state", "w-clip", "w-one",
        "mixed-decay", "ragged-t"])
def test_wkv6_kernel_matches_plain_version(cuda_device, dtype, B, T, H, N,
                                           chunk, kw):
    from repro_torch.kernels import wkv6 as kernel

    r, k, v, w, u, s0 = _wkv_inputs(B, T, H, N, dtype, cuda_device, **kw)
    before = kernel.launches
    y, s = ops.wkv6(r, k, v, w, u, s0, chunk=chunk)
    assert kernel.launches == before + 1
    y_want, s_want = ref.wkv6_chunked_ref(r, k, v, w, u, s0, chunk=chunk)
    torch.cuda.synchronize()
    assert y.dtype == dtype and tuple(y.shape) == (B, T, H, N)
    assert s.dtype == torch.float32 and tuple(s.shape) == (B, H, N, N)
    assert torch.isfinite(y.float()).all() and torch.isfinite(s).all()
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               y_want.float().cpu().numpy(), **WKV_TOL[dtype])
    np.testing.assert_allclose(s.cpu().numpy(), s_want.cpu().numpy(),
                               **WKV_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,N,chunk,mixed", [
    (1, 64, 2, 32, 32, False), (1, 64, 2, 32, 32, True),
    (1, 64, 1, 64, 64, False), (1, 64, 1, 64, 64, True),
], ids=["n32", "n32-mixed", "n64", "n64-mixed"])
def test_wkv6_kernel_holds_cancelling_products(cuda_device, B, T, H, N,
                                               chunk, mixed):
    """|r|, |k|, |v| ~ 100 in bf16: sums of large terms that cancel, where
    the bf16 tolerance is relative (the atol is negligible).  The kernel's
    products enter the tensor cores as three bf16 terms of each fp32
    operand, as close to the plain version as fp32 arithmetic; one bf16
    term per operand fails here by hundreds of entries
    (``wkv6.subchunk_model(split=1)`` on the CPU).  fp32 inputs are not
    held at this scale: fp32's rtol 1e-4 is below the reference's own
    distance from exact arithmetic on such entries."""
    x = _wkv_inputs(B, T, H, N, torch.bfloat16, cuda_device, scale=100.0,
                    mixed=mixed)
    y, s = ops.wkv6(*x, chunk=chunk)
    y_want, s_want = ref.wkv6_chunked_ref(*x, chunk=chunk)
    torch.cuda.synchronize()
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               y_want.float().cpu().numpy(),
                               **WKV_TOL[torch.bfloat16])
    np.testing.assert_allclose(s.cpu().numpy(), s_want.cpu().numpy(),
                               **WKV_TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_wkv6_kernel_repeats_give_the_same_bits(cuda_device, dtype):
    """No atomics: three calls on the same inputs, the same y and state."""
    x = _wkv_inputs(4, 256, 8, 64, dtype, cuda_device, seed=6, mixed=True)
    outs = [ops.wkv6(*x, chunk=64) for _ in range(3)]
    for y, s in outs[1:]:
        assert torch.equal(y, outs[0][0]) and torch.equal(s, outs[0][1])


@pytest.mark.cuda
def test_wkv6_bf16_instances_run_on_the_tensor_cores(cuda_device):
    """Every bf16 instance (N = 16, 32, 64) of the built library holds
    HMMA (or HGMMA) instructions, by ``cuobjdump -sass``."""
    import re
    import shutil
    import subprocess
    from pathlib import Path

    from repro_torch.kernels import _build

    _build.load("wkv6")
    exe = shutil.which("cuobjdump") or str(
        Path(_build.nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([exe, "-sass", str(_build.library_path("wkv6"))],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn is not None and re.search(r"\bHG?MMA\b", line):
            counts[fn] += 1
    mma = {f: c for f, c in counts.items() if "wkv6_mma_kernel" in f}
    assert len(mma) == 3 and all(c > 0 for c in mma.values()), counts


@pytest.mark.cuda
def test_wkv6_kernel_state_in_and_out_may_alias(cuda_device):
    """A layer's cache slice is both the incoming state and the output."""
    r, k, v, w, u, s0 = _wkv_inputs(2, 128, 4, 64, torch.bfloat16,
                                    cuda_device, seed=5)
    y_want, s_want = ops.wkv6(r, k, v, w, u, s0, chunk=64)
    cache = torch.zeros((3,) + tuple(s0.shape), device=cuda_device)
    cache[1] = s0
    y, s = ops.wkv6(r, k, v, w, u, cache[1], chunk=64, state_out=cache[1])
    torch.cuda.synchronize()
    assert s.data_ptr() == cache[1].data_ptr()
    assert torch.equal(y, y_want) and torch.equal(cache[1], s_want)
    assert not cache[0].any() and not cache[2].any()


@pytest.mark.cuda
def test_wkv6_kernel_rejects_what_it_does_not_take(cuda_device):
    from repro_torch.kernels import wkv6 as kernel

    r, k, v, w, u, s0 = _wkv_inputs(1, 64, 2, 16, torch.float32,
                                    cuda_device)
    with pytest.raises(ValueError, match="head dims"):
        x = torch.zeros(1, 64, 1, 128, device=cuda_device)
        kernel.wkv6(x, x, x, x, torch.zeros(1, 128, device=cuda_device),
                    device=cuda_device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kernel.wkv6(r.half(), k.half(), v.half(), w.half(), u,
                    device=cuda_device)
    with pytest.raises(TypeError, match="one dtype"):
        kernel.wkv6(r, k.to(torch.bfloat16), v, w, u, device=cuda_device)
    with pytest.raises(TypeError, match="float32 u"):
        kernel.wkv6(r, k, v, w, u.to(torch.bfloat16), device=cuda_device)
    with pytest.raises(ValueError, match="chunk"):
        kernel.wkv6(r, k, v, w, u, chunk=128, device=cuda_device)
    with pytest.raises(ValueError, match="chunk"):
        kernel.wkv6(r, k, v, w, u, chunk=48, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        rt = r.transpose(1, 2).contiguous().transpose(1, 2)
        kernel.wkv6(rt, k, v, w, u, device=cuda_device)
    with pytest.raises(ValueError, match="state"):
        kernel.wkv6(r, k, v, w, u, s0[:, :1], device=cuda_device)
    with pytest.raises(ValueError, match="state_out"):
        kernel.wkv6(r, k, v, w, u, s0, state_out=s0.to(torch.bfloat16),
                    device=cuda_device)
    with pytest.raises(ValueError, match="expected the CUDA device"):
        kernel.wkv6(r.cpu(), k, v, w, u, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flat = torch.zeros(r.numel() + 1, dtype=torch.bfloat16,
                           device=cuda_device)
        rb = flat[1:].view(r.shape)           # contiguous, 2 bytes off
        kernel.wkv6(rb, rb, rb, rb, u, device=cuda_device)
    before = kernel.launches
    kernel.wkv6(r, k, v, w, u, s0, chunk=16, device=cuda_device)
    kernel.wkv6(r, k, v, w, u, chunk=64, device=cuda_device)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2


SSD_TOL = WKV_TOL


def _ssd_inputs(B, T, H, P, N, dtype, device, seed=8, a_lo=0.3, a_hi=1.0,
                state=True, broadcast=False, scale=1.0):
    """x, B, C normal times ``scale`` and a uniform in [a_lo, a_hi) (a_lo =
    a_hi = 1: no decay), all in ``dtype``; the state fp32 (or none).
    ``broadcast``: B and C one (B, T, N) projection expanded across the
    heads (stride 0), as Jamba's mixer makes them."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, H, P).astype(np.float32) * scale
    a = rng.uniform(a_lo, a_hi, (B, T, H)).astype(np.float32)
    hb = 1 if broadcast else H
    Bm, Cm = (rng.randn(B, T, hb, N).astype(np.float32) * scale
              for _ in range(2))
    s0 = rng.randn(B, H, N, P).astype(np.float32) if state else None
    x, a, Bm, Cm = (torch.from_numpy(v).to(device, dtype)
                    for v in (x, a, Bm, Cm))
    if broadcast:
        Bm, Cm = Bm.expand(B, T, H, N), Cm.expand(B, T, H, N)
    return x, a, Bm, Cm, (None if s0 is None
                          else torch.from_numpy(s0).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,T,H,P,N,chunk,kw", [
    (1, 64, 2, 16, 8, 16, {}),
    (2, 128, 4, 32, 16, 32, {}),
    (1, 128, 2, 128, 16, 64, {}),                 # Jamba's head shape
    (2, 512, 16, 128, 16, 64, dict(broadcast=True)),  # Jamba's prefill, cut
    (2, 64, 8, 32, 8, 64, dict(broadcast=True)),  # the smoke preset's
    (1, 96, 2, 128, 16, 48, {}),                  # C < 64, not a power of two
    (1, 8, 2, 16, 8, 1, {}),                      # C = 1
    (1, 128, 2, 32, 16, 32, dict(a_lo=1e-4, a_hi=2e-4)),  # strong decay
    (1, 128, 2, 32, 16, 64, dict(a_lo=0.999, a_hi=1.0)),  # decay near 1
    (2, 64, 2, 128, 8, 64, dict(state=False)),    # no incoming state
    (1, 128, 2, 32, 16, 32, dict(a_lo=1.0, a_hi=1.0)),    # a = 1
    (2, 128, 4, 128, 16, 64, dict(a_lo=1.0, a_hi=1.0, broadcast=True)),
], ids=["sweep-p16", "sweep-p32", "p128", "jamba-broadcast", "smoke",
        "c48", "c1", "strong-decay", "near-one", "no-state", "a-one",
        "a-one-broadcast"])
def test_ssd_kernel_matches_plain_version(cuda_device, dtype, B, T, H, P, N,
                                          chunk, kw):
    from repro_torch.kernels import ssd as kernel

    x, a, Bm, Cm, s0 = _ssd_inputs(B, T, H, P, N, dtype, cuda_device, **kw)
    before = kernel.launches
    y, s = ops.ssd(x, a, Bm, Cm, s0, chunk=chunk)
    assert kernel.launches == before + 1
    y_want, s_want = ref.ssd_chunked_ref(x, a, Bm, Cm, s0, chunk=chunk)
    torch.cuda.synchronize()
    assert y.dtype == dtype and tuple(y.shape) == (B, T, H, P)
    assert s.dtype == torch.float32 and tuple(s.shape) == (B, H, N, P)
    assert torch.isfinite(y.float()).all() and torch.isfinite(s).all()
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               y_want.float().cpu().numpy(), **SSD_TOL[dtype])
    np.testing.assert_allclose(s.cpu().numpy(), s_want.cpu().numpy(),
                               **SSD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,P,N,chunk,kw", [
    (1, 128, 2, 32, 16, 32, {}),
    (1, 128, 2, 128, 8, 64, {}),
    (2, 128, 4, 128, 16, 64, dict(broadcast=True)),
    (1, 128, 2, 128, 16, 16, dict(a_lo=1.0, a_hi=1.0)),
    (1, 96, 2, 16, 16, 48, dict(state=False)),
], ids=["p32", "n8", "broadcast", "a-one-c16", "p16-c48"])
def test_ssd_kernel_holds_cancelling_products(cuda_device, B, T, H, P, N,
                                              chunk, kw):
    """|x|, |B|, |C| ~ 100 in bf16: sums of large terms that cancel, where
    the bf16 tolerance is relative (the atol is negligible).  The kernel's
    fp32 operands enter the tensor cores as three bf16 terms each; two
    terms fail here (``ssd.mma_model(split=2)`` on the CPU).  Where terms
    of ~1e6 cancel to ~1e2, one ulp of one fp32 log moves y by more than
    the tolerance, so each entry must lie within it of the plain version
    or, where that is further off, of the recurrence in float64.  fp32
    inputs are not held at this scale: fp32's rtol 1e-4 is below the fp32
    plain version's own distance from exact arithmetic on such entries."""
    x = _ssd_inputs(B, T, H, P, N, torch.bfloat16, cuda_device, scale=100.0,
                    **kw)
    y, s = ops.ssd(*x, chunk=chunk)
    want = ref.ssd_chunked_ref(*x, chunk=chunk)
    torch.cuda.synchronize()
    xd = [v.double() if v is not None else None for v in x]
    S = xd[4] if xd[4] is not None else torch.zeros(
        (B, H, N, P), dtype=torch.float64, device=cuda_device)
    ys = []
    for t in range(T):
        S = xd[1][:, t, :, None, None] * S + \
            xd[2][:, t, :, :, None] * xd[0][:, t, :, None, :]
        ys.append(torch.einsum("bhn,bhnp->bhp", xd[3][:, t], S))
    rtol, atol = (SSD_TOL[torch.bfloat16][k] for k in ("rtol", "atol"))
    for got, plain, exact in zip((y, s), want, (torch.stack(ys, 1), S)):
        got, plain = got.double(), plain.double()
        off = ((got - plain).abs() > atol + rtol * plain.abs()) & \
            ((got - exact).abs() > atol + rtol * exact.abs())
        assert torch.isfinite(got).all() and not off.any(), int(off.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_ssd_kernel_repeats_give_the_same_bits(cuda_device, dtype):
    """No atomics: three calls on the same inputs, the same y and state."""
    x = _ssd_inputs(4, 256, 8, 128, 16, dtype, cuda_device, seed=6,
                    broadcast=True)
    outs = [ops.ssd(*x, chunk=64) for _ in range(3)]
    for y, s in outs[1:]:
        assert torch.equal(y, outs[0][0]) and torch.equal(s, outs[0][1])


@pytest.mark.cuda
def test_ssd_bf16_instances_run_on_the_tensor_cores(cuda_device):
    """Every bf16 instance (P = 16, 32, 128) of the built library holds
    HMMA (or HGMMA) instructions, by ``cuobjdump -sass``."""
    import re
    import shutil
    import subprocess
    from pathlib import Path

    from repro_torch.kernels import _build

    _build.load("ssd")
    exe = shutil.which("cuobjdump") or str(
        Path(_build.nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([exe, "-sass", str(_build.library_path("ssd"))],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn is not None and re.search(r"\bHG?MMA\b", line):
            counts[fn] += 1
    mma = {f: c for f, c in counts.items() if "ssd_mma_kernel" in f}
    assert len(mma) == 3 and all(c > 0 for c in mma.values()), counts


@pytest.mark.cuda
def test_ssd_kernel_state_in_and_out_may_alias(cuda_device):
    """A layer's cache slice is both the incoming state and the output."""
    x, a, Bm, Cm, s0 = _ssd_inputs(2, 128, 4, 128, 16, torch.bfloat16,
                                   cuda_device, seed=5, broadcast=True)
    y_want, s_want = ops.ssd(x, a, Bm, Cm, s0, chunk=64)
    cache = torch.zeros((3,) + tuple(s0.shape), device=cuda_device)
    cache[1] = s0
    y, s = ops.ssd(x, a, Bm, Cm, cache[1], chunk=64, state_out=cache[1])
    torch.cuda.synchronize()
    assert s.data_ptr() == cache[1].data_ptr()
    assert torch.equal(y, y_want) and torch.equal(cache[1], s_want)
    assert not cache[0].any() and not cache[2].any()


@pytest.mark.cuda
def test_ssd_kernel_reads_broadcast_B_and_C_as_materialized(cuda_device):
    x, a, Bm, Cm, s0 = _ssd_inputs(2, 128, 8, 32, 16, torch.float32,
                                   cuda_device, seed=6, broadcast=True)
    assert Bm.stride(2) == 0
    y, s = ops.ssd(x, a, Bm, Cm, s0, chunk=32)
    y2, s2 = ops.ssd(x, a, Bm.contiguous(), Cm.contiguous(), s0, chunk=32)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(s, s2)


@pytest.mark.cuda
def test_ssd_kernel_takes_unaligned_bf16_views(cuda_device):
    """The bf16 kernel copies x, B and C in 16-byte pieces; a view off that
    grain (x 2 bytes off, B and C rows of N + 1) is copied by the wrapper
    first and gives the same bits as the aligned tensors."""
    x, a, Bm, Cm, s0 = _ssd_inputs(2, 128, 4, 32, 16, torch.bfloat16,
                                   cuda_device, seed=7)
    flat = torch.zeros(x.numel() + 1, dtype=x.dtype, device=cuda_device)
    xo = flat[1:].view(x.shape)
    xo.copy_(x)
    wide = torch.zeros((2, 2, 128, 4, 17), dtype=x.dtype, device=cuda_device)
    wide[0, ..., :16], wide[1, ..., :16] = Bm, Cm
    bo, co = wide[0, ..., :16], wide[1, ..., :16]
    assert xo.data_ptr() % 16 and bo.stride(1) % 8
    y, s = ops.ssd(xo, a, bo, co, s0, chunk=64)
    y2, s2 = ops.ssd(x, a, Bm, Cm, s0, chunk=64)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(s, s2)


@pytest.mark.cuda
def test_ssd_kernel_rejects_what_it_does_not_take(cuda_device):
    from repro_torch.kernels import ssd as kernel

    x, a, Bm, Cm, s0 = _ssd_inputs(1, 64, 2, 32, 16, torch.float32,
                                   cuda_device)
    with pytest.raises(ValueError, match="head dims"):
        x64 = torch.zeros(1, 64, 2, 64, device=cuda_device)
        kernel.ssd(x64, a, Bm, Cm, device=cuda_device)
    with pytest.raises(ValueError, match="state dims"):
        b4 = torch.zeros(1, 64, 2, 4, device=cuda_device)
        kernel.ssd(x, a, b4, b4, device=cuda_device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kernel.ssd(x.half(), a.half(), Bm.half(), Cm.half(),
                   device=cuda_device)
    with pytest.raises(TypeError, match="one dtype"):
        kernel.ssd(x, a.to(torch.bfloat16), Bm, Cm, device=cuda_device)
    with pytest.raises(ValueError, match="chunk"):
        kernel.ssd(x, a, Bm, Cm, chunk=128, device=cuda_device)
    with pytest.raises(ValueError, match="chunk"):
        kernel.ssd(x, a, Bm, Cm, chunk=48, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous x and a"):
        xt = x.transpose(1, 2).contiguous().transpose(1, 2)
        kernel.ssd(xt, a, Bm, Cm, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous last"):
        bt = Bm.transpose(2, 3).contiguous().transpose(2, 3)
        kernel.ssd(x, a, bt, Cm, device=cuda_device)
    with pytest.raises(ValueError, match="a must be"):
        kernel.ssd(x, a[:, :32], Bm, Cm, device=cuda_device)
    with pytest.raises(ValueError, match="state"):
        kernel.ssd(x, a, Bm, Cm, s0[:, :1], device=cuda_device)
    with pytest.raises(ValueError, match="state_out"):
        kernel.ssd(x, a, Bm, Cm, s0, state_out=s0.to(torch.bfloat16),
                   device=cuda_device)
    with pytest.raises(ValueError, match="expected the CUDA device"):
        kernel.ssd(x.cpu(), a, Bm, Cm, device=cuda_device)
    before = kernel.launches
    kernel.ssd(x, a, Bm, Cm, s0, chunk=16, device=cuda_device)
    kernel.ssd(x, a, Bm, Cm, chunk=64, device=cuda_device)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2


# ---------------------------------------------------------------------------
# the rest of the LM zoo (MoELM, WhisperLM, InternVLM) and PAL at LM scale
# ---------------------------------------------------------------------------

LM_ZOO_ARCHS = ["qwen2-moe-a2.7b", "whisper-small", "internvl2-2b"]


def _zoo_model(arch, layers=2, **kw):
    """``arch`` at ``launch/serve.py``'s smoke widths with heads of 64 (a
    head dim of the kernel's), ``layers`` layers (and encoder layers),
    fp32; the MoE groups with room for every choice."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import reduced_config
    from repro_torch.models import model_zoo

    cfg = reduced_config(get_arch(arch).model, "smoke").replace(
        num_layers=layers, head_dim=64, **kw)
    if cfg.family == "encdec":
        cfg = cfg.replace(encoder_layers=layers)
    if cfg.family == "moe":
        cfg = cfg.replace(moe_capacity_factor=8.0)
    return cfg, model_zoo.build_model(cfg, max_seq=64)


def _zoo_extras(cfg, B, device, seed=3):
    rng = np.random.RandomState(seed)
    if cfg.family == "encdec":
        return {"enc_embeds": torch.from_numpy((rng.randn(
            B, cfg.encoder_seq, cfg.d_model) * 0.02).astype(np.float32)).to(
                device)}
    if cfg.family == "vlm":
        return {"patch_embeds": torch.from_numpy((rng.randn(
            B, cfg.vision_tokens, cfg.d_model) * 0.02).astype(
                np.float32)).to(device)}
    return {}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", LM_ZOO_ARCHS)
def test_lm_zoo_card_matches_cpu(cuda_device, arch):
    """2 fp32 layers: prefill (with frame / patch embeddings) and 4 decode
    steps teacher-forced with the card's greedy tokens, the card's kernel
    path against the CPU's plain path on the same weights (rtol = atol =
    1e-3, as chip_smoke's card-vs-CPU phase)."""
    from repro_torch.core.committee import tree_map

    cfg, m = _zoo_model(arch)
    n_prefix = cfg.vision_tokens if cfg.family == "vlm" else 0
    B, P = 2, 24
    params = m.init(torch.Generator(device=cuda_device).manual_seed(0),
                    device=cuda_device)
    params_c = tree_map(lambda t: t.cpu(), params)
    tok = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (B, P)).astype(np.int32))
    toks, outs = [], {}                   # toks: the card's greedy ones
    for dev, p in ((cuda_device, params), (torch.device("cpu"), params_c)):
        cache = m.init_cache(B, n_prefix + P + 8, device=dev)
        logits, cache = m.prefill(p, tok.to(dev), cache,
                                  **_zoo_extras(cfg, B, dev))
        seq = [logits.float().cpu()]
        for i in range(4):
            if dev.type == "cuda":
                toks.append(torch.argmax(seq[-1], -1).to(torch.int32))
            logits, cache = m.decode_step(p, toks[i][:, None].to(dev), cache,
                                          n_prefix + P + i)
            seq.append(logits.float().cpu())
        outs[dev.type] = torch.stack(seq, 1)
    np.testing.assert_allclose(outs["cuda"].numpy(), outs["cpu"].numpy(),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", LM_ZOO_ARCHS)
def test_lm_zoo_generate_launches_flash_exactly(cuda_device, arch):
    """One ``ServeEngine.generate`` of 6 new tokens at 2 bf16 layers, after
    a first one that captured the engine's graphs (its warm-up runs launch
    the kernels eagerly): the tiled path once per attention call of the
    prefill (Whisper: its encoder, decoder self and cross calls), the split
    path once per call of each of the 5 decode steps, counted by replay."""
    from repro_torch.kernels import flash_attention as kernel
    from repro_torch.serving import ServeEngine

    cfg, m = _zoo_model(arch, dtype="bfloat16")
    L = cfg.num_layers
    want = {"moe": (L, 5 * L), "encdec": (cfg.encoder_layers + 2 * L,
                                          5 * 2 * L),
            "vlm": (L, 5 * L)}[cfg.family]
    params = m.init(torch.Generator(device=cuda_device).manual_seed(0),
                    device=cuda_device)
    eng = ServeEngine(m, params, max_seq=64, batch=8, device=cuda_device)
    batch = {"tokens": np.random.RandomState(2).randint(
        0, cfg.vocab_size, (8, 16)).astype(np.int32),
        **{k: v.cpu().numpy() for k, v in _zoo_extras(cfg, 8, "cpu").items()}}
    eng.generate(batch, max_new_tokens=6)
    before = (kernel.launches, kernel.launches_tiled, kernel.launches_split)
    res = eng.generate(batch, max_new_tokens=6)
    after = (kernel.launches, kernel.launches_tiled, kernel.launches_split)
    assert (after[1] - before[1], after[2] - before[2]) == want
    assert after[0] - before[0] == sum(want)
    assert res.tokens.shape == (8, 22)
    assert (res.tokens >= 0).all() and (res.tokens < cfg.padded_vocab).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,T,S,kv_len", [
    (2, 1500, 1500, None),            # the encoder: S = 1500, H = KV = 12
    (2, 64, 1500, None),              # cross-attention in the prefill
    (4, 1, 1500, None),               # cross-attention in a decode step
    (4, 1, 448, [65, 100, 300, 448]),  # decoder self-attention, 448 slots
], ids=["encoder", "cross-prefill", "cross-decode", "self-decode"])
def test_flash_attention_whisper_shapes_match_plain_version(
        cuda_device, dtype, B, T, S, kv_len):
    """Whisper-small's calls (H = KV = 12, D = 64): non-causal over 1500
    frames with T != S on both paths, and the decoder's own decode."""
    from repro_torch.kernels import flash_attention as kernel

    rng = np.random.RandomState(13)
    q, k, v = (torch.from_numpy(rng.randn(*s).astype(np.float32)).to(
        cuda_device, dtype) for s in ((B, T, 12, 64), (B, S, 12, 64),
                                      (B, S, 12, 64)))
    kw = dict(causal=False)
    if kv_len is not None:
        kw.update(q_offset=S - 1, kv_len=torch.tensor(
            kv_len, dtype=torch.int32, device=cuda_device))
    path = kernel.plan(B, T, S, 12, 12).path
    assert path == ("split" if T == 1 else "tiled")
    before = (kernel.launches_tiled, kernel.launches_split)
    got = ops.attention(q, k, v, **kw)
    step = (kernel.launches_tiled - before[0],
            kernel.launches_split - before[1])
    assert step == ((1, 0) if path == "tiled" else (0, 1))
    want = ref.attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               rtol=FA_TOL[dtype], atol=FA_TOL[dtype])


# ---------------------------------------------------------------------------
# the four archs served last: danube, minicpm, nemo, qwen3-moe
# ---------------------------------------------------------------------------

ZOO_REST_FA_CASES = {
    # danube's d120 with a window that binds: T = S past it (the tiled
    # prefill), and one token past it through the device-offset entry
    "d120-window-prefill": ((2, 600, 600, 8, 2, 120), dict(
        causal=True, window=256), "tiled"),
    "d120-window-decode": ((4, 1, 600, 8, 2, 120), dict(
        causal=False, window=256, kv_len=[257, 300, 599, 600]), "split"),
    # qwen3-moe's G = 16: one decode token is 16 (t, g) rows a kv head,
    # past the split kernel's 8, so the device-offset decode runs tiled
    "g16-decode": ((4, 1, 576, 64, 4, 128), dict(
        causal=False, kv_len=[0, 1, 300, 576]), "tiled"),
    # minicpm's 36 MHA heads on the split path
    "mha36-decode": ((4, 1, 576, 36, 36, 64), dict(
        causal=False, kv_len=[1, 64, 300, 576]), "split"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(ZOO_REST_FA_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_flash_attention_zoo_rest_shapes_match_plain_version(
        cuda_device, dtype, case):
    """The four archs' new kernel cases, each on its path by the counts;
    the decodes through ``flash_attention_decode`` (a tensor ``q_offset``,
    each row at ``kv_len[b] - T``)."""
    from repro_torch.kernels import flash_attention as kernel

    (B, T, S, H, KV, D), kw, path = ZOO_REST_FA_CASES[case]
    assert kernel.plan(B, T, S, H, KV).path == path
    rng = np.random.RandomState(14)
    q, k, v = (torch.from_numpy(rng.randn(*s).astype(np.float32)).to(
        cuda_device, dtype) for s in ((B, T, H, D), (B, S, KV, D),
                                      (B, S, KV, D)))
    kw = dict(kw)
    if "kv_len" in kw:
        kw["kv_len"] = torch.tensor(kw["kv_len"], dtype=torch.int32,
                                    device=cuda_device)
        kw["q_offset"] = kw["kv_len"] - T
    before = (kernel.launches_tiled, kernel.launches_split)
    got = ops.attention(q, k, v, **kw)
    step = (kernel.launches_tiled - before[0],
            kernel.launches_split - before[1])
    assert step == ((1, 0) if path == "tiled" else (0, 1))
    want = ref.attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               rtol=FA_TOL[dtype], atol=FA_TOL[dtype])


def _zoo_rest_model(arch, **kw):
    """``arch`` at its small config (``_zoo_rest``), ``kw`` on top."""
    from _zoo_rest import small
    from repro_torch.configs import get_arch
    from repro_torch.models import model_zoo

    cfg = small(get_arch(arch).model, arch, **kw)
    return cfg, model_zoo.build_model(cfg, max_seq=64)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "minicpm-2b",
                                  "mistral-nemo-12b", "qwen3-moe-235b-a22b"])
def test_zoo_rest_card_matches_cpu(cuda_device, arch):
    """2 fp32 layers at the small config: prefill of 40 tokens (past
    danube's window of 16) and 8 decode steps teacher-forced with the
    card's greedy tokens, the card's kernel path against the CPU's plain
    path on the same weights (rtol = atol = 1e-3, as chip_smoke's
    card-vs-CPU phase)."""
    from _zoo_rest import PROMPT, STEPS
    from repro_torch.core.committee import tree_map

    cfg, m = _zoo_rest_model(arch)
    B = 2
    params = m.init(torch.Generator(device=cuda_device).manual_seed(0),
                    device=cuda_device)
    params_c = tree_map(lambda t: t.cpu(), params)
    tok = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (B, PROMPT)).astype(np.int32))
    toks, outs = [], {}                   # toks: the card's greedy ones
    for dev, p in ((cuda_device, params), (torch.device("cpu"), params_c)):
        cache = m.init_cache(B, PROMPT + STEPS, device=dev)
        logits, cache = m.prefill(p, tok.to(dev), cache)
        seq = [logits.float().cpu()]
        for i in range(STEPS):
            if dev.type == "cuda":
                toks.append(torch.argmax(seq[-1], -1).to(torch.int32))
            logits, cache = m.decode_step(p, toks[i][:, None].to(dev), cache,
                                          PROMPT + i)
            seq.append(logits.float().cpu())
        outs[dev.type] = torch.stack(seq, 1)
    assert outs["cuda"].shape == (B, STEPS + 1, cfg.padded_vocab)
    np.testing.assert_allclose(outs["cuda"].numpy(), outs["cpu"].numpy(),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "minicpm-2b",
                                  "mistral-nemo-12b", "qwen3-moe-235b-a22b"])
def test_zoo_rest_generate_launches_flash_exactly(cuda_device, arch):
    """One ``ServeEngine.generate`` of 6 new tokens at 2 bf16 layers after a
    first one that captured the graphs: one tiled launch per layer in the
    prefill and one launch per layer per decode step, split where G <= 8
    and tiled for qwen3-moe's G = 16, counted by replay."""
    from _zoo_rest import PROMPT
    from repro_torch.kernels import flash_attention as kernel
    from repro_torch.serving import ServeEngine

    cfg, m = _zoo_rest_model(arch, dtype="bfloat16")
    L = cfg.num_layers
    want = (6 * L, 0) if cfg.num_heads // cfg.num_kv_heads > 8 else (L, 5 * L)
    params = m.init(torch.Generator(device=cuda_device).manual_seed(0),
                    device=cuda_device)
    eng = ServeEngine(m, params, max_seq=64, batch=8, device=cuda_device)
    batch = {"tokens": np.random.RandomState(2).randint(
        0, cfg.vocab_size, (8, PROMPT)).astype(np.int32)}
    eng.generate(batch, max_new_tokens=6)
    before = (kernel.launches, kernel.launches_tiled, kernel.launches_split)
    res = eng.generate(batch, max_new_tokens=6)
    after = (kernel.launches, kernel.launches_tiled, kernel.launches_split)
    assert (after[1] - before[1], after[2] - before[2]) == want
    assert after[0] - before[0] == sum(want)
    assert res.tokens.shape == (8, PROMPT + 6)
    assert (res.tokens >= 0).all() and (res.tokens < cfg.padded_vocab).all()


@pytest.mark.cuda
def test_lm_distill_short_run_on_the_card(cuda_device):
    """The lm_active_distill twin on the card until 24 labels: every
    student-engine dispatch one replay (committee_uq launches == dispatches
    + 2 per in-run capture), the teacher's attention through the flash
    kernel (launches == (teacher forwards + the 2 warm-up runs of each
    worker's capture) x 4 layers, the forwards counted by replay), no
    crash, and the engine holding the trainer's weights bit for bit."""
    import tempfile

    from repro_torch.examples import lm_active_distill as distill
    from repro_torch.kernels import committee_uq as cuq
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.core.committee import tree_leaves

    with tempfile.TemporaryDirectory() as tmp:
        pal = distill.make_pal(tmp, cuda_device)
        c0, f0 = cuq.launches, fa.launches
        stopped_by, _ = distill.run_until(pal, timeout=60.0, target=24)
        rep = pal.report()
        eng = pal.engine
        assert stopped_by == "labels" and rep["labeled_total"] >= 24
        assert rep["counters"].get("runtime.thread_crashes", 0) == 0
        assert cuq.launches - c0 == eng.dispatches + 2 * len(
            eng.trace_counts)
        forwards = pal.monitor.timer("oracle.run_calc").count
        captures = sum(o.captures for o in pal._oracle_instances.values())
        assert forwards > 0 and 1 <= captures <= 2
        assert fa.launches - f0 == 4 * (forwards + 2 * captures)
        assert all(v == 1 for v in eng.trace_counts.values())
        if pal.committee_trainer.steps_done:
            snap = pal.committee_trainer.snapshot_cparams()
            for a, b in zip(tree_leaves(eng.cparams), tree_leaves(snap)):
                assert torch.equal(a, b)
