"""The port's planner (``repro_torch/launch/dryrun.py``) and its stand-ins
(``models/model_zoo.input_specs`` / ``decode_input_specs``,
``models/common.abstract_params`` / ``param_axes``) against the reference.

Mirrors:
  * tests/test_launch_analysis.py:62-79
    (test_make_rules_merges_serve_rules_only_for_serving,
    test_shape_overrides_beat_serve_rules), on the port's abstract mesh;
  * tests/test_memory_policy.py:253-273
    (test_estimate_matches_measured_buffer_bytes,
    test_dryrun_estimate_accounts_for_stacking_and_quantization), against
    the port trainer's live state;
  * the layout half of the reference's ``lower_cell``
    (src/repro/launch/dryrun.py:215-232): ``n_params``, the resident bytes
    per device and the fallbacks recorded for the params, batch, state and
    cache equal the reference's ``make_rules`` + ``MeshRules.pspec`` on the
    FakeMesh pattern of tests/test_launch_analysis.py:57-59, summed as the
    reference sums them, for every arch x shape x {single-pod, multi-pod}.
    No compile: the reference's arithmetic needs none.

Beyond those: the collective rule on a hand-computed two-leaf toy (every
kind; nothing on a 1x1 mesh), the traced FLOPs and resident bytes of a
small step against the real eager step, and the CLI in a subprocess on the
CPU.  The reference's own CLI test
(tests/test_serving_and_dryrun.py::test_dryrun_subprocess_single_cell)
fails under this JAX, so the CLI test here mirrors what it asks.
"""
# The reference's dry-run requests 512 emulated devices when it is
# imported, which must happen before the JAX backend is up.
import repro.launch.dryrun as jdryrun  # noqa: I001

import json
import math
import os
import subprocess
import sys
import tempfile
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree
from jax.sharding import PartitionSpec as JP

from repro.configs import base as rax
from repro.configs import get_arch as jget_arch
from repro.configs import get_shape as jget_shape
from repro.models import common as jcm
from repro.models import model_zoo as jzoo
from repro.optim.adamw import AdamWState as JAdamWState
from repro.optim.adamw import quantize as jquantize
from repro.training import make_train_state as jmake_train_state
from repro.training.train_step import TrainState as JTrainState
from repro_torch.configs import base as ax
from repro_torch.configs import get_arch, get_shape, list_archs
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.core import committee as tcmte
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, abstract_mesh, make_host_mesh
from repro_torch.models import common as cm
from repro_torch.models import model_zoo
from repro_torch.optim.memory_policy import MemoryPolicy
from repro_torch.sharding.rules import MeshRules
from repro_torch.training import CommitteeTrainer, make_train_state
from repro_torch.training import make_train_step

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
MESHES = {False: {"data": 16, "model": 16},
          True: {"pod": 2, "data": 16, "model": 16}}


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


# ---------------------------------------------------------------------------
# make_rules (tests/test_launch_analysis.py:62-79)
# ---------------------------------------------------------------------------


def test_make_rules_merges_serve_rules_only_for_serving():
    spec = get_arch("jamba-1.5-large-398b")
    mesh = abstract_mesh()
    r_train = dryrun.make_rules(spec, get_shape(spec, "train_4k"), mesh)
    r_dec = dryrun.make_rules(spec, get_shape(spec, "decode_32k"), mesh)
    assert r_train.rules["mlp"] == ("model", "data")   # training: 256-way
    assert r_dec.rules["mlp"] == ("model",)            # serving: plain TP


def test_shape_overrides_beat_serve_rules():
    spec = get_arch("jamba-1.5-large-398b")
    r = dryrun.make_rules(spec, get_shape(spec, "long_500k"),
                          abstract_mesh())
    assert r.rules["cache_seq"] == ("data",)   # LONG_500K shape override


# ---------------------------------------------------------------------------
# committee_state_bytes (tests/test_memory_policy.py:253-273)
# ---------------------------------------------------------------------------

K, IN_DIM, HIDDEN, OUT_DIM = 4, 6, 16, 3
POLICIES = ("fp32", "bf16", "int8")


def _members(seed=0, k=K):
    rng = np.random.RandomState(seed)
    return [{
        "w1": torch.from_numpy(rng.randn(IN_DIM, HIDDEN).astype(np.float32)),
        "b1": torch.from_numpy(rng.randn(HIDDEN).astype(np.float32)),
        "w2": torch.from_numpy(rng.randn(HIDDEN, OUT_DIM).astype(np.float32)),
        "b2": torch.from_numpy(rng.randn(OUT_DIM).astype(np.float32)),
    } for _ in range(k)]


def _loss(p, batch):
    pred = torch.tanh(batch["x"] @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
    return torch.mean((pred - batch["y"]) ** 2), {}


@pytest.mark.parametrize("policy", POLICIES)
def test_estimate_matches_measured_buffer_bytes(policy):
    """The planner's committee estimate == the bytes of the stacked state
    the port's trainer holds, for every policy."""
    tr = CommitteeTrainer(_loss, tcmte.stack_members(_members()),
                          memory_policy=policy, device="cpu", steps=10,
                          batch=8, lr=1e-2, replay_capacity=64, seed=0)
    measured = sum(t.numel() * t.element_size()
                   for t in pytree.tree_leaves(tr.cstate))
    est = dryrun.committee_state_bytes(_members(k=1)[0], K,
                                       policy=tr.policy)
    assert est == measured
    assert isinstance(tr.policy, MemoryPolicy)


def test_dryrun_estimate_accounts_for_stacking_and_quantization():
    m = _members(k=1)[0]
    one = dryrun.committee_state_bytes(m, 1)
    assert dryrun.committee_state_bytes(m, 16) == 16 * one          # K-aware
    q = dryrun.committee_state_bytes(
        m, 16, train_cfg=TrainConfig(quantized_opt_state=True))
    assert q == dryrun.committee_state_bytes(m, 16, policy="int8")  # legacy
    assert q < dryrun.committee_state_bytes(m, 16)            # format-aware


# ---------------------------------------------------------------------------
# Resident bytes, n_params and fallbacks against the reference's arithmetic
# ---------------------------------------------------------------------------


def _is_pspec(x):
    return isinstance(x, JP)


def _ref_bytes(sds_tree, pspec_tree, mesh):
    """src/repro/launch/dryrun.py:sharded_bytes_per_device on specs."""
    total = 0
    for sds, spec in zip(jax.tree.leaves(sds_tree),
                         jax.tree.leaves(pspec_tree, is_leaf=_is_pspec)):
        nbytes = int(np.prod(sds.shape)) * np.dtype(sds.dtype).itemsize
        used = 1
        for entry in spec:
            if entry is None:
                continue
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                used *= mesh.shape[a]
        total += nbytes // max(used, 1)
    return total


def _ref_layout(arch, shape_name, multi_pod):
    """The reference's lower_cell up to its report's fallbacks, with
    ``rules.pspec`` where it calls ``rules.sharding`` (same resolution, no
    device mesh)."""
    spec = jget_arch(arch)
    if shape_name in spec.skip_shapes:
        return {"skipped": spec.skip_shapes[shape_name]}
    shape = jget_shape(spec, shape_name)
    mesh = FakeMesh(MESHES[multi_pod])
    rules = jdryrun.make_rules(spec, shape, mesh)
    model = jzoo.build_model(spec.model, rules=rules, max_seq=shape.seq_len)
    specs = model.param_specs()
    p_ps = jax.tree.map(
        lambda s: rules.pspec(s.axes, s.shape, name=str(s.shape)), specs,
        is_leaf=jcm.is_spec)
    if shape.kind == "train":
        p_sds = jdryrun.abstract_tree(specs)
        state_sds = jax.eval_shape(
            lambda p: jmake_train_state(p, spec.train), p_sds)
        repl = rules.pspec((), ())
        m_ps = p_ps
        if spec.train.quantized_opt_state:
            def q_ps(s):
                qt = jax.eval_shape(lambda: jquantize(
                    jax.numpy.zeros(s.shape, jax.numpy.float32)))
                q = rules.pspec(s.axes, qt.q.shape, name="q" + str(s.shape))
                sc = rules.pspec(s.axes if len(s.shape) else (),
                                 qt.scale.shape, name="qs" + str(s.shape))
                return (q, sc)
            m_ps = jax.tree.map(q_ps, specs, is_leaf=jcm.is_spec)
        state_ps = JTrainState(step=repl, params=p_ps,
                               opt=JAdamWState(step=repl, mu=m_ps, nu=m_ps))
        for k, v in jzoo.input_specs(spec.model, shape).items():
            rules.pspec((rax.BATCH,) + (None,) * (len(v.shape) - 1),
                        v.shape, name=k)
        resident = _ref_bytes(state_sds, state_ps, mesh)
    else:
        p_sds = jdryrun.abstract_tree_bf16(specs)
        if shape.kind == "prefill":
            for k, v in jzoo.input_specs(spec.model, shape).items():
                rules.pspec((rax.BATCH,) + (None,) * (len(v.shape) - 1),
                            v.shape, name=k)
        cache_specs = model.cache_specs(shape.global_batch, shape.seq_len)
        c_sds = jdryrun.abstract_tree(cache_specs)
        c_ps = jax.tree.map(
            lambda s: rules.pspec(s.axes, s.shape, name=str(s.shape)),
            cache_specs, is_leaf=jcm.is_spec)
        if shape.kind == "decode":
            rules.pspec((rax.BATCH, None), (shape.global_batch, 1))
        resident = _ref_bytes(p_sds, p_ps, mesh) + _ref_bytes(c_sds, c_ps,
                                                              mesh)
    return {"n_params": jcm.count_params(specs),
            "resident_bytes_per_device": int(resident),
            "fallbacks": [
                f"{f.tensor} dim{f.dim} {f.logical}->{f.wanted}: {f.reason}"
                for f in rules.fallbacks]}


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["singlepod", "multipod"])
@pytest.mark.parametrize("shape_name", SHAPES)
@pytest.mark.parametrize("arch", list_archs())
def test_resident_bytes_and_fallbacks_match_reference(arch, shape_name,
                                                      multi_pod):
    got = dryrun.lower_cell(arch, shape_name, multi_pod=multi_pod,
                            compile_it=False)
    want = _ref_layout(arch, shape_name, multi_pod)
    if "skipped" in want:
        assert got == {"arch": arch, "shape": shape_name,
                       "skipped": want["skipped"]}
        return
    assert got["mesh"] == MESHES[multi_pod]
    for key in ("n_params", "resident_bytes_per_device", "fallbacks"):
        assert got[key] == want[key], key
    assert got["resident_gib_per_device"] == round(
        want["resident_bytes_per_device"] / 2**30, 3)
    assert "traced" not in got


# ---------------------------------------------------------------------------
# Stand-ins: input_specs, decode_input_specs, abstract_params, param_axes
# ---------------------------------------------------------------------------


def _described(tree):
    """{path: (shape, dtype name)} of a jax or torch tree of stand-ins."""
    if isinstance(pytree.tree_leaves(tree)[0], torch.Tensor):
        flat = pytree.tree_flatten_with_path(tree)[0]
    else:
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    out = {}
    for path, leaf in flat:
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        dt = leaf.dtype
        name = str(dt).replace("torch.", "") if isinstance(
            dt, torch.dtype) else np.dtype(dt).name
        out[key] = (tuple(int(s) for s in leaf.shape), name)
    return out


@pytest.mark.parametrize("arch", list_archs())
def test_stand_ins_match_reference(arch):
    spec, jspec = get_arch(arch), jget_arch(arch)
    for shape in spec.shapes:
        jshape = jget_shape(jspec, shape.name)
        model = model_zoo.build_model(spec.model, max_seq=shape.seq_len)
        jmodel = jzoo.build_model(jspec.model, max_seq=shape.seq_len)
        if shape.kind == "decode":
            got = model_zoo.decode_input_specs(spec.model, shape, model)
            want = jzoo.decode_input_specs(jspec.model, jshape, jmodel)
        else:
            got = model_zoo.input_specs(spec.model, shape)
            want = jzoo.input_specs(jspec.model, jshape)
        assert all(t.device.type == "meta" for t in pytree.tree_leaves(got))
        assert _described(got) == _described(want), (arch, shape.name)
    specs, jspecs = model.param_specs(), jmodel.param_specs()
    params = cm.abstract_params(specs)
    assert all(t.device.type == "meta" for t in pytree.tree_leaves(params))
    assert _described(params) == _described(jcm.abstract_params(jspecs))
    got_axes = dict(pytree.tree_flatten_with_path(
        cm.param_axes(specs), is_leaf=lambda x: isinstance(x, tuple))[0])
    want_axes = dict(jax.tree_util.tree_flatten_with_path(
        jcm.param_axes(jspecs), is_leaf=lambda x: isinstance(x, tuple))[0])
    assert [tuple(str(getattr(p, "key", p)) for p in k) for k in got_axes] \
        == [tuple(str(getattr(p, "key", p)) for p in k) for k in want_axes]
    assert list(got_axes.values()) == list(want_axes.values())


# ---------------------------------------------------------------------------
# The collective rule on a toy
# ---------------------------------------------------------------------------


def _toy(mesh_shape):
    """Two leaves on a (data, model) mesh, the batch on data:
    ``w`` (embed, mlp) split over (data, model): FSDP-style on data;
    ``v`` (mlp, None) split over model on its contraction dim: TP."""
    mesh = Mesh(np.arange(math.prod(mesh_shape)).reshape(mesh_shape),
                ("data", "model"), abstract=True)
    rules = MeshRules(mesh, {ax.EMBED: ("data",), ax.MLP: ("model",)})
    specs = {"w": cm.ParamSpec((8, 16), (ax.EMBED, ax.MLP)),
             "v": cm.ParamSpec((16, 8), (ax.MLP, None))}
    return mesh, specs, dryrun.spec_shardings(rules, specs)


def _ten(path, spec):
    return 10


def test_collective_rule_on_a_two_leaf_toy():
    mesh, specs, sh = _toy((2, 4))
    assert tuple(sh["w"].spec) == ("data", "model")
    assert tuple(sh["v"].spec) == ("model", None)
    # training, fp32 params and grads, bf16 activations, 10 tokens a device
    got = dryrun.estimate_collectives(
        specs, sh, mesh, ("data",), train=True, tokens=_ten, act_itemsize=2,
        param_itemsize=4, grad_itemsize=4, seq_gathers=(3, 960.0))
    # w: 8*16*4 / (2*4) = 64 local bytes, gathered over data (G = 2) in
    # the forward and the backward: 2 x 64 x 1; its gradient
    # reduce-scattered over data: 64 x 1.  v: replicated over data (R =
    # 2): all-reduce 2 x 128 x 1/2 = 128; its contraction split over model
    # (T = 4): the (10, 8) bf16 output, 160 bytes, all-reduced forward and
    # backward: 2 x 2 x 160 x 3/4 = 480.  Rule 4: 3 layers x 960.
    assert got == {
        "all-gather": {"count": 2 + 3, "bytes": 128.0 + 3 * 960.0},
        "reduce-scatter": {"count": 1, "bytes": 64.0},
        "all-reduce": {"count": 1 + 2, "bytes": 128.0 + 480.0}}
    # serving: bf16 params, forward only, no gradient
    got = dryrun.estimate_collectives(
        specs, sh, mesh, ("data",), train=False, tokens=_ten, act_itemsize=2,
        param_itemsize=2)
    assert got == {"all-gather": {"count": 1, "bytes": 32.0},
                   "all-reduce": {"count": 1, "bytes": 240.0}}


def test_collective_rule_on_one_device_is_empty():
    mesh, specs, sh = _toy((1, 1))
    for train in (True, False):
        assert dryrun.estimate_collectives(
            specs, sh, mesh, ("data",), train=train, tokens=_ten,
            act_itemsize=2, param_itemsize=4) == {}


def test_kv_partial_gathers_of_a_sequence_sharded_cache():
    """Rule 4: the k cache (layers, batch, cache_seq, kv_heads, head_dim)
    with batch on data and cache_seq on model; kv_heads falls back (model
    taken).  Each rank's partials: 2 rows x 4 query heads x (8 + 2) fp32 =
    320 bytes, gathered from 3 others in each of 3 layers."""
    mesh = Mesh(np.arange(8).reshape(2, 4), ("data", "model"), abstract=True)
    rules = MeshRules(mesh, {ax.CACHE_SEQ: ("model",)})
    axes = (ax.LAYERS, ax.BATCH, ax.CACHE_SEQ, ax.KV_HEADS, ax.HEAD_DIM)
    cache = {"k": cm.ParamSpec((3, 4, 64, 2, 8), axes),
             "v": cm.ParamSpec((3, 4, 64, 2, 8), axes)}
    c_sh = dryrun.spec_shardings(rules, cache)
    assert tuple(c_sh["k"].spec) == (None, "data", "model", None, None)
    cfg = types.SimpleNamespace(num_heads=4, num_kv_heads=2)
    assert dryrun._kv_partial_gathers(cfg, cache, c_sh, mesh) == (3, 960.0)
    host = make_host_mesh()
    h_sh = dryrun.spec_shardings(MeshRules(host, rules.rules), cache)
    assert dryrun._kv_partial_gathers(cfg, cache, h_sh, host) == (0, 0.0)


def test_production_decode_cells_gather_partials_only_when_split():
    """decode_32k of llama splits its cache over model (the arch's
    cache_seq rule): one gather a layer; long_500k of Jamba over data."""
    rep = dryrun.lower_cell("llama3.2-1b", "decode_32k",
                            model_overrides={"num_layers": 1}, device="cpu")
    assert rep["collectives"]["all-gather"]["count"] == 1
    host = dryrun.lower_cell("llama3.2-1b", "decode_32k",
                             mesh=make_host_mesh(),
                             model_overrides={"num_layers": 1},
                             device="cpu")
    assert host["collectives"] == {}
    assert host["collective_bytes_per_device"] == 0.0


# ---------------------------------------------------------------------------
# The trace against a real step
# ---------------------------------------------------------------------------

TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
            vocab_size=256, dtype="float32")


def test_traced_flops_and_resident_bytes_equal_a_real_eager_step():
    """A small llama step planned on the host mesh: the traced FLOPs equal
    ``FlopCounterMode`` around the real eager step on the same shapes (rel
    1e-9), and the resident bytes equal the live state's."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = get_arch("llama3.2-1b").model.replace(**TINY)
    shape = ShapeConfig("lm_train", 32, 2, "train")
    tcfg = TrainConfig()
    rep = dryrun.lower_shape("llama3.2-1b", shape, make_host_mesh(), cfg=cfg,
                             train_cfg=tcfg, device="cpu")
    assert rep["traced"] and rep["device"] == "cpu"
    assert rep["mesh"] == {"data": 1, "model": 1}
    assert rep["collectives"] == {}

    model = model_zoo.build_model(cfg, impl="plain", max_seq=32)
    state = make_train_state(model.init(torch.Generator().manual_seed(0),
                                        device="cpu"), tcfg)
    live = sum(t.numel() * t.element_size()
               for t in pytree.tree_leaves(state))
    assert rep["resident_bytes_per_device"] == live
    step = make_train_step(model_zoo.make_loss_fn(model), tcfg)
    rng = np.random.RandomState(0)
    batch = {k: torch.from_numpy(rng.randint(0, 256, (2, 32)).astype(
        np.int32)) for k in ("tokens", "labels")}
    with FlopCounterMode(display=False) as fc:
        step(state, batch)
    assert rep["flops"] == pytest.approx(fc.get_total_flops(), rel=1e-9)
    assert rep["bytes_accessed"] > 0
    mem = rep["memory"]
    assert mem["argument_size_in_bytes"] == live + 2 * 2 * 32 * 4
    assert mem["output_size_in_bytes"] >= live
    assert mem["temp_size_in_bytes"] >= mem["output_size_in_bytes"]


def test_remat_orders_traced_flops_and_peak():
    """A 2-layer llama training cell (batch 2, seq 256, the widths above)
    traced under each remat policy: the traced FLOPs grow none < dots <
    full (dots recomputes the attention's products, full every product)
    and the peak of live bytes falls none > dots > full (dots keeps the
    projections' outputs, full only each layer's input); the resident
    bytes do not move."""
    shape = ShapeConfig("lm_train", 256, 2, "train")
    reps = {r: dryrun.lower_shape(
        "llama3.2-1b", shape, make_host_mesh(),
        cfg=get_arch("llama3.2-1b").model.replace(**TINY, remat=r),
        train_cfg=TrainConfig(), device="cpu")
        for r in ("none", "dots", "full")}
    flops = [reps[r]["flops"] for r in ("none", "dots", "full")]
    temp = [reps[r]["memory"]["temp_size_in_bytes"]
            for r in ("none", "dots", "full")]
    assert flops[0] < flops[1] < flops[2]
    assert temp[0] > temp[1] > temp[2]
    assert len({reps[r]["resident_bytes_per_device"] for r in reps}) == 1


def test_lower_cell_reports_the_reference_keys():
    rep = dryrun.lower_cell("whisper-small", "decode_32k",
                            model_overrides={"num_layers": 1,
                                             "encoder_layers": 1},
                            device="cpu")
    for key in ("arch", "shape", "mesh", "kind", "n_params", "lower_seconds",
                "resident_bytes_per_device", "resident_gib_per_device",
                "fallbacks", "trace_seconds", "cost", "flops",
                "bytes_accessed", "memory", "collectives",
                "collective_bytes_per_device"):
        assert key in rep, key
    assert rep["traced"] is True and rep["impl"] == "plain"
    assert rep["flops"] > 0 and rep["memory"]["temp_size_in_bytes"] > 0


def test_trace_on_cuda_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.lower_cell("llama3.2-1b", "decode_32k",
                          model_overrides={"num_layers": 1})


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def test_dryrun_cli_single_cell_on_the_cpu():
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "llama3.2-1b", "--shape", "decode_32k", "--out", tmp,
             "--device", "cpu"],
            capture_output=True, text=True, timeout=300, env=env,
            cwd=str(ROOT))
        assert out.returncode == 0, out.stderr[-2000:]
        with open(os.path.join(tmp,
                               "llama3.2-1b_decode_32k_singlepod.json")) as f:
            rep = json.load(f)
        with open(os.path.join(tmp, "summary_singlepod.json")) as f:
            summary = json.load(f)["summary"]
    assert rep["traced"] is True and rep["device"] == "cpu"
    assert rep["mesh"] == {"data": 16, "model": 16}
    assert rep["resident_gib_per_device"] > 0
    assert summary == {"mesh": "singlepod", "n_cells": 1, "ok": 1,
                       "skipped": 0, "failed": 0}
