"""The port's sharding rules (``repro_torch/sharding/rules.py``) against the
reference's (``repro/sharding/rules.py``).

Mirrors the rule-resolution cases of ``tests/test_sharding_and_potential.py``
(``:32-76``, ``:177``): each case resolves in both packages on the same
abstract mesh shape and must give the same spec and the same fallback
records.  Beyond those: ``committee_shardings``, ``warn_fallbacks`` (the
reference's WARNING text, under ``repro_torch.sharding.rules``),
``NamedSharding``'s rank slices, the pytree forms and ``shard_constraint``
(a layout hint: the value is returned unchanged).
"""
from __future__ import annotations

import logging

import numpy as np
import pytest
import torch

from repro.configs import base as rax
from repro.sharding import rules as rrules
from repro_torch.configs import base as ax
from repro_torch.launch.mesh import Mesh, abstract_mesh, make_host_mesh
from repro_torch.sharding import rules as trules
from repro_torch.sharding.rules import P, MeshRules, merged_rules


class FakeMesh:
    """MeshRules only touches .shape for pspec resolution."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _rules(mesh_shape, overrides=None):
    return MeshRules(FakeMesh(mesh_shape), overrides)


def _both(mesh_shape, overrides, logical, dims, name="?"):
    """The spec and fallbacks of one resolution in both packages."""
    t = MeshRules(FakeMesh(mesh_shape), overrides)
    r = rrules.MeshRules(FakeMesh(mesh_shape), overrides)
    ts, rs = t.pspec(logical, dims, name), r.pspec(logical, dims, name)
    assert tuple(ts) == tuple(rs), (ts, rs)
    assert [(f.dim, f.logical, f.wanted, f.reason, f.chosen)
            for f in t.fallbacks] == \
        [(f.dim, f.logical, f.wanted, f.reason, f.chosen)
         for f in r.fallbacks]
    return ts, t


def test_axis_names_and_default_rules_match_the_reference():
    assert trules.DEFAULT_RULES == rrules.DEFAULT_RULES
    assert all(getattr(ax, n) == getattr(rax, n) for n in (
        "BATCH", "SEQ", "EMBED", "HEADS", "KV_HEADS", "HEAD_DIM", "MLP",
        "VOCAB", "EXPERTS", "EXPERT_MLP", "LAYERS", "STATE", "CONV",
        "COMMITTEE", "CACHE_SEQ", "ENC_SEQ"))


def test_basic_tp_resolution():
    spec, r = _both({"data": 16, "model": 16}, None, (ax.EMBED, ax.MLP),
                    (1024, 4096), "wi")
    assert spec == P(None, "model")
    assert not r.fallbacks


def test_divisibility_fallback_drops_axis():
    # minicpm: 36 heads don't divide 16
    spec, r = _both({"data": 16, "model": 16}, None,
                    (ax.EMBED, ax.HEADS, ax.HEAD_DIM), (2304, 36, 64))
    assert spec == P(None, None, None)
    assert len(r.fallbacks) == 1
    assert "36 % 16" in r.fallbacks[0].reason


def test_mesh_axis_reuse_fallback():
    # seq takes 'model' first; heads then falls back
    spec, r = _both({"data": 16, "model": 16}, {ax.SEQ: ("model",)},
                    (ax.BATCH, ax.SEQ, ax.HEADS, ax.HEAD_DIM),
                    (256, 4096, 32, 128))
    assert spec == P("data", "model", None, None)
    assert any("mesh axis reuse" in f.reason for f in r.fallbacks)


def test_missing_mesh_axis_is_dropped():
    spec, _ = _both({"data": 16, "model": 16}, None, (ax.BATCH, None),
                    (256, 128))
    assert spec == P("data", None)
    spec2, _ = _both({"pod": 2, "data": 16, "model": 16}, None,
                     (ax.BATCH, None), (256, 128))
    assert spec2 == P(("pod", "data"), None)


def test_batch_one_falls_back_unsharded():
    spec, _ = _both({"data": 16, "model": 16}, None,
                    (ax.BATCH, ax.CACHE_SEQ), (1, 524288))
    assert spec == P(None, None)          # default cache_seq unsharded
    spec2, _ = _both({"data": 16, "model": 16}, {ax.CACHE_SEQ: ("data",)},
                     (ax.BATCH, ax.CACHE_SEQ), (1, 524288))
    assert spec2 == P(None, "data")       # long_500k override


def test_merged_rules_override_order():
    rules = merged_rules({ax.EXPERTS: ()}, {ax.EXPERTS: ("model",)})
    assert rules[ax.EXPERTS] == ("model",)
    assert rules == rrules.merged_rules({ax.EXPERTS: ()},
                                        {ax.EXPERTS: ("model",)})


def test_partial_subset_fallback_keeps_usable_axes():
    """('model','data') with 'data' taken degrades to ('model',), not to
    replicated (the jamba dense-FFN 256-way sharding case)."""
    over = {ax.MLP: ("model", "data")}
    spec, _ = _both({"data": 16, "model": 16}, over,
                    (ax.BATCH, None, ax.MLP), (32, 4096, 24576))
    assert spec == P("data", None, "model")
    spec_w, _ = _both({"data": 16, "model": 16}, over, (ax.EMBED, ax.MLP),
                      (8192, 24576))
    assert spec_w == P(None, ("model", "data"))


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (1, 2), (2, 4), (16, 16)])
def test_committee_shardings_match_the_reference(shape):
    """The committee axis over 'model' with the fallback, every other dim
    replicated, on any mesh; a K that does not divide degrades."""
    mesh = {"data": shape[0], "model": shape[1]}
    for k in (3, 4, 8):
        tree = {"w": np.zeros((k, 6, 16), np.float32),
                "b": np.zeros((k, 16), np.float32)}
        t = MeshRules(FakeMesh(mesh))
        r = rrules.MeshRules(FakeMesh(mesh))
        got = trules.committee_shardings(t, tree)
        want = {n: r.pspec((rax.COMMITTEE,) + (None,) * (a.ndim - 1),
                           a.shape, name="cparams")
                for n, a in tree.items()}
        for n in tree:
            assert tuple(got[n].spec) == tuple(want[n])
        split = shape[1] > 1 and k % shape[1] == 0
        assert (got["w"].spec[0] == "model") == (split or shape[1] == 1)
        assert len(t.fallbacks) == len(r.fallbacks)


def test_warn_fallbacks_logs_the_reference_text(caplog):
    r = _rules({"data": 1, "model": 2})
    trules.committee_shardings(r, {"w": torch.zeros(3, 4)})
    with caplog.at_level(logging.WARNING, logger="repro_torch.sharding.rules"):
        mark = trules.warn_fallbacks(r, "FusedEngine")
    assert mark == 1
    (rec,) = caplog.records
    assert rec.name == "repro_torch.sharding.rules"
    assert rec.getMessage() == (
        "FusedEngine: sharding fallback on cparams dim 0 (logical "
        "committee): wanted mesh axes (model) -> using (replicated) "
        "[model: dim 3 % 2 != 0]")
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="repro_torch.sharding.rules"):
        assert trules.warn_fallbacks(r, "FusedEngine", start=mark) == 1
        assert trules.warn_fallbacks(None, "x", start=5) == 5
    assert not caplog.records


def test_named_sharding_gives_each_rank_its_rows():
    """A rank's slice is its row-major index over the spec's axes."""
    mesh = Mesh(np.arange(8).reshape(2, 4), ("data", "model"))
    t = torch.arange(16 * 3).reshape(16, 3)
    sh = trules.NamedSharding(mesh, P(("data", "model"), None))
    assert sh.local_slices((16, 3)) == (slice(0, 2), slice(0, 3))
    assert torch.equal(sh.shard(t), t[:2])
    with pytest.raises(ValueError, match="does not split"):
        sh.local_slices((6, 3))
    # rank 0 of a (4, 2) mesh, rows over 'model' only
    mesh2 = Mesh(np.arange(8).reshape(4, 2), ("data", "model"))
    sh2 = trules.NamedSharding(mesh2, P("model"))
    assert sh2.local_slices((10,)) == (slice(0, 5),)


def test_tree_pspecs_and_logical_helpers():
    r = _rules({"data": 2, "model": 2})
    axes_tree = {"wi": (ax.EMBED, ax.MLP), "x": (ax.BATCH, None)}
    assert r.tree_pspecs(axes_tree) == {"wi": P(None, "model"),
                                        "x": P("data", None)}
    shapes = {"wi": torch.zeros(8, 3), "x": torch.zeros(5, 4)}
    specs = r.tree_pspecs(axes_tree, shapes)
    assert specs == {"wi": P(None, None), "x": P(None, None)}  # 3, 5 odd
    shardings = r.tree_shardings(axes_tree)
    assert shardings["wi"].spec == P(None, "model")
    mesh = FakeMesh({"data": 4, "model": 1})
    assert trules.logical_to_pspec(mesh, (ax.BATCH,)) == P("data")
    assert trules.logical_sharding(mesh, (ax.HEADS,), dims=(8,)).spec == \
        P("model")


def test_shard_constraint_is_a_layout_hint():
    """The value is returned unchanged (the reference's constraint changes
    no value either); an ill-fitting spec is recorded as a fallback."""
    x = torch.randn(3, 5)
    assert trules.shard_constraint(x, None, (ax.BATCH, None)) is x
    r = _rules({"data": 2, "model": 1})
    assert trules.shard_constraint(x, r, (ax.BATCH, None)) is x
    assert len(r.fallbacks) == 1 and "3 % 2" in r.fallbacks[0].reason


def test_meshes_resolve_without_a_process_group():
    """MeshRules reads only the mesh's shape: the production layout
    resolves on an abstract mesh, the host mesh is 1x1."""
    prod = abstract_mesh()
    assert prod.shape == {"data": 16, "model": 16} and prod.size == 256
    assert abstract_mesh(multi_pod=True).shape == \
        {"pod": 2, "data": 16, "model": 16}
    assert MeshRules(prod).pspec((ax.BATCH, ax.HEADS), (256, 32)) == \
        P("data", "model")
    with pytest.raises(ValueError, match="abstract"):
        prod.coordinate()
    host = make_host_mesh()
    assert host.shape == {"data": 1, "model": 1}
    assert host.coordinate() == {"data": 0, "model": 0}
    assert host.device_mesh is None
    x = torch.arange(6.0)
    out, staged = host.all_gather(x, ("data", "model"))
    assert out is x and staged == 0          # size-1 axes: no collective
