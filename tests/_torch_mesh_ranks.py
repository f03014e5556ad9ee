"""The port's mesh-parity cases, run on every rank of a gloo process group
(``launch/distributed.launch_local``) and, with ``mesh=None``, in the test
process as the unsharded answer.  Imports torch and the port only: spawned
ranks never import JAX.

``cases(shape, w)`` runs the cases of ``tests/test_mesh_parity.py`` on a
``make_scaleout_mesh(*shape)`` mesh (``shape=None``: no mesh) from the same
numpy weights and inputs ``w`` on every rank, and returns host numpy
results.  Every rank runs the same calls in the same order (SPMD).
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from repro_torch.configs import base as ax
from repro_torch.configs.pal_potential import PALRunConfig
from repro_torch.core import acquisition as acq
from repro_torch.core.budget import rules_from_config
from repro_torch.core.committee import params_from_numpy
from repro_torch.launch.mesh import make_scaleout_mesh
from repro_torch.sharding.rules import MeshRules

K, D, HID = 4, 6, 16
THRESHOLD = 0.35

# the logical-axis override that splits a KV cache's sequence axis over
# the mesh: the batch replicated, CACHE_SEQ over both axes
KV_RULES = {ax.BATCH: (), ax.CACHE_SEQ: ("data", "model")}


def weights(k: int = K):
    """The reference test's members (numpy), stacked on a leading K."""
    ms = []
    for i in range(k):
        r = np.random.RandomState(i)
        ms.append({"w1": (r.randn(D, HID) * 0.3).astype(np.float32),
                   "w2": (r.randn(HID, D) * 0.3).astype(np.float32)})
    return {n: np.stack([m[n] for m in ms]) for n in ms[0]}


def apply(p, x):
    return torch.tanh(x @ p["w1"]) @ p["w2"]


def _engine(ws, mesh, with_rules=False):
    rules = None
    if with_rules:
        rules = rules_from_config(PALRunConfig(
            std_threshold=THRESHOLD, oracle_budget=0.3,
            reweight_buckets=32))
    return acq.FusedEngine(apply, params_from_numpy(ws, "cpu"), THRESHOLD,
                           rules=rules, mesh=mesh, device="cpu")


def uq(r):
    return tuple(np.asarray(getattr(r, f)).copy() for f in
                 ("mean", "scalar_std", "component_std", "mask"))


def _leaves(state):
    return [np.asarray(a).copy()
            for a in torch.utils._pytree.tree_leaves(state)]


def _trainer(ws, mesh, policy=None, steps=3):
    from repro_torch.training.committee_trainer import CommitteeTrainer

    def loss_fn(params, batch):
        loss = torch.mean((apply(params, batch["x"]) - batch["y"]) ** 2)
        return loss, {"loss": loss}

    rng = np.random.RandomState(6)
    xs = rng.randn(64, D).astype(np.float32)
    ys = rng.randn(64, D).astype(np.float32)
    tr = CommitteeTrainer(loss_fn, params_from_numpy(ws, "cpu"),
                          steps=steps, batch=16, lr=1e-3, bootstrap=True,
                          replay_capacity=128, mesh=mesh, seed=3,
                          device="cpu", memory_policy=policy)
    tr.add_blocks(list(zip(xs, ys)))
    return tr


def _whole(tr):
    return {k: v.numpy().copy()
            for k, v in tr.snapshot_cparams(whole=True).items()}


def score_cases(mesh, ws):
    out = {}
    # 4 advancing rounds with the stateful budget + re-weighting rules
    e = _engine(ws, mesh, with_rules=True)
    rng = np.random.RandomState(1)
    out["score"] = [uq(e.score(list(rng.randn(61, D).astype(np.float32))))
                    for _ in range(4)]
    out["score_state"] = _leaves(e.state_dict())
    out["trace_counts"] = dict(e.trace_counts)
    # the ndarray fast path against the list path, on one engine
    e = _engine(ws, mesh)
    x = np.random.RandomState(2).randn(33, D).astype(np.float32)
    out["fast"] = uq(e.score(x, advance=False))
    out["listed"] = uq(e.score(list(x), advance=False))
    # rule state checkpointed and restored onto a fresh mesh engine
    rng = np.random.RandomState(3)
    a = _engine(ws, mesh, with_rules=True)
    for _ in range(3):
        a.score(list(rng.randn(21, D).astype(np.float32)))
    b = _engine(ws, mesh, with_rules=True)
    b.load_state_dict(a.state_dict())
    xs = rng.randn(19, D).astype(np.float32)
    out["ckpt"] = (uq(a.score(list(xs))), uq(b.score(list(xs))))
    out["ckpt_state"] = (_leaves(a.state_dict()), _leaves(b.state_dict()))
    # host traffic: the unsharded engine's bytes, whatever the mesh
    e = _engine(ws, mesh)
    rng = np.random.RandomState(4)
    for n in (16, 33, 64):
        e.score(rng.randn(n, D).astype(np.float32), advance=False)
    out["bytes"] = (e.bytes_to_device, e.bytes_to_host,
                    e.collective_host_bytes)
    out["members"] = int(e.cparams["w1"].shape[0])
    return out


def fleet_cases(mesh, ws):
    from repro_torch.exploration.fleet import FleetConfig, WalkerFleet

    fc = FleetConfig(sampler="langevin", dt=0.002, noise=0.01, clip=20.0,
                     friction=0.1, patience=3, seed=7)
    x0 = np.random.RandomState(5).randn(24, D).astype(np.float32)
    fl = WalkerFleet(_engine(ws, mesh), x0, fc)
    fl.poison_walker(21)
    steps = []
    for _ in range(4):
        o = fl.step()
        steps.append((o.n_selected, o.selected.copy(),
                      o.mean.numpy().copy()))
    sd = fl.state_dict()
    fl2 = WalkerFleet(_engine(ws, mesh), x0, fc)
    fl2.load_state_dict(sd)
    return {"fleet": steps, "fleet_state": sd,
            "fleet_resumed": (fl.step().mean.numpy().copy(),
                              fl2.step().mean.numpy().copy()),
            "fleet_stats": fl.stats(), "fleet_positions": fl.positions()}


def trainer_cases(mesh, ws):
    out = {}
    t = _trainer(ws, mesh)
    out["train_loss"] = t.train()["loss"]
    out["train_params"] = _whole(t)
    out["train_local"] = int(t.snapshot_cparams()["w1"].shape[0])
    t2 = _trainer(ws, mesh)
    t2.load_state_dict(t.state_dict())
    out["train_resumed"] = (t.train()["loss"], t2.train()["loss"],
                            _whole(t), _whole(t2))
    q = _trainer(ws, mesh, policy="int8", steps=6)
    q.train()
    out["train_int8"] = _leaves(q.state_dict()["cstate"])
    return out


def queue_cases(mesh, ws):
    """Eight 3-row requests through a ServingQueue with max_batch 12: every
    rank composes the same two 12-row microbatches (a dispatch is due only
    at 12 pending rows), so the ranks dispatch in lockstep."""
    from repro_torch.serving.engine import CommitteeServer
    from repro_torch.serving.queue import QueueConfig, ServingQueue

    qc = QueueConfig(max_batch=12, max_wait_ms=60000.0)
    rng = np.random.RandomState(8)
    reqs = [rng.randn(3, D).astype(np.float32) for _ in range(8)]
    e = _engine(ws, mesh)
    with ServingQueue(CommitteeServer(e, device=e.device), qc) as q:
        futs = [q.submit(list(r)) for r in reqs]
        return {"queue": [np.asarray(f.result(timeout=120)[0]).copy()
                          for f in futs]}


def k3_cases(mesh):
    """A K=3 committee on the mesh: the committee axis degrades LOUDLY."""
    records = []

    class Grab(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logger = logging.getLogger("repro_torch.sharding.rules")
    h = Grab(level=logging.WARNING)
    logger.addHandler(h)
    try:
        e = _engine(weights(3), mesh)
    finally:
        logger.removeHandler(h)
    xs = np.random.RandomState(9).randn(32, D).astype(np.float32)
    return {"k3": uq(e.score(xs, advance=False)), "k3_warnings": records}


def attention_cases(mesh, w):
    """Decode attention against a cache split over the mesh
    (``KV_RULES``): this rank's key range in, the whole output out."""
    from repro_torch.kernels import ops

    rules = MeshRules(mesh, KV_RULES)
    q, k, v, kv_len = (torch.from_numpy(w[n]) for n in
                       ("q", "k", "v", "kv_len"))
    s0, s1 = ops.kv_seq_range(rules, q.shape[0], k.shape[1])
    out = {"kv_range": (s0, s1)}
    for name, kw in (("causal", dict(causal=True,
                                     q_offset=int(w["kv_len"].max()) - 1,
                                     kv_len=kv_len)),
                     ("window", dict(causal=True, window=20,
                                     q_offset=k.shape[1] - 1)),
                     ("full", dict(causal=False))):
        out["attn_" + name] = ops.attention(
            q, k[:, s0:s1].contiguous(), v[:, s0:s1].contiguous(),
            kv_seq_shard=True, rules=rules, **kw).numpy()
    return out


def twin_release_cases(mesh):
    """``Mesh.all_gather`` of a few tensors (float32, int32, bool: each
    rank's own) over each set of axes, on ``mesh`` and on a twin of it
    (groups of its own, as a lane's); then the twin's ``release``, twice.
    Returns, per case, both meshes' results and staged bytes, the process
    groups before the twin, with it and after each ``release``, and the
    error a gather on the released twin raised."""
    from torch.distributed import distributed_c10d as c10d

    rank = int(torch.distributed.get_rank())
    gen = torch.Generator().manual_seed(7 + rank)
    tensors = {"f32": torch.randn(4, 3, generator=gen),
               "i32": torch.randint(-9, 9, (2, 2, 2), generator=gen,
                                    dtype=torch.int32),
               "bool": torch.rand(5, generator=gen) > 0.5}
    groups = [len(c10d._world.pg_map)]
    twin = mesh.twin()
    groups.append(len(c10d._world.pg_map))
    out = {}
    for axes in (("data",), ("model",), ("data", "model")):
        for name, t in tensors.items():
            ref, nb = mesh.all_gather(t, axes)
            got, nb_twin = twin.all_gather(t, axes)
            out[(axes, name)] = {"mesh": ref.numpy(), "twin": got.numpy(),
                                 "bytes": [nb, nb_twin]}
    twin.release()
    groups.append(len(c10d._world.pg_map))
    twin.release()
    groups.append(len(c10d._world.pg_map))
    try:
        twin.all_gather(tensors["f32"], tuple(
            a for a in ("data", "model") if twin.shape[a] > 1))
        err = None
    except RuntimeError as e:
        err = str(e)
    return {"gathers": out, "groups": groups, "released_error": err}


def cases(shape, w):
    """Every case on ``make_scaleout_mesh(*shape)`` (None: no mesh)."""
    mesh = make_scaleout_mesh(*shape) if shape is not None else None
    ws = w["ws"]
    out = {}
    out.update(score_cases(mesh, ws))
    out.update(fleet_cases(mesh, ws))
    out.update(trainer_cases(mesh, ws))
    out.update(queue_cases(mesh, ws))
    if mesh is not None:
        out.update(k3_cases(mesh))
        out.update(attention_cases(mesh, w))
        out["twin"] = twin_release_cases(mesh)
        out["resolved"] = {name: dict(acq.resolve_mesh(
            PALRunConfig(uq_mesh=name)).shape)
            for name in ("scaleout", f"{shape[0]}x{shape[1]}")}
    return out
