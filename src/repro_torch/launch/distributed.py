"""Multi-process launch path: one run spanning processes over
``torch.distributed`` — the reference's ``repro/launch/distributed.py``
(``jax.distributed``) mapped onto process groups.

In the reference a process is more devices in one SPMD program.  Here every
process is one rank with one device: each rank calls :func:`initialize`
(coordinator address, process count and id), after which the meshes of
``launch/mesh.py`` span the ranks and the mesh paths (``FusedEngine``,
``CommitteeTrainer``, sequence-sharded decode attention) run the same
program on every rank, exchanging what they must with collectives.  Every
rank is given the same global inputs, as the reference's ``device_put`` of
a host array under ``jax.distributed`` requires of every process.

The backend is NCCL when the rank's device is CUDA and ``cpu_collectives``
(gloo) otherwise; ``backend="gloo"`` asks for gloo on the card too (several
ranks sharing one card, which NCCL refuses), with CUDA tensors staged
through host memory by the mesh's collectives.

Order of operations in a launcher::

    from repro_torch.launch import distributed, platform
    platform.configure(host_devices=cfg.host_devices)
    distributed.initialize_from_config(cfg)             # before any mesh
    mesh = make_scaleout_mesh()                         # spans all ranks

``launch_local(n, target, *args)`` spawns n local ranks on this host (the
counterpart of the reference's ``host_devices=n``) and returns each rank's
``target(*args)``.

CLI (one process of a multi-process launch; also the smoke worker)::

    python -m repro_torch.launch.distributed --coordinator 127.0.0.1:9911 \\
        --processes 2 --process-id 0 --demo
"""
from __future__ import annotations

import argparse
import datetime
import logging
import multiprocessing as mp
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

_initialized = False
TIMEOUT = datetime.timedelta(seconds=300)   # a collective waits this long


def is_initialized() -> bool:
    return _initialized


_device: Optional[torch.device] = None


def device() -> torch.device:
    """The device this rank joined with (``default_device_for(0)`` before
    it joined)."""
    return _device if _device is not None else default_device_for(0)


def default_device_for(rank: int) -> torch.device:
    """A rank's device: ``cuda:(local rank % cards)`` where there is a card
    (the local rank from ``LOCAL_RANK``, else ``rank``), the CPU
    otherwise."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def _join(init_method: str, num_processes: int, process_id: int,
          backend: str, device: torch.device) -> None:
    global _initialized, _device
    if _initialized or dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized in "
                           "this process")
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(num_processes),
                            rank=int(process_id), timeout=TIMEOUT)
    _initialized, _device = True, device
    log.info("torch.distributed up: rank %d/%d on %s (%s)", dist.get_rank(),
             dist.get_world_size(), device, backend)


def initialize(coordinator: str, num_processes: int, process_id: int,
               *, cpu_collectives: str = "gloo", device=None,
               backend: Optional[str] = None) -> None:
    """Join this process to a multi-process run as rank ``process_id`` of
    ``num_processes``.

    ``coordinator`` is ``'host:port'`` of process 0, which hosts the TCP
    store (no external launcher needed).  ``device`` is the rank's device
    (default: ``default_device_for(process_id)``).  ``backend`` defaults to NCCL on a
    CUDA device and ``cpu_collectives`` otherwise.  A second call in one
    process raises (a process group cannot be re-initialized)."""
    if device is None:
        device = default_device_for(int(process_id))
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else cpu_collectives
    _join(f"tcp://{coordinator}", num_processes, process_id, backend,
          device)


def control_group(ranks, timeout: datetime.timedelta):
    """A gloo group over ``ranks`` for small host messages (CPU tensors),
    whatever the backend of the data's collectives, whose operations wait
    at most ``timeout``.  Every rank of the process group must make the
    same control groups in the same order (``new_group`` is collective)."""
    return dist.new_group([int(r) for r in ranks], timeout=timeout,
                          backend="gloo")


def shutdown() -> None:
    """Leave the process group (a no-op when not initialized)."""
    global _initialized, _device
    if dist.is_initialized():
        from repro_torch.launch import mesh as mesh_mod

        mesh_mod.clear_cache()
        dist.destroy_process_group()
    _initialized, _device = False, None


def _env_process_id() -> int:
    for var in ("PAL_PROCESS_ID", "JAX_PROCESS_ID"):
        v = os.environ.get(var, "")
        if v:
            return int(v)
    return -1


def initialize_from_config(run_cfg) -> bool:
    """Initialize the multi-process run from ``PALRunConfig`` knobs.

    Returns False (no-op) when ``dist_coordinator`` is empty — the
    single-process path stays the default and costs nothing.  The process
    id comes from ``dist_process_id`` or, when that is -1, the
    ``PAL_PROCESS_ID`` / ``JAX_PROCESS_ID`` env vars (so one config file
    serves every rank of a launch, and both packages).
    """
    coordinator = getattr(run_cfg, "dist_coordinator", "") or ""
    if not coordinator:
        return False
    nproc = int(getattr(run_cfg, "dist_processes", 0))
    if nproc <= 0:
        raise ValueError("dist_coordinator is set but dist_processes is "
                         f"{nproc}; need the total process count")
    pid = int(getattr(run_cfg, "dist_process_id", -1))
    if pid < 0:
        pid = _env_process_id()
    if pid < 0:
        raise ValueError(
            "dist_process_id is -1 and neither PAL_PROCESS_ID nor "
            "JAX_PROCESS_ID is set — every rank needs a distinct id")
    initialize(coordinator, nproc, pid,
               cpu_collectives=getattr(run_cfg, "dist_cpu_collectives",
                                       "gloo"))
    return True


def demo(rows_per_process: int = 4) -> float:
    """Cross-process collective check: every rank builds the same global
    row batch ``arange(rows_per_process * ranks)``, keeps its own rows (the
    BATCH layout of a scale-out mesh over every rank), sums them and
    all-reduces the partial sums — the global sum, the same on every rank.
    A launch whose processes did not join computes per-rank answers and
    fails the caller's check."""
    from repro_torch.configs import base as axes
    from repro_torch.launch.mesh import make_scaleout_mesh
    from repro_torch.sharding.rules import MeshRules

    mesh = make_scaleout_mesh()
    n = rows_per_process * mesh.size
    x = torch.arange(n, dtype=torch.float32, device=device())
    rows = MeshRules(mesh).sharding((axes.BATCH,), (n,)).shard(x)
    total = rows.sum().reshape(1)
    return float(mesh.all_reduce_sum(total, ("data",))[0])


# ---------------------------------------------------------------------------
# Local ranks
# ---------------------------------------------------------------------------


def _rank_main(rank: int, world: int, init_method: str, backend: str,
               device: Optional[str], target: Callable, args: tuple,
               results) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    try:
        dev = torch.device(device) if device is not None \
            else default_device_for(rank)
        _join(init_method, world, rank, backend, dev)
        out = target(*args)
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 — reported to the parent
        results.put((rank, False, traceback.format_exc()))
    finally:
        shutdown()


def launch_local(n: int, target: Callable, *args: Any,
                 backend: str = "gloo", device: Optional[str] = None,
                 init_method: Optional[str] = None,
                 timeout: float = 600.0) -> List[Any]:
    """Run ``target(*args)`` on ``n`` local ranks, each a spawned process
    that joins one process group first; returns their results in rank
    order.  ``target`` and ``args`` must be picklable (a module-level
    function).  ``backend`` is the group's backend (gloo by default: it
    serves the CPU and ranks sharing one card); ``device`` the ranks'
    device (default: ``default_device_for(rank)``).  ``init_method``
    defaults to a ``file://`` store in a fresh temporary directory, so
    concurrent launches never race for a port.  Raises ``RuntimeError``
    with the rank's traceback if any rank fails (or exits without a
    result), and kills every rank left when one fails or ``timeout``
    passes.  The caller's main module must guard its own work with
    ``if __name__ == "__main__":`` (the spawned ranks import it)."""
    n = int(n)
    if n < 1:
        raise ValueError(f"launch_local: need n >= 1, got {n}")
    tmp = None
    if init_method is None:
        tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
        init_method = f"file://{os.path.join(tmp, 'store')}"
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    env_if = "GLOO_SOCKET_IFNAME"
    had_if = env_if in os.environ
    if not had_if:                  # local ranks talk over the loopback
        os.environ[env_if] = "lo"
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, init_method, backend, device, target,
                               args, results), daemon=False)
             for r in range(n)]
    started = []
    try:
        for p in procs:
            p.start()
            started.append(p)
        got, failure = {}, None
        deadline = time.monotonic() + timeout
        while len(got) < n and failure is None:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead:            # exited without a result
                    failure = (f"rank {dead[0]} exited with code "
                               f"{procs[dead[0]].exitcode} and no result")
                elif time.monotonic() > deadline:
                    failure = (f"timed out after {timeout} s waiting for "
                               f"{n - len(got)} rank(s)")
                continue
            if ok:
                got[rank] = out
            else:                   # the others may wait on it forever
                failure = f"rank {rank} failed:\n{out}"
        if failure is not None:
            raise RuntimeError("launch_local: " + failure)
        return [got[r] for r in range(n)]
    finally:
        for p in started:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        if not had_if:
            os.environ.pop(env_if, None)
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="one process of a multi-process PAL launch")
    ap.add_argument("--coordinator", required=True,
                    help="host:port of process 0")
    ap.add_argument("--processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, default=-1,
                    help="-1: read PAL_PROCESS_ID / JAX_PROCESS_ID")
    ap.add_argument("--cpu-collectives", default="gloo")
    ap.add_argument("--device", default=None,
                    help="the rank's device (default: its card, else cpu)")
    ap.add_argument("--backend", default=None,
                    help="process-group backend (default: nccl on a card, "
                         "--cpu-collectives on the cpu)")
    ap.add_argument("--demo", action="store_true",
                    help="run the cross-process collective check and print "
                         "'DIST_OK <procs> <devices> <sum>'")
    args = ap.parse_args(argv)

    pid = args.process_id if args.process_id >= 0 else _env_process_id()
    if pid < 0:
        ap.error("--process-id not given and PAL_PROCESS_ID/JAX_PROCESS_ID "
                 "unset")
    initialize(args.coordinator, args.processes, pid,
               cpu_collectives=args.cpu_collectives, device=args.device,
               backend=args.backend)
    try:
        if args.demo:
            total = demo()
            # one device per process: the devices of the launch are its
            # ranks
            print(f"DIST_OK {dist.get_world_size()} {dist.get_world_size()} "
                  f"{total:.1f}", flush=True)
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
