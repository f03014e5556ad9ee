"""The port's multi-process launch (``repro_torch/launch/distributed.py``)
and the multi-process half of ``repro_torch/launch/platform.py``.

Mirrors ``tests/test_distributed.py`` — its four in-process config cases
and the two-process smoke (two OS processes joining one process group over
a TCP coordinator with the gloo backend, printing ``DIST_OK 2 2 28.0``) —
and the port's counterparts of ``tests/test_platform.py``'s cases, where
the counterpart of N emulated host devices is N local ranks.  The
in-process cases that need a process group use a one-rank gloo group on a
``file://`` store under ``tmp_path`` and always leave it.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import pytest
import torch
import torch.distributed as tdist

from repro_torch.launch import distributed as dist
from repro_torch.launch import platform as plat

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("REPRO_HOST_DEVICES", "REPRO_PLATFORM")}
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env.update(extra)
    return env


@pytest.fixture
def clean_env(monkeypatch):
    """The launch variables unset, and restored after the test whatever
    the code under test writes (setenv first records their state: a
    delenv of an absent variable records nothing)."""
    for var in ("REPRO_HOST_DEVICES", "REPRO_PLATFORM", "PAL_PROCESS_ID",
                "JAX_PROCESS_ID"):
        monkeypatch.setenv(var, "")
        monkeypatch.delenv(var)
    return monkeypatch


@pytest.fixture
def one_rank(tmp_path):
    """This process as rank 0 of a one-rank gloo group, left afterwards."""
    dist._join(f"file://{tmp_path / 'store'}", 1, 0, "gloo",
               torch.device("cpu"))
    try:
        yield
    finally:
        dist.shutdown()


# ---------------------------------------------------------------------------
# test_distributed.py
# ---------------------------------------------------------------------------


def test_noop_without_coordinator():
    assert dist.initialize_from_config(
        SimpleNamespace(dist_coordinator="")) is False
    assert not dist.is_initialized()


def test_requires_process_count():
    cfg = SimpleNamespace(dist_coordinator="127.0.0.1:9", dist_processes=0)
    with pytest.raises(ValueError, match="dist_processes"):
        dist.initialize_from_config(cfg)


def test_requires_process_id(clean_env):
    cfg = SimpleNamespace(dist_coordinator="127.0.0.1:9", dist_processes=2,
                          dist_process_id=-1)
    with pytest.raises(ValueError, match="PAL_PROCESS_ID"):
        dist.initialize_from_config(cfg)


def test_env_process_id(clean_env):
    assert dist._env_process_id() == -1
    clean_env.setenv("JAX_PROCESS_ID", "4")
    assert dist._env_process_id() == 4
    clean_env.setenv("PAL_PROCESS_ID", "2")     # PAL_ wins
    assert dist._env_process_id() == 2


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_smoke():
    """Two ranks, one TCP coordinator, one cross-process collective: each
    process sees 2 ranks and both print the same global sum
    (rows_per_process=4 x 2 ranks -> sum(arange(8)) = 28)."""
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.distributed",
             "--coordinator", f"127.0.0.1:{port}", "--processes", "2",
             "--process-id", str(i), "--device", "cpu", "--demo"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env(GLOO_SOCKET_IFNAME="lo"), cwd=REPO)
        for i in range(2)
    ]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed smoke timed out")
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{out}\n{err}"
        assert "DIST_OK 2 2 28.0" in out, f"unexpected output:\n{out}\n{err}"


# ---------------------------------------------------------------------------
# Local ranks (the counterpart of host_devices=n)
# ---------------------------------------------------------------------------


def _rank_facts():
    from repro_torch.launch.mesh import make_scaleout_mesh

    mesh = make_scaleout_mesh()
    d = plat.describe()
    return (tdist.get_rank(), d["process_index"], d["process_count"],
            dict(mesh.shape), dist.demo())


def _fail_on_rank_one():
    if tdist.get_rank() == 1:
        raise ValueError("rank one fails")
    return tdist.get_rank()


def test_launch_local_runs_every_rank_in_order(tmp_path):
    out = dist.launch_local(4, _rank_facts,
                            init_method=f"file://{tmp_path / 'store'}")
    assert [o[0] for o in out] == [0, 1, 2, 3]
    assert [o[1] for o in out] == [0, 1, 2, 3]
    assert all(o[2] == 4 and o[3] == {"data": 4, "model": 1}
               for o in out)
    assert [o[4] for o in out] == [120.0] * 4       # sum(arange(16))


def test_launch_local_raises_with_the_rank_traceback(tmp_path):
    with pytest.raises(RuntimeError, match="(?s)rank 1 failed.*rank one fails"):
        dist.launch_local(2, _fail_on_rank_one,
                          init_method=f"file://{tmp_path / 'store'}",
                          timeout=120)
    with pytest.raises(ValueError):
        dist.launch_local(0, _fail_on_rank_one)


def test_initialize_twice_raises_and_shutdown_leaves(one_rank, tmp_path):
    assert dist.is_initialized() and tdist.get_world_size() == 1
    with pytest.raises(RuntimeError, match="already initialized"):
        dist._join(f"file://{tmp_path / 'other'}", 1, 0, "gloo",
                   torch.device("cpu"))
    # one rank: every mesh is 1x1 and the production mesh does not fit
    from repro_torch.launch.mesh import (make_host_mesh,
                                         make_production_mesh,
                                         make_scaleout_mesh)

    assert make_scaleout_mesh().shape == {"data": 1, "model": 1}
    assert make_host_mesh().device_mesh is not None
    with pytest.raises(ValueError, match="256"):
        make_production_mesh()
    assert dist.demo() == sum(range(4))


# ---------------------------------------------------------------------------
# test_platform.py's counterparts
# ---------------------------------------------------------------------------


def test_requested_host_devices_parses_env(clean_env):
    clean_env.setenv("REPRO_HOST_DEVICES", "12")
    assert plat.requested_host_devices() == 12
    clean_env.delenv("REPRO_HOST_DEVICES")
    assert plat.requested_host_devices() is None


def test_ensure_host_devices_same_count_is_noop(clean_env, one_rank):
    clean_env.setenv("REPRO_HOST_DEVICES", "6")
    assert plat.ensure_host_devices(6) == 6      # even with the group up
    assert os.environ["REPRO_HOST_DEVICES"] == "6"


def test_ensure_host_devices_rejects_bad_count():
    with pytest.raises(ValueError):
        plat.ensure_host_devices(0)
    with pytest.raises(ValueError):
        plat.ensure_host_devices(-3)


def test_ensure_host_devices_raises_once_backend_locked(clean_env,
                                                        one_rank):
    assert plat.backend_initialized()
    clean_env.setenv("REPRO_HOST_DEVICES", "6")
    with pytest.raises(RuntimeError, match="already initialized"):
        plat.ensure_host_devices(3)


def test_ensure_host_devices_records_before_the_group(clean_env):
    assert not plat.backend_initialized()
    assert plat.ensure_host_devices(4) == 4
    assert plat.requested_host_devices() == 4
    assert plat.ensure_host_devices(2) == 2      # rewritten while unlocked


def test_set_platform_validates(clean_env, one_rank):
    with pytest.raises(ValueError):
        plat.set_platform("quantum")
    with pytest.raises(RuntimeError, match="already initialized"):
        plat.set_platform("cpu")


def test_set_platform_cpu_is_the_default_device(clean_env):
    plat.set_platform("cpu")
    assert plat.resolve_device(None) == torch.device("cpu")


def test_apply_gpu_autotune_has_no_counterpart(clean_env):
    before = dict(os.environ)
    assert plat.apply_gpu_autotune() is None
    assert dict(os.environ) == before


def test_configure_from_env_defaults(clean_env):
    cfg = plat.configure_from_env({})
    assert cfg == plat.PlatformConfig()


def test_configure_applies_host_devices(clean_env):
    cfg = plat.configure_from_env({"REPRO_HOST_DEVICES": "6"})
    assert cfg.host_devices == 6
    assert plat.requested_host_devices() == 6


def test_configure_toggles_x64_and_restores(clean_env):
    try:
        plat.configure(x64=True, debug_nan=True)
        assert torch.get_default_dtype() == torch.float64
        assert torch.is_anomaly_enabled()
    finally:
        plat.enable_x64(False)
        plat.set_debug_nan(False)
    assert torch.get_default_dtype() == torch.float32


def test_describe_reports_runtime_facts():
    d = plat.describe()
    for key in ("device", "count", "local_device_count", "process_index",
                "process_count", "host_devices", "nvidia_smi"):
        assert key in d
    assert d["process_index"] == 0 and d["process_count"] == 1


def test_module_import_is_distributed_free():
    # importing the launch modules creates no process group and no mesh
    r = subprocess.run([sys.executable, "-c", textwrap.dedent("""
        import sys
        import torch.distributed as d
        import repro_torch.launch.platform, repro_torch.launch.mesh
        import repro_torch.launch.distributed
        assert not d.is_initialized()
        assert "jax" not in sys.modules
        print("PURE")
    """)], capture_output=True, text=True, env=_env(), cwd=REPO,
        timeout=120)
    assert r.returncode == 0, r.stderr
    assert "PURE" in r.stdout
