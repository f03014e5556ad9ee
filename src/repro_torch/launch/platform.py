"""Device selection, reference precision, device provenance, and the
process-level knobs of a multi-process launch.

``resolve_device`` is the one place an entry point turns its ``device=``
argument into a ``torch.device``: CUDA unless the caller names another
device (or pinned the CPU with ``set_platform``), and an error (never a
silent CPU fallback) when CUDA is absent.

The multi-process half is the reference's ``repro/launch/platform.py``
mapped onto ``torch.distributed``, where a mesh is one process per device
(``launch/distributed.py``, ``launch/mesh.py``):

  * ``ensure_host_devices(n)`` — the reference requests n emulated host
    devices through ``XLA_FLAGS`` before JAX starts; here the counterpart of
    n host devices is n local ranks, so the request is recorded (in
    ``REPRO_HOST_DEVICES``, inherited by child processes) for the launcher
    (``distributed.launch_local``).  Like the reference's, it raises on a
    different count once the process group is up;
  * ``set_platform``, ``enable_x64``, ``set_debug_nan`` — the platform the
    entry points default to, float64 as the default dtype, autograd's
    anomaly detection;
  * ``apply_gpu_autotune`` — XLA flags only in the reference; it has no
    counterpart here and does nothing;
  * ``describe`` — provenance, with the process index and count.

Importing this module creates no ``torch.distributed`` state.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import shutil
import subprocess
import threading
from typing import Any, Dict, Optional, Union

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

DeviceLike = Union[str, torch.device, None]

# One CUDA-graph capture at a time in the process, its warm-up included
# (``kernels.graphs.capture`` takes it for every capture of the port).
# The acquisition engine's bucket captures and the committee trainer's step
# capture run in different threads of one PAL run; holding this lock keeps
# one thread's first-use work (the kernel library's load, cuBLAS
# initialisation) out of the middle of another thread's capture.
capture_lock = threading.Lock()


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` -> a concrete ``torch.device``.

    ``None`` means the CUDA device (the CPU after ``set_platform("cpu")``);
    a CUDA device without an index is pinned
    to the current one, so devices of tensors and engines compare equal.
    Raises ``RuntimeError`` when CUDA is asked for (or implied) and absent —
    the CPU is used only when the caller passes ``device="cpu"``."""
    if device is None:
        device = "cpu" if os.environ.get(_PLATFORM_ENV) == "cpu" else "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def set_reference_precision() -> None:
    """Full fp32 for matmuls and convolutions (TF32 off): the precision the
    port is held to against the JAX reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def nvidia_smi() -> Optional[str]:
    """``name, power.limit`` of every card as ``nvidia-smi`` reports them,
    or None when the tool is missing."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=False)
    return out.stdout.strip() if out.returncode == 0 else None


# ---------------------------------------------------------------------------
# Process-level knobs of a multi-process launch
# ---------------------------------------------------------------------------

_HOST_DEV_ENV = "REPRO_HOST_DEVICES"
_PLATFORM_ENV = "REPRO_PLATFORM"


def backend_initialized() -> bool:
    """Whether this process has joined a ``torch.distributed`` process
    group — the point after which the local rank count is fixed."""
    return dist.is_available() and dist.is_initialized()


def requested_host_devices() -> Optional[int]:
    """The local rank count requested by ``ensure_host_devices`` (None when
    none was)."""
    v = os.environ.get(_HOST_DEV_ENV, "")
    return int(v) if v else None


def ensure_host_devices(n: int) -> int:
    """Idempotently request ``n`` local ranks — the counterpart of the
    reference's n emulated host devices.  Re-requesting the current count
    is a no-op; a different count is recorded while no process group is up
    and raises once one is (the world size is fixed then: silently keeping
    the old count is how "works at 1x1 only" bugs hide).  Returns n."""
    n = int(n)
    if n <= 0:
        raise ValueError(f"ensure_host_devices: need n >= 1, got {n}")
    current = requested_host_devices()
    if current == n:
        return n
    if backend_initialized():
        raise RuntimeError(
            f"ensure_host_devices({n}): the process group is already "
            f"initialized (current request: {current}); the local rank "
            "count can only be set before the ranks are launched")
    os.environ[_HOST_DEV_ENV] = str(n)
    return n


def apply_gpu_autotune() -> None:
    """No counterpart: in the reference this appends XLA's GPU autotune
    flags (Triton fusions, async collectives, latency-hiding scheduling),
    which configure a compiler the port does not use.  Logs and returns."""
    log.info("apply_gpu_autotune: XLA flags have no counterpart in the "
             "PyTorch port; nothing to do")


def set_platform(platform: str) -> None:
    """Pin the device the entry points default to: 'cpu', or 'gpu'/'cuda'
    (the CUDA device, the default).  Raises once the process group is up
    (its backend follows the device)."""
    platform = str(platform).lower()
    if platform not in ("cpu", "gpu", "cuda"):
        raise ValueError(f"set_platform: unknown platform {platform!r}")
    if backend_initialized():
        raise RuntimeError(
            f"set_platform({platform!r}): the process group is already "
            "initialized")
    os.environ[_PLATFORM_ENV] = "cpu" if platform == "cpu" else "cuda"


def enable_x64(flag: bool = True) -> None:
    """float64 (or back to float32) as torch's default floating dtype."""
    torch.set_default_dtype(torch.float64 if flag else torch.float32)


def set_debug_nan(flag: bool = True) -> None:
    """Toggle autograd's anomaly detection (NaN checks in backward) — a
    debugging aid, never for production loops (it slows every op)."""
    torch.autograd.set_detect_anomaly(bool(flag))


@dataclasses.dataclass(frozen=True)
class PlatformConfig:
    """Declarative bundle of the process-level knobs (``PALRunConfig``
    carries the same fields; ``configure`` applies them in order).  Zero
    values mean "leave alone"."""

    platform: str = ""          # '' | 'cpu' | 'gpu' | 'cuda'
    host_devices: int = 0       # >0: local ranks to launch
    x64: bool = False
    debug_nan: bool = False
    gpu_autotune: bool = False


def configure(cfg: Optional[PlatformConfig] = None, **kw: Any
              ) -> PlatformConfig:
    """Apply a ``PlatformConfig`` (or keyword overrides) in the reference's
    order: the rank count first, then the toggles.  Returns the applied
    config."""
    cfg = dataclasses.replace(cfg or PlatformConfig(), **kw)
    if cfg.host_devices > 0:
        ensure_host_devices(cfg.host_devices)
    if cfg.gpu_autotune:
        apply_gpu_autotune()
    if cfg.platform:
        set_platform(cfg.platform)
    if cfg.x64:
        enable_x64(True)
    if cfg.debug_nan:
        set_debug_nan(True)
    return cfg


def configure_from_env(env: Optional[Dict[str, str]] = None
                       ) -> PlatformConfig:
    """Build + apply a ``PlatformConfig`` from ``REPRO_PLATFORM`` /
    ``REPRO_HOST_DEVICES`` / ``REPRO_X64`` / ``REPRO_GPU_AUTOTUNE`` — the
    reference's variables, so one launcher environment serves both
    packages."""
    e = os.environ if env is None else env
    return configure(PlatformConfig(
        platform=e.get(_PLATFORM_ENV, ""),
        host_devices=int(e.get(_HOST_DEV_ENV, "0") or 0),
        x64=e.get("REPRO_X64", "") in ("1", "true"),
        gpu_autotune=e.get("REPRO_GPU_AUTOTUNE", "") in ("1", "true"),
    ))


def describe() -> Dict[str, Any]:
    """Provenance for every measurement: device name, device counts, the
    ``nvidia-smi`` name and power limit, and this process's place in the
    process group (index 0 of 1 without one)."""
    cuda = torch.cuda.is_available()
    up = backend_initialized()
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": torch.cuda.device_count() if cuda else 0,
        "local_device_count": torch.cuda.device_count() if cuda else 1,
        "process_index": dist.get_rank() if up else 0,
        "process_count": dist.get_world_size() if up else 1,
        "host_devices": requested_host_devices() or 0,
        "nvidia_smi": nvidia_smi(),
    }
