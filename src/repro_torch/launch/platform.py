"""Device selection, reference precision and device provenance.

``resolve_device`` is the one place an entry point turns its ``device=``
argument into a ``torch.device``: CUDA unless the caller names another
device, and an error (never a silent CPU fallback) when CUDA is absent.
"""
from __future__ import annotations

import shutil
import subprocess
from typing import Any, Dict, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` -> a concrete ``torch.device``.

    ``None`` means the CUDA device; a CUDA device without an index is pinned
    to the current one, so devices of tensors and engines compare equal.
    Raises ``RuntimeError`` when CUDA is asked for (or implied) and absent —
    the CPU is used only when the caller passes ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
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


def describe() -> Dict[str, Any]:
    """Provenance for every measurement: device name, device count and the
    ``nvidia-smi`` name and power limit."""
    cuda = torch.cuda.is_available()
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": torch.cuda.device_count() if cuda else 0,
        "nvidia_smi": nvidia_smi(),
    }
