"""The kernel wrappers' refusal to be differentiated.

A wrapper launches its kernel through ``ctypes`` on raw pointers and
returns a fresh buffer: autograd sees no operation, so a gradient through
it would silently be dropped (ordinary autograd) or fail on ``data_ptr``
(``torch.func.grad``).  The reference's kernels have no ``custom_vjp``
either; its training runs the plain path.  Each wrapper calls
``refuse_grad`` first, before any device check, so the refusal is the same
on every device.
"""
from __future__ import annotations

import torch


def refuse_grad(name: str, *tensors) -> None:
    """Raise ``RuntimeError`` when grad mode is on and any floating tensor
    among ``tensors`` (``None`` entries skipped) requires grad."""
    if not torch.is_grad_enabled():
        return
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_floating_point() \
                and t.requires_grad:
            raise RuntimeError(
                f"{name} kernel has no backward: an input requires grad "
                f"while grad mode is on, and the kernel's output would "
                f"carry no gradient.  Build the model with impl=\"plain\" "
                f"(the differentiable plain PyTorch path, as the reference "
                f"trains through its plain path), or call the kernel under "
                f"torch.no_grad()")
