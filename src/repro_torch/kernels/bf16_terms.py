"""fp32 operands as sums of bf16 terms, as the bf16 kernels feed them to
the tensor cores (``mma.sync`` takes bf16 in and accumulates in fp32).

The CPU models of those kernels (``wkv6.subchunk_model``,
``ssd.mma_model``) use these to form each product as the card does.
"""
from __future__ import annotations

import torch


def split_bf16(x: torch.Tensor, parts: int = 2):
    """fp32 ``x`` as ``parts`` bf16 terms, each the bf16 rounding of what
    the ones before leave (hi = bf16(x), lo = bf16(x - hi), ...), returned
    in fp32: each term keeps 8 more of x's 24 bits."""
    out = []
    for _ in range(parts):
        out.append(x.to(torch.bfloat16).float())
        x = x - out[-1]
    return out


def mm_terms(a: torch.Tensor, b: torch.Tensor, split: int) -> torch.Tensor:
    """a @ b in fp32 (``split`` 0), or as the kernels' tensor cores form
    it: each operand split into ``split`` bf16 terms and the products of
    terms i, j with i + j < ``split`` summed in fp32 (the ones dropped are
    below 2^(-8 split) of the product; a term of an operand exact in bf16
    past the first is 0)."""
    if not split:
        return a @ b
    at, bt = split_bf16(a, split), split_bf16(b, split)
    out = torch.zeros(a.shape[:-1] + b.shape[-1:], device=a.device)
    for i in range(split):
        for j in range(split - i):
            out = out + at[i] @ bt[j]
    return out
