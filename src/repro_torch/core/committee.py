"""Committee (query-by-committee) machinery — paper §2.1/§3.1.

An ensemble of K models is one batched program: parameters are stacked on a
leading committee axis and the per-member forward is ``torch.func.vmap``-ed
over it.  Parameter trees are plain nested dicts (lists, tuples) of tensors;
leaves are visited in sorted-key order, the order the reference's pytrees
use, so the paper's 1-D weight packing (S4: ``get_weight`` /
``get_weight_size`` / ``update``) produces the same wire format in both
packages.

``params_from_numpy`` carries the reference's parameters across: any tree of
array-likes (``np.asarray``-able, e.g. the reference's stacked ``cparams``)
becomes the same tree of tensors on the requested device.

The committee statistics (``mean_std`` with ddof 1, ``disagreement``) and
the LM committee's uncertainty (``lm_token_nll``, the sequence-level
``lm_committee_uncertainty``) follow the reference's functions; the
``examples/lm_active_distill`` twin scores its student committee with them.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch.func import vmap

from repro_torch.launch.platform import DeviceLike, resolve_device


# ---------------------------------------------------------------------------
# Parameter trees
# ---------------------------------------------------------------------------


def tree_map(fn: Callable, tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a dict/list/tuple tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t) for t in tree)
    return fn(tree)


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_paths(tree: Any, prefix: tuple = ()) -> List[tuple]:
    """Key paths of the leaves, in ``tree_leaves`` order — the structure
    two trees must share to be interchangeable."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in tree_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, t in enumerate(tree)
                for p in tree_paths(t, prefix + (i,))]
    return [prefix]


def _leaf_from_numpy(a) -> torch.Tensor:
    arr = np.array(a, copy=True)
    if arr.dtype.name == "bfloat16":
        # numpy's bfloat16 (ml_dtypes) has no torch counterpart to share
        # memory with: go through float32, which holds every bf16 value
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """A tree of array-likes -> the same keys and shapes as tensors on
    ``device`` (default: the CUDA device).  Copies; dtypes are kept
    (bfloat16 leaves included)."""
    dev = resolve_device(device)
    return tree_map(lambda a: _leaf_from_numpy(a).to(dev), tree)


# ---------------------------------------------------------------------------
# 1-D weight packing (paper S4)
# ---------------------------------------------------------------------------


def get_weight_size(params: Any) -> int:
    """Size of the packed 1-D array (paper: negotiated once at startup)."""
    return sum(int(np.prod(tuple(x.shape))) for x in tree_leaves(params))


def get_weight(params: Any, out: Optional[np.ndarray] = None) -> np.ndarray:
    """Pack a tree into one 1-D float32 array (paper's wire format).

    ``out``: optional preallocated destination (must match the packed size);
    leaves are copied in at their offsets, so a publish loop can reuse one
    buffer instead of allocating every round.
    """
    leaves = tree_leaves(params)
    if out is None:
        out = np.empty(get_weight_size(params), np.float32)
    off = 0
    for x in leaves:
        flat = x.detach().to("cpu", torch.float32).reshape(-1).numpy()
        out[off:off + flat.size] = flat
        off += flat.size
    if off != out.size:
        raise ValueError(f"pack buffer size mismatch: {out.size} buffer vs "
                         f"{off} packed")
    return out


def update(params_like: Any, weight_array: np.ndarray) -> Any:
    """Unpack a 1-D array into the structure (and device, dtype) of
    ``params_like``."""
    off = 0

    def leaf(t):
        nonlocal off
        n = t.numel()
        seg = np.ascontiguousarray(weight_array[off:off + n]).reshape(
            tuple(t.shape))
        off += n
        return torch.from_numpy(seg.copy()).to(t.device, t.dtype)

    out = tree_map(leaf, params_like)
    if off != weight_array.size:
        raise ValueError(f"weight array size mismatch: {weight_array.size} "
                         f"packed vs {off} expected")
    return out


# ---------------------------------------------------------------------------
# Committee evaluation
# ---------------------------------------------------------------------------


def stack_members(members) -> Any:
    """[params, ...] -> stacked tree with a leading committee axis."""
    first = members[0]
    if isinstance(first, dict):
        return {k: stack_members([m[k] for m in members])
                for k in sorted(first)}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_members([m[i] for m in members])
                           for i in range(len(first)))
    return torch.stack(list(members))


def member(cparams: Any, i: int) -> Any:
    return tree_map(lambda a: a[i], cparams)


def committee_size(cparams: Any) -> int:
    return int(tree_leaves(cparams)[0].shape[0])


def make_committee_apply(apply_fn: Callable) -> Callable:
    """apply_fn(params, x) -> y  ==>  capply(cparams, x) -> (K, ...) y."""
    return vmap(apply_fn, in_dims=(0, None))


def mean_std(preds: torch.Tensor, dim: int = 0
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Committee mean and std (ddof=1, matching the paper's utils); the
    std is zeros for a committee of one."""
    mean = torch.mean(preds, dim=dim)
    k = preds.shape[dim]
    std = (torch.std(preds, dim=dim, correction=1) if k > 1
           else torch.zeros_like(mean))
    return mean, std


def disagreement(preds: torch.Tensor) -> torch.Tensor:
    """Scalar per-sample uncertainty: max std over output components.

    preds: (K, B, ...) -> (B,).  This is the quantity prediction_check
    thresholds (paper utils: (std > threshold).any(axis=1))."""
    _, std = mean_std(preds, dim=0)
    return torch.amax(std.reshape(std.shape[0], -1), dim=-1)


# ---------------------------------------------------------------------------
# LM committee uncertainty
# ---------------------------------------------------------------------------


def lm_token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(B, T, V) x (B, T) -> (B, T) token NLL in fp32 (labels below 0 read
    token 0, as the reference's ``clip(0)``)."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.clamp_min(0).to(torch.int64)[..., None]
                      )[..., 0]
    return lse - ll


def lm_committee_uncertainty(clogits: torch.Tensor, labels: torch.Tensor):
    """clogits: (K, B, T, V).  Returns (mean_nll (B,), std_nll (B,)).

    Sequence-level committee disagreement = std over members of the mean
    token NLL — the LM analog of energy-prediction std."""
    nll = vmap(lm_token_nll, in_dims=(0, None))(clogits, labels)  # (K,B,T)
    return mean_std(torch.mean(nll, dim=-1), dim=0)


class Committee:
    """Convenience wrapper pairing stacked params with a vmapped apply (not
    a hot path: the exchange loop scores through ``FusedEngine``).

    ``jit`` is taken for the reference's signature; the port compiles
    nothing here, and both values run the ``torch.func.vmap``-ed apply
    eagerly."""

    def __init__(self, apply_fn: Callable, cparams: Any, jit: bool = True):
        self.apply = make_committee_apply(apply_fn)
        self.params = cparams

    @property
    def size(self) -> int:
        return committee_size(self.params)

    def predict(self, x) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Returns (preds (K, ...), mean, std)."""
        preds = self.apply(self.params, x)
        mean, std = mean_std(preds, dim=0)
        return preds, mean, std

    def replace_member(self, i: int, params: Any):
        """Member ``i`` <- ``params`` (same tree), in new tensors."""
        def put(c, p):
            c = c.clone()
            c[i] = p
            return c

        self.params = pytree.tree_map(put, self.params, params)


# ---------------------------------------------------------------------------
# Shape bucketing (program-cache quantization for the acquisition engine)
# ---------------------------------------------------------------------------


def shape_bucket(n: int, minimum: int = 8) -> int:
    """Next power-of-two >= n (floored at ``minimum``) — the program-cache
    key."""
    b = max(1, minimum)
    while b < n:
        b *= 2
    return b
