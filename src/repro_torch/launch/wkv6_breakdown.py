"""Where the CUDA ``wkv6`` kernel's time goes, on the CUDA card.

    PYTHONPATH=src python -m repro_torch.launch.wkv6_breakdown [--out F]

Builds ``csrc/wkv6.cu`` as it is and three cut-down copies of its bf16
kernel (each a text edit of the source, built beside the real library
under ``build/``): without the per-tile prep (the running decay products,
the diagonal blocks of A, the bf16 terms), without the per-sub-chunk
tensor-core products, and without both (the loads, the stores and the
barriers alone).  Times each at the rwkv6-7b prefill shape (B, T, H, N) =
(8, 512, 64, 64) bf16 by CUDA events over a CUDA graph of 10 calls
replayed 10 times, twice in turn; the cut-down copies compute garbage and
are timed only.  Then times the fp32 kernel (the design of the first
port) at B = 4 and 8 and chunks 64, 32 and 16: 512 blocks at two an SM
are 1.94 waves, 256 fit in one; shorter chunks cut its exps per row.
Prints each kernel's registers and spills (``ptxas -v``) and the card's
name and power limit, and writes the numbers as JSON to ``--out``
(default ``results/torch_wkv6_breakdown.json``).  Needs CUDA and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.launch import kernel_variants as kv
from repro_torch.launch import platform

SHAPE = (8, 512, 64, 64)
PREP = "for (int s = warp; s < kSubs; s += Cfg::kWarps) {"
PRODUCTS = ("for (int s = 0; s < kSubs; ++s) {\n      const int tb = s * kSub;"
            "\n      if (t0 + tb >= T_len) break;")


def _cut(src: str, loop: str) -> str:
    return kv.cut(src, loop, loop.replace("< kSubs", "< 0"))


VARIANTS = {
    "kernel": lambda s: s,
    "no_prep": lambda s: _cut(s, PREP),
    "no_products": lambda s: _cut(s, PRODUCTS),
    "loads_only": lambda s: _cut(_cut(s, PREP), PRODUCTS),
}


def _build_variants(out_dir: Path):
    libs, ptxas = kv.build_variants("wkv6", VARIANTS, out_dir,
                                    r"wkv6_(?:mma|fp32)_kernelILi\d+")
    for lib in libs.values():
        lib.wkv6_launch.argtypes = [ctypes.c_void_p] * 8 + \
            [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.wkv6_launch.restype = ctypes.c_int
    return libs, ptxas


def _launcher(lib, x, chunk, dtype_code):
    r, k, v, w, u, s0 = x
    B, T, H, N = r.shape
    y, so = torch.empty_like(v), torch.empty_like(s0)

    def call():
        err = lib.wkv6_launch(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                              w.data_ptr(), u.data_ptr(), s0.data_ptr(),
                              so.data_ptr(), y.data_ptr(), B, T, H, N, chunk,
                              dtype_code,
                              torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"wkv6 launch failed: CUDA error {err}")
    return call


def _inputs(B, T, H, N, dtype, gen):
    shape = (B, T, H, N)
    r, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    w = (0.2 + 0.799 * torch.rand(shape, generator=gen, device="cuda"))
    u = torch.randn((H, N), generator=gen, device="cuda")
    s0 = torch.randn((B, H, N, N), generator=gen, device="cuda")
    return r, k, v, w.to(dtype), u, s0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="results/torch_wkv6_breakdown.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("wkv6_breakdown: CUDA is not available", file=sys.stderr)
        return 1
    card = platform.describe()["nvidia_smi"]
    libs, ptxas = _build_variants(_build.BUILD_DIR / "wkv6_breakdown")
    for name, lines in ptxas.items():
        print(f"ptxas {name}: " + "; ".join(lines))
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = _inputs(*SHAPE, torch.bfloat16, gen)
    ms = {name: [] for name in libs}
    for _ in range(2):
        for name, lib in libs.items():
            ms[name].append(kv.graph_ms(_launcher(lib, x, 64, 1)))
    for name, t in ms.items():
        print(f"bf16 {name} {SHAPE}: " + ", ".join(f"{v:.6f}" for v in t)
              + f" ms per call [{card}]")
    fp32 = {}
    xf = _inputs(*SHAPE, torch.float32, gen)
    for B in (4, 8):
        xb = [t[:B].contiguous() if t.dim() == 4 else t for t in xf]
        for chunk in (64, 32, 16):
            fp32[f"B{B}_chunk{chunk}"] = t = kv.graph_ms(
                _launcher(libs["kernel"], xb, chunk, 0))
            print(f"fp32 kernel B={B} chunk={chunk}: {t:.6f} ms per call "
                  f"[{card}]")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "shape": SHAPE, "bf16_ms": ms,
                               "fp32_ms": fp32, "ptxas": ptxas}, indent=1))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
