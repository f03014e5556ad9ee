"""Where the CUDA ``ssd`` kernel's time goes, on the CUDA card.

    PYTHONPATH=src python -m repro_torch.launch.ssd_breakdown [--out F]

Builds ``csrc/ssd.cu`` as it is and cut-down copies of it (each a text
edit of the source, built beside the real library under ``build/``).  Of
the bf16 kernel: without the per-chunk prep (the tiles of C B^T, A and
B * dec as bf16 terms), without the warps' products (S^T C^T, x^T A^T,
x^T (B * dec) and their operand loads), and without both and the x^T
loads (the copies, the scan of a, the barriers, the staging and stores of
y alone); and candidate shapes: 64 columns of P a block (2048 blocks of 4
warps) with three or two blocks an SM, 128 columns with two blocks an SM
(up to 128 registers a thread, as against 80 for three), and three
chunks staged at once instead of two.  Of the fp32 kernel (the first
port's design, run on fp32 inputs): without A, without the y products,
without the state update, and at B = 4 (512 blocks: 1.94 waves at two an
SM) against 8.  Times each at the jamba-1.5-large prefill shape (B, T, H,
P, N) = (8, 512, 128, 128, 16), B and C broadcast, chunk 64, by CUDA
events over a CUDA graph of 10 calls replayed 10 times, twice in turn;
the cut-down copies compute garbage and are timed only.  Prints each
kernel's registers and spills (``ptxas -v``) and the card's name and
power limit, and writes the numbers as JSON to ``--out`` (default
``results/torch_ssd_breakdown.json``).  Needs CUDA and nvcc.
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

SHAPE = (8, 512, 128, 128, 16)
CHUNK = 64
PREP = ("idx < kGTiles;",
        "for (int e = tid; e < kKN * kTile / 2; e += Cfg::kThreads) {")
PRODUCTS = ("if (8 * nt >= C) break;", "if (8 * nt >= C) break;",
            "if (16 * ks >= C) break;")
XT = "for (int ks = 0; ks < 4; ++ks)\n      ldmatrix_x4_trans("
FP32_A = "for (int i = tid; i < C * C; i += kThreads) {"
FP32_Y = ("for (int n = 0; n < N; ++n) {\n      const float4 s4",
          "for (int j = 0; j <= tmax; ++j) {")
FP32_S = "if (rg < N) {"


def _cut_prep(s: str) -> str:
    for loop in PREP:
        s = kv.cut(s, loop, loop.replace("idx < kGTiles", "idx < 0")
                   .replace("e < kKN * kTile / 2", "e < 0"))
    return s


def _cut_products(s: str) -> str:
    for guard in PRODUCTS:
        s = kv.cut(s, guard, "if (true) break;")
    return s


def _cut_fp32_y(s: str) -> str:
    s = kv.cut(s, FP32_Y[0], FP32_Y[0].replace("n < N", "n < 0"))
    return kv.cut(s, FP32_Y[1], FP32_Y[1].replace("j <= tmax", "j < 0"))


def _cols64(s: str) -> str:
    return kv.cut(s, "constexpr int kMaxBlockCols = 128;",
                  "constexpr int kMaxBlockCols = 64;")


def _blocks2(s: str) -> str:
    return kv.cut(s, "__launch_bounds__(MmaCfg<P>::kThreads, 3)",
                  "__launch_bounds__(MmaCfg<P>::kThreads, 2)")


VARIANTS = {
    "kernel": lambda s: s,
    "no_prep": _cut_prep,
    "no_products": _cut_products,
    "loads_only": lambda s: kv.cut(_cut_products(_cut_prep(s)), XT,
                                   XT.replace("ks < 4", "ks < 0")),
    "cols64": _cols64,
    "cols64_2blocks": lambda s: _blocks2(_cols64(s)),
    "blocks2": lambda s: _blocks2(s),
    "stages3": lambda s: kv.cut(s, "constexpr int kStages = 2;",
                                "constexpr int kStages = 3;"),
    "fp32_no_A": lambda s: kv.cut(s, FP32_A, FP32_A.replace("i < C * C",
                                                            "i < 0")),
    "fp32_no_y": _cut_fp32_y,
    "fp32_no_state": lambda s: kv.cut(s, FP32_S, "if (rg < 0) {"),
}


def _inputs(B, T, H, P, N, dtype, gen):
    """x normal, a uniform in [0.3, 1), B and C one (B, T, N) projection
    broadcast across the heads (as Jamba's mixer makes them), the state
    normal fp32."""
    x = torch.randn((B, T, H, P), generator=gen, device="cuda").to(dtype)
    a = (0.3 + 0.7 * torch.rand((B, T, H), generator=gen,
                                device="cuda")).to(dtype)
    Bm, Cm = (torch.randn((B, T, 1, N), generator=gen, device="cuda")
              .to(dtype).expand(B, T, H, N) for _ in range(2))
    s0 = torch.randn((B, H, N, P), generator=gen, device="cuda")
    return x, a, Bm, Cm, s0


def _launcher(lib, inputs, chunk):
    x, a, Bm, Cm, s0 = inputs
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    y, so = torch.empty_like(x), torch.empty_like(s0)
    code = 1 if x.dtype == torch.bfloat16 else 0

    def call():
        err = lib.ssd_launch(
            x.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            *Bm.stride()[:3], *Cm.stride()[:3], s0.data_ptr(), so.data_ptr(),
            y.data_ptr(), B, T, H, P, N, chunk, code,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"ssd launch failed: CUDA error {err}")
    return call


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="results/torch_ssd_breakdown.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ssd_breakdown: CUDA is not available", file=sys.stderr)
        return 1
    card = platform.describe()["nvidia_smi"]
    libs, ptxas = kv.build_variants(
        "ssd", VARIANTS, _build.BUILD_DIR / "ssd_breakdown",
        r"ssd_(?:mma_kernelILi\d+|fp32_kernelILi\d+ELi\d+)")
    for lib in libs.values():
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ssd_launch.argtypes = ([ptr] * 4 + [i64] * 6 + [ptr] * 3
                                   + [i32] * 7 + [ptr])
        lib.ssd_launch.restype = ctypes.c_int
    for name, lines in ptxas.items():
        print(f"ptxas {name}: " + "; ".join(lines))
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = _inputs(*SHAPE, torch.bfloat16, gen)
    xf = _inputs(*SHAPE, torch.float32, gen)
    bf16 = {n: lib for n, lib in libs.items() if not n.startswith("fp32_")}
    fp32 = {"fp32_kernel": libs["kernel"],
            **{n: lib for n, lib in libs.items() if n.startswith("fp32_")}}
    ms = {name: [] for name in [*bf16, *fp32]}
    for _ in range(2):
        for name, lib in bf16.items():
            ms[name].append(kv.graph_ms(_launcher(lib, x, CHUNK)))
        for name, lib in fp32.items():
            ms[name].append(kv.graph_ms(_launcher(lib, xf, CHUNK)))
    for name, t in ms.items():
        kind = "fp32" if name.startswith("fp32_") else "bf16"
        print(f"{kind} {name} {SHAPE} chunk {CHUNK}: "
              + ", ".join(f"{v:.6f}" for v in t) + f" ms per call [{card}]")
    half = [t[:4] for t in xf]
    ms["fp32_kernel_B4"] = t = kv.graph_ms(_launcher(libs["kernel"], half,
                                                     CHUNK))
    print(f"fp32 kernel B=4: {t:.6f} ms per call [{card}]")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "shape": SHAPE, "chunk": CHUNK,
                               "ms": ms, "ptxas": ptxas}, indent=1))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
