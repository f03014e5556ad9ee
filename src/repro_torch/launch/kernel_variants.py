"""Build cut-down copies of a CUDA kernel and time them, on the CUDA card.

The breakdown scripts (``wkv6_breakdown``, ``ssd_breakdown``) take a
kernel source from ``csrc/``, apply text edits that cut one part of it
(``cut``), build each copy beside the real library under ``build/``
(``build_variants``: one ``nvcc`` per copy, all started together) and time
each by CUDA events over a replayed CUDA graph (``graph_ms``).  The cut
copies compute garbage and are timed only.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import torch

from repro_torch.kernels import _build


def cut(src: str, old: str, new: str) -> str:
    """``src`` with the first ``old`` replaced by ``new``; raises when the
    source no longer holds ``old`` (the cut would silently time the whole
    kernel)."""
    if old not in src:
        raise RuntimeError(f"the kernel source no longer holds {old[:60]!r}")
    return src.replace(old, new, 1)


def build_variants(name: str, variants: Dict[str, Callable[[str], str]],
                   out_dir: Path, kernel_regex: str
                   ) -> Tuple[Dict[str, ctypes.CDLL], Dict[str, List[str]]]:
    """Build ``csrc/<name>.cu`` edited by each of ``variants`` into
    ``out_dir/lib<name>_<variant>.so``.  Returns the loaded libraries and,
    per variant, ``ptxas -v``'s registers and spills of each kernel whose
    mangled name matches ``kernel_regex`` (one capture group: the short
    name printed)."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for var, edit in variants.items():
        cu = out_dir / f"{name}_{var}.cu"
        cu.write_text(edit(src))
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(out_dir / f"lib{name}_{var}.so"), str(cu)]
        procs[var] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    libs, ptxas = {}, {}
    for var, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{var}: nvcc exited {proc.returncode}\n{log}")
        ptxas[var] = [
            f"{m.group(1)}: {m.group(3)} registers, {m.group(2)}"
            for m in re.finditer(
                r"entry function '\S*?(" + kernel_regex + r")\S*'"
                r"[\s\S]*?(\d+ bytes spill stores, \d+ bytes spill loads)"
                r"[\s\S]*?Used (\d+) registers", log)]
        libs[var] = ctypes.CDLL(str(out_dir / f"lib{name}_{var}.so"))
    return libs, ptxas


def graph_ms(fn, calls=10, replays=10) -> float:
    """Device ms per call: ``calls`` calls in one CUDA graph, replayed."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)
