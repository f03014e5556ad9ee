"""Roofline analysis: the analytic half of the reference's
``repro/launch/roofline.py``, for one NVIDIA H100.

``analytic_model_flops(cfg, shape)`` is the useful work of one step (6 x
active params x tokens for training plus the attention's score and value
products, 2 x for a prefill, one token against the cache for decode); a
training run's MFU is that over (step seconds x ``PEAK_FLOPS``).  The
counts walk the port's ``param_specs`` (shapes only, nothing allocated).

The other half is the reference's probe-corrected compiled totals, from
traces (``launch/dryrun.py``) where the reference compiles:

    compute term    = traced FLOPs     / (989e12 FLOP/s bf16)
    memory term     = traced bytes     / (3.35e12 B/s HBM3)
    collective term = collective bytes / (50e9 B/s, one NDR link)

all per device (global / chips).  ``roofline_cell`` fits two reduced-depth
probes to full depth and sets the analytic MODEL_FLOPS beside the traced
FLOPs (the useful-flops ratio); ``main`` sweeps the cells.  The traces run
the arch's remat policy, so a training cell's traced FLOPs count the
recompute and its useful-flops ratio falls below 1, as the reference's.

Usage:
  python -m repro_torch.launch.roofline --arch rwkv6-7b --shape train_4k
  python -m repro_torch.launch.roofline --all --out results/roofline
  (add --multi-pod for the 512-device mesh, --device cpu to trace on the
  CPU)
"""
from __future__ import annotations

import argparse
import json
import os
import traceback
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_arch, get_shape, list_archs
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.launch.platform import DeviceLike
from repro_torch.models import common as cm

# NVIDIA H100 80GB HBM3 (SXM, 700 W), published dense peaks
PEAK_FLOPS = 989e12            # bf16 tensor cores, FLOP/s
PEAK_FP32_FLOPS = 67e12        # fp32 outside the tensor cores, FLOP/s
HBM_BW = 3.35e12               # HBM3, B/s
HBM_BYTES = 80 * 10**9         # NVIDIA H100 80GB HBM3, as sold
# One 400 Gb/s InfiniBand NDR port per GPU.  The production mesh's 16-wide
# axes span two 8-GPU NVLink nodes, so every axis's collectives cross it.
LINK_BW = 50e9                 # B/s


def hbm_bytes() -> int:
    """The card's memory: ``torch.cuda.get_device_properties`` when a card
    is present, else ``HBM_BYTES``."""
    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(0).total_memory)
    return HBM_BYTES


# ---------------------------------------------------------------------------
# Analytic MODEL_FLOPS
# ---------------------------------------------------------------------------


def _active_params(cfg: ModelConfig) -> float:
    """Non-embedding params active per token (MoE: top_k of routed)."""
    from repro_torch.models import model_zoo

    specs = model_zoo.build_model(cfg, max_seq=128).param_specs()
    total_active = 0.0

    def walk(tree, path):
        nonlocal total_active
        if cm.is_spec(tree):
            n = float(np.prod(tree.shape))
            p = "/".join(path)
            if "embedding" in p or "dec_pos" in p:
                return                      # embedding gather ~ free
            if ("/moe/" in p or p.startswith("moe/")) and (
                    "/wi" in p or "/wg" in p or "/wo" in p) and \
                    "shared" not in p:
                n *= cfg.moe_top_k / max(cfg.moe_num_experts, 1)
            total_active += n
            return
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + [k])

    walk(specs, [])
    if cfg.tie_embeddings:
        total_active += cfg.padded_vocab * cfg.d_model  # logits matmul
    return total_active


def _attn_flops_fwd(cfg: ModelConfig, B: int, S: int, decode: bool) -> float:
    """Score+value matmul flops (fwd), summed over attention layers.

    decode=True means ONE new token against an S-token cache/state: token
    count is 1, not S (state-recurrence archs advance the state once).
    """
    hd = cfg.resolved_head_dim
    H = cfg.num_heads
    n_tok = 1 if decode else S
    if cfg.family == "rwkv6":
        # chunked linear attention: ~4*H*N^2 per token
        N = cfg.rwkv_head_dim
        return 4.0 * B * n_tok * cfg.rwkv_num_heads * N * N * cfg.num_layers
    n_attn = sum(1 for i in range(cfg.num_layers) if cfg.is_attention_layer(i))
    ssd_fl = 0.0
    if cfg.family == "hybrid":
        n_mamba = cfg.num_layers - n_attn
        N, P = cfg.mamba_d_state, cfg.mamba_head_dim
        Hm = cfg.mamba_num_heads
        ssd_fl = 4.0 * B * n_tok * Hm * N * P * n_mamba
    if decode:
        per = 4.0 * B * S * H * hd                  # 1 token reads S cache
    else:
        kv_span = min(cfg.sliding_window or S, S)
        per = 4.0 * B * S * kv_span * H * hd * (0.5 if kv_span == S else 1.0)
    fl = per * n_attn + ssd_fl
    if cfg.family == "encdec":
        cross = 4.0 * B * n_tok * cfg.encoder_seq * H * hd * cfg.num_layers
        fl += cross
        if not decode:  # the encoder runs once per train/prefill step only
            fl += 4.0 * B * cfg.encoder_seq ** 2 * H * hd * cfg.encoder_layers
    return fl


def analytic_model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Global useful flops for one step of this cell."""
    B = shape.global_batch
    if shape.kind == "train":
        tokens = B * shape.seq_len
        return (6.0 * _active_params(cfg) * tokens
                + 3.0 * _attn_flops_fwd(cfg, B, shape.seq_len, False))
    if shape.kind == "prefill":
        tokens = B * shape.seq_len
        return (2.0 * _active_params(cfg) * tokens
                + _attn_flops_fwd(cfg, B, shape.seq_len, False))
    # decode: one token against a seq_len cache
    return (2.0 * _active_params(cfg) * B
            + _attn_flops_fwd(cfg, B, shape.seq_len, True))


# ---------------------------------------------------------------------------
# Probe-corrected traced totals
# ---------------------------------------------------------------------------


def _depth_override(cfg: ModelConfig, d: int) -> Dict[str, Any]:
    ov: Dict[str, Any] = {}
    if cfg.family == "hybrid":
        ov["num_layers"] = d * 8
    else:
        ov["num_layers"] = d
    if cfg.family == "encdec":
        ov["encoder_layers"] = d
    return ov


def _layers_of(cfg: ModelConfig) -> float:
    """Depth in 'probe units' (hybrid: groups; encdec: enc+dec pairs)."""
    if cfg.family == "hybrid":
        return cfg.num_layers / 8.0
    return float(cfg.num_layers)


def _extract(rep: Dict[str, Any]) -> Dict[str, float]:
    return {
        "flops": float(rep.get("flops", 0.0)),
        "bytes": float(rep.get("bytes_accessed", 0.0)),
        "coll": float(rep.get("collective_bytes_per_device", 0.0)),
        "temp": float((rep.get("memory") or {}).get("temp_size_in_bytes",
                                                     0.0)),
    }


def _fit(xs: Sequence[int], ys: Sequence[float]):
    """(c0, c1, c2) of the polynomial through 2 (a line) or 3 points."""
    x1, x2 = xs[0], xs[1]
    f12 = (ys[1] - ys[0]) / (x2 - x1)
    f123 = 0.0
    if len(xs) == 3:
        f23 = (ys[2] - ys[1]) / (xs[2] - x2)
        f123 = (f23 - f12) / (xs[2] - x1)
    return (ys[0] - f12 * x1 + f123 * x1 * x2, f12 - f123 * (x1 + x2),
            f123)


def roofline_terms(flops: float, nbytes: float, coll: float
                   ) -> Dict[str, Any]:
    """The three terms of one device's step (its FLOPs, bytes and
    collective bytes), the largest of them the step's lower bound."""
    t = {"compute": flops / PEAK_FLOPS, "memory": nbytes / HBM_BW,
         "collective": coll / LINK_BW}
    dom = max(t.items(), key=lambda kv: kv[1])
    return {"compute_term_s": t["compute"], "memory_term_s": t["memory"],
            "collective_term_s": t["collective"], "bottleneck": dom[0],
            "step_time_lower_bound_s": dom[1]}


def roofline_cell(
    arch: str, shape_name: str, *, multi_pod: bool = False,
    depths=(1, 2), mesh=None, rule_extra=None, train_overrides=None,
    model_overrides=None, full_report: Optional[Dict[str, Any]] = None,
    device: DeviceLike = "cuda",
) -> Dict[str, Any]:
    """The three roofline terms of one cell from traces at reduced depth.

    Two probes (``depths``, unrolled, at the cell's global shapes) fit
    total(L) = nonlayer + L * per_layer for the flops, bytes, collective
    bytes and temp bytes (the peak of live intermediates), extrapolated to
    the arch's depth.  A training cell traces one probe deeper: its bytes
    take a term in L^2 (each layer's ``select`` backward writes a zeroed
    gradient of the whole stacked weight), fit through the three probes,
    and its peak is fit from the two deepest (at depth 1 the peak can sit
    in the loss's logits, which do not grow with depth).  The port's
    layers are Python loops, so a full-depth trace would count every layer
    too; the probes keep a sweep's trace time bounded (the plain chunked
    scans of rwkv6 and Jamba trace per chunk).  ``full_report``: a
    full-depth ``dryrun.lower_cell`` report; without one the cell's layouts
    are resolved at full depth (resident bytes) and not traced.
    ``fits_hbm``: resident + temp below ``hbm_bytes()``."""
    from repro_torch.launch import dryrun

    spec = get_arch(arch)
    if shape_name in spec.skip_shapes:
        return {"arch": arch, "shape": shape_name,
                "skipped": spec.skip_shapes[shape_name]}
    shape = get_shape(spec, shape_name)
    cfg = spec.model
    if model_overrides:
        cfg = cfg.replace(**model_overrides)
    mesh = mesh or abstract_mesh(multi_pod=multi_pod)
    chips = mesh.size
    kw = dict(mesh=mesh, rule_extra=rule_extra,
              train_overrides=train_overrides, device=device)

    # 1. full depth: layouts (and the trace, when the caller ran it)
    if full_report is None:
        full_report = dryrun.lower_cell(arch, shape_name, compile_it=False,
                                        model_overrides=model_overrides, **kw)
    traced = bool(full_report.get("traced"))

    # 2. unrolled probes, and one deeper for a training cell (see the fits)
    d1, d2 = sorted(depths)[:2]
    train = shape.kind == "train"
    at = {"flops": (d1, d2), "coll": (d1, d2),
          "bytes": (d1, d2, d2 + 1) if train else (d1, d2),
          "temp": (d2, d2 + 1) if train else (d1, d2)}
    probes: Dict[int, Dict[str, float]] = {}
    trace_s = 0.0
    for d in sorted({d for ds in at.values() for d in ds}):
        ov = dict(model_overrides or {})
        ov.update(_depth_override(cfg, d))
        rep = dryrun.lower_cell(arch, shape_name, model_overrides=ov, **kw)
        probes[d] = _extract(rep)
        trace_s += rep["trace_seconds"]

    L = _layers_of(cfg)
    out: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh_chips": chips,
        "kind": shape.kind,
        "full": _extract(full_report) if traced else None,
        "resident_gib_per_device": full_report.get("resident_gib_per_device"),
        "fallbacks": full_report.get("fallbacks"),
        "probes": {str(k): v for k, v in probes.items()},
        "trace_seconds": round(trace_s, 2),
    }
    terms: Dict[str, float] = {}
    for key, ds in at.items():
        c0, c1, c2 = _fit(ds, [probes[d][key] for d in ds])
        terms[key] = max(c0 + c1 * L + c2 * L * L, 0.0)
        out[f"per_layer_{key}"] = c1
        out[f"nonlayer_{key}"] = c0
        if len(ds) == 3:
            out[f"per_layer_sq_{key}"] = c2
    out["hlo_flops_per_device"] = terms["flops"]
    out["hlo_bytes_per_device"] = terms["bytes"]
    out["coll_bytes_per_device"] = terms["coll"]
    if traced:
        out["memory_analysis"] = full_report.get("memory")
        out["collective_detail"] = full_report.get("collectives")
        temp = float(full_report["memory"]["temp_size_in_bytes"])
    else:
        out["memory_analysis"] = {"temp_size_in_bytes": int(terms["temp"])}
        temp = terms["temp"]

    out.update(roofline_terms(terms["flops"], terms["bytes"], terms["coll"]))
    bound = out["step_time_lower_bound_s"]

    mf = analytic_model_flops(cfg, shape)
    out["model_flops_global"] = mf
    traced_global = terms["flops"] * chips
    out["useful_flops_ratio"] = (mf / traced_global) if traced_global else 0.0
    # roofline fraction: useful model flops per second at the bound, over peak
    if bound > 0:
        out["roofline_fraction"] = (mf / bound) / (chips * PEAK_FLOPS)
    out["fits_hbm"] = bool(
        (full_report.get("resident_bytes_per_device") or 0) + temp
        < hbm_bytes())
    return out


def fmt_row(r: Dict[str, Any]) -> str:
    if "skipped" in r:
        return f"{r['arch']:22s} {r['shape']:12s} SKIP"
    return (f"{r['arch']:22s} {r['shape']:12s} "
            f"C={r['compute_term_s']:9.3e} M={r['memory_term_s']:9.3e} "
            f"X={r['collective_term_s']:9.3e} -> {r['bottleneck']:10s} "
            f"useful={r['useful_flops_ratio']:.2f} "
            f"roof={r.get('roofline_fraction', 0):.3f} "
            f"res={r.get('resident_gib_per_device')}GiB "
            f"fits={r['fits_hbm']} trace={r['trace_seconds']}s")


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, Any]]:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--all", action="store_true")
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--out", default="results/roofline")
    p.add_argument("--device", default="cuda",
                   help="the fake tensors' device (cuda, or cpu)")
    args = p.parse_args(argv)

    shapes = [args.shape] if args.shape else \
        ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
    archs = [args.arch] if args.arch else list_archs()
    if not (args.all or args.arch):
        p.error("pass --arch or --all")
    os.makedirs(args.out, exist_ok=True)

    mesh = abstract_mesh(multi_pod=args.multi_pod)
    rows = []
    for a in archs:
        spec = get_arch(a)
        for s in shapes:
            if not any(sh.name == s for sh in spec.shapes):
                continue
            try:
                r = roofline_cell(a, s, multi_pod=args.multi_pod, mesh=mesh,
                                  device=args.device)
            except Exception as e:  # noqa: BLE001  (the sweep reports it)
                r = {"arch": a, "shape": s, "error": repr(e),
                     "traceback": traceback.format_exc()}
            rows.append(r)
            tag = f"{a}_{s}"
            with open(os.path.join(args.out, tag + ".json"), "w") as fh:
                json.dump(r, fh, indent=1, default=str)
            print(fmt_row(r) if "error" not in r
                  else f"{a} {s} ERROR {r['error']}", flush=True)
    with open(os.path.join(args.out, "table.json"), "w") as fh:
        json.dump(rows, fh, indent=1, default=str)
    return rows


if __name__ == "__main__":
    main()
