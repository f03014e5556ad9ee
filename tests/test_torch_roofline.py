"""Port parity for the analytic half of ``launch/roofline.py``.

Mirrors the four analytic tests of tests/test_launch_analysis.py
(test_analytic_flops_scales_linearly_with_tokens,
test_analytic_flops_train_is_3x_prefill,
test_analytic_decode_flops_much_smaller_than_prefill, test_moe_active_ratio)
on the port, and holds the port's ``analytic_model_flops`` equal to the
reference's (rtol 1e-12) for every arch x train/prefill/decode.  The
probe-corrected half (``roofline_cell``, ``main``) traces with fake
tensors on the CPU: its fit against the full-depth trace, the useful-flops
ratio of llama3.2-1b train_4k, and the sweep on one cell.

The reference module requests 512 emulated devices when it is imported,
which raises once the JAX backend is up (inside a test body it is), so it
is imported here at module top, as tests/test_launch_analysis.py imports
the dry-run."""
import repro.launch.roofline as jroofline  # noqa: I001  (before any backend use)

import pytest

from repro.configs import get_arch as jget_arch
from repro.configs import list_archs as jlist_archs
from repro.configs.base import ShapeConfig as JShapeConfig
from repro_torch.configs import get_arch, list_archs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import roofline


def test_analytic_flops_scales_linearly_with_tokens():
    cfg = get_arch("llama3.2-1b").model
    f1 = roofline.analytic_model_flops(cfg, ShapeConfig("a", 1024, 8, "train"))
    f2 = roofline.analytic_model_flops(cfg,
                                       ShapeConfig("b", 1024, 16, "train"))
    assert f2 == pytest.approx(2 * f1, rel=1e-6)


def test_analytic_flops_train_is_3x_prefill():
    cfg = get_arch("mistral-nemo-12b").model
    tr = roofline.analytic_model_flops(cfg, ShapeConfig("a", 2048, 8, "train"))
    pf = roofline.analytic_model_flops(cfg,
                                       ShapeConfig("b", 2048, 8, "prefill"))
    assert tr == pytest.approx(3 * pf, rel=1e-6)


def test_analytic_decode_flops_much_smaller_than_prefill():
    for arch in ("rwkv6-7b", "whisper-small", "jamba-1.5-large-398b"):
        cfg = get_arch(arch).model
        pf = roofline.analytic_model_flops(
            cfg, ShapeConfig("b", 4096, 8, "prefill"))
        de = roofline.analytic_model_flops(
            cfg, ShapeConfig("c", 4096, 8, "decode"))
        assert de < pf / 100, arch     # one token vs 4096


def test_moe_active_ratio():
    n_act = roofline._active_params(get_arch("qwen3-moe-235b-a22b").model)
    # qwen3: ~22B active of 235B total
    assert 1.5e10 < n_act < 3.5e10
    assert roofline._active_params(get_arch("llama3.2-1b").model) > 1.0e9


@pytest.mark.parametrize("arch", list_archs())
def test_analytic_model_flops_match_reference(arch):
    assert list_archs() == jlist_archs()
    cfg, jcfg = get_arch(arch).model, jget_arch(arch).model
    assert roofline._active_params(cfg) == pytest.approx(
        jroofline._active_params(jcfg), rel=1e-12)
    for kind, seq, batch in (("train", 4096, 8), ("prefill", 32768, 1),
                             ("decode", 32768, 8), ("train", 512, 8)):
        got = roofline.analytic_model_flops(cfg,
                                            ShapeConfig("s", seq, batch, kind))
        want = jroofline.analytic_model_flops(
            jcfg, JShapeConfig("s", seq, batch, kind))
        assert got == pytest.approx(want, rel=1e-12), (kind, seq, batch)


def test_h100_constants_and_the_planner_stubs():
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.PEAK_FP32_FLOPS == 67e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.LINK_BW == 50e9         # one 400 Gb/s NDR port
    assert roofline.hbm_bytes() > 0
    # the TPU v5e figures of the reference stay there
    assert roofline.PEAK_FLOPS != jroofline.PEAK_FLOPS
    cfg = get_arch("llama3.2-1b").model
    shape = ShapeConfig("s", 512, 8, "train")
    flops = roofline.analytic_model_flops(cfg, shape)
    assert 30.0e12 < flops < 31.5e12        # 6 x 1.236e9 x 4096 + attention
    # the planners replaced the stubs: a skipped cell says why, and the
    # sweep asks for a cell
    row = roofline.roofline_cell("llama3.2-1b", "long_500k")
    assert row["skipped"] == get_arch("llama3.2-1b").skip_shapes["long_500k"]
    assert "SKIP" in roofline.fmt_row(row)
    with pytest.raises(SystemExit):
        roofline.main([])


# ---------------------------------------------------------------------------
# The probe-corrected traced totals (the reference's roofline_cell)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape_name", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("layers", [2, 4])
def test_probe_fit_equals_full_depth_trace(layers, shape_name):
    """llama3.2-1b cut to ``layers``: the fit of the depth-1/2 probes
    equals the full-depth trace: FLOPs, bytes and collective bytes exactly
    (rel 1e-9; a training cell's bytes through a third probe, with their
    term in layers squared); the peak of live bytes exactly when serving
    and within 1e-2 in training (a line through depths 2 and 3: the peak
    is not a polynomial in depth)."""
    from repro_torch.launch import dryrun

    ov = {"num_layers": layers}
    full = dryrun.lower_cell("llama3.2-1b", shape_name, model_overrides=ov,
                             device="cpu")
    r = roofline.roofline_cell("llama3.2-1b", shape_name,
                               model_overrides=ov, full_report=full,
                               device="cpu")
    f = r["full"]
    train = shape_name == "train_4k"
    assert r["hlo_flops_per_device"] == pytest.approx(f["flops"], rel=1e-9)
    assert r["coll_bytes_per_device"] == pytest.approx(f["coll"], rel=1e-9)
    assert f["coll"] > 0
    assert r["hlo_bytes_per_device"] == pytest.approx(f["bytes"], rel=1e-9)
    fit_temp = r["nonlayer_temp"] + layers * r["per_layer_temp"]
    assert fit_temp == pytest.approx(f["temp"], rel=1e-2 if train else 1e-9)
    assert sorted(r["probes"]) == (["1", "2", "3"] if train else ["1", "2"])
    assert r["memory_analysis"] == full["memory"]


def test_useful_flops_ratio_of_llama_train_4k():
    """The analytic MODEL_FLOPS over the traced FLOPs at full depth."""
    r = roofline.roofline_cell("llama3.2-1b", "train_4k", device="cpu")
    assert 0.9 <= r["useful_flops_ratio"] <= 1.0
    assert r["full"] is None and r["resident_gib_per_device"] > 0
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert r["step_time_lower_bound_s"] == max(
        r["compute_term_s"], r["memory_term_s"], r["collective_term_s"])


def test_useful_flops_ratio_drops_below_one_under_dots():
    """llama3.2-1b ``train_4k`` cut to 2 layers: under the arch's "dots"
    the traced FLOPs count the recomputed attention products, so the
    useful-flops ratio is below 1 and below the no-remat ratio, as the
    reference's (``repro/launch/roofline.py``)."""
    r = {remat: roofline.roofline_cell(
        "llama3.2-1b", "train_4k",
        model_overrides={"num_layers": 2, "remat": remat}, device="cpu")
        for remat in ("none", "dots")}
    assert r["dots"]["useful_flops_ratio"] < 1.0
    assert r["dots"]["useful_flops_ratio"] < r["none"]["useful_flops_ratio"]
    assert r["dots"]["hlo_flops_per_device"] > \
        r["none"]["hlo_flops_per_device"]
    assert r["dots"]["model_flops_global"] == r["none"]["model_flops_global"]


def test_roofline_cli_one_cell(tmp_path):
    rows = roofline.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                          "--out", str(tmp_path), "--device", "cpu"])
    assert len(rows) == 1 and "error" not in rows[0], rows
    assert (tmp_path / "llama3.2-1b_decode_32k.json").exists()
    assert (tmp_path / "table.json").exists()
    assert rows[0]["mesh_chips"] == 256 and rows[0]["kind"] == "decode"
