"""The port stands alone: no ``repro_torch`` module and not
``chip_smoke.py`` imports JAX or the reference package, its entry points
(``PAL`` included) default to the CUDA device and raise without it (no
silent CPU fallback), and the CPU paths of ``ops``, the engine and ``PAL``
never touch the kernel loader."""
import os
import pkgutil
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs.pal_potential import PALRunConfig
from repro_torch.core import acquisition as tacq
from repro_torch.core import PAL
from repro_torch.core import committee as tcmte
from repro_torch.kernels import _build, ops
from repro_torch.kernels import committee_uq as kernel
from repro_torch.serving import CommitteeServer

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
MODULES = sorted(m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, prefix="repro_torch."))


def test_every_module_imports_with_jax_blocked():
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"           # any `import jax` now fails
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        f"for name in {MODULES + ['chip_smoke']!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m == 'repro' or "
        "m.startswith(('repro.', 'jax.'))]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("ok")
    assert len(MODULES) >= 40
    assert {"repro_torch.exploration",
            "repro_torch.exploration.fleet"} <= set(MODULES)
    assert {"repro_torch.models.whisper", "repro_torch.models.internvl",
            "repro_torch.examples.lm_active_distill"} <= set(MODULES)
    assert {"repro_torch.sharding", "repro_torch.sharding.rules",
            "repro_torch.launch.mesh",
            "repro_torch.launch.distributed"} <= set(MODULES)


@pytest.mark.parametrize("first", ["repro_torch.models",
                                   "repro_torch.models.common",
                                   "repro_torch.models.transformer"])
def test_models_package_reexports_build_model(first):
    """``from repro_torch.models import build_model``, as the reference's
    ``repro/models/__init__.py`` offers it, in a fresh process with JAX
    blocked, whichever module of the package is imported first (no import
    cycle with ``common``); it is ``model_zoo.build_model`` and builds a
    model, and neither ``jax`` nor ``repro`` is imported."""
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}]\n"
        f"importlib.import_module({first!r})\n"
        "from repro_torch.models import build_model\n"
        "from repro_torch.models import model_zoo\n"
        "from repro_torch.configs import get_arch\n"
        "assert build_model is model_zoo.build_model\n"
        "m = build_model(get_arch('llama3.2-1b').model)\n"
        "assert type(m).__name__ == 'DenseLM', m\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and "
        "(m in ('jax', 'repro') or m.startswith(('repro.', 'jax.')))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=str(ROOT))
    assert out.returncode == 0 and out.stdout.strip() == "ok", \
        out.stderr[-2000:]


def test_no_source_imports_jax_or_the_reference():
    pat = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_)|"
                     r"from\s+(jax|repro)(\.|\s)(?!_))", re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in files for m in pat.finditer(f.read_text())]
    assert not hits, hits
    assert len(files) > 40


def _pal(spec, **kw):
    return PAL(PALRunConfig(result_dir=tempfile.mkdtemp()),
               make_generator=lambda rank, rd: None,
               make_oracle=lambda rank, rd: None, committee=spec,
               loss_fn=lambda p, b: (torch.mean(b["x"] @ p["w"]), {}), **kw)


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    _no_cuda(monkeypatch)
    cparams = tcmte.params_from_numpy(
        {"w": np.ones((2, 3, 1), np.float32)}, "cpu")
    spec = tacq.CommitteeSpec(lambda p, x: x @ p["w"], cparams)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tacq.make_engine(PALRunConfig(), committee=spec)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tacq.FusedEngine(spec.apply_fn, cparams, 0.1)
    eng = tacq.FusedEngine(spec.apply_fn, cparams, 0.1, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CommitteeServer(eng)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcmte.params_from_numpy({"w": np.ones(2)})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kernel.committee_uq(torch.zeros(2, 4, 3), 0.1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _pal(spec)


def test_lm_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve
    from repro_torch.launch.train import reduced_config
    from repro_torch.models import model_zoo
    from repro_torch.serving import ServeEngine

    cfg = reduced_config(get_arch("llama3.2-1b").model, "smoke")
    model = model_zoo.build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init_cache(1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(model, params, max_seq=8, batch=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--preset", "smoke"])
    q = torch.zeros(1, 2, 4, 16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fa.flash_attention(q, q, q)
    rwkv = model_zoo.build_model(reduced_config(get_arch("rwkv6-7b").model,
                                                "smoke"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rwkv.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rwkv.init_cache(1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "rwkv6-7b", "--preset", "smoke"])
    from repro_torch.kernels import ssd as ssd_kernel

    jamba = model_zoo.build_model(reduced_config(
        get_arch("jamba-1.5-large-398b").model, "smoke"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        jamba.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        jamba.init_cache(1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "jamba-1.5-large-398b", "--preset", "smoke"])
    x = torch.zeros(1, 16, 2, 16)
    b = torch.zeros(1, 16, 2, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ssd_kernel.ssd(x, x[..., 0], b, b)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "whisper-small",
                                  "internvl2-2b"])
def test_new_lm_families_default_to_cuda_and_raise_without_it(arch,
                                                               monkeypatch):
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.launch.train import reduced_config
    from repro_torch.models import model_zoo
    from repro_torch.serving import ServeEngine

    model = model_zoo.build_model(reduced_config(get_arch(arch).model,
                                                 "smoke"), max_seq=16)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init_cache(1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(model, params, max_seq=8, batch=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", arch, "--preset", "smoke"])


def test_lm_distill_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch):
    from repro_torch.examples import lm_active_distill as distill

    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        distill.make_pal(tempfile.mkdtemp())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        distill.TeacherOracle(0, "")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        distill.main(["--timeout", "1"])


def test_kernel_wrapper_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="expected the CUDA device"):
        kernel.committee_uq(torch.zeros(2, 4, 3), 0.1, device="cpu")


def test_cpu_path_never_touches_the_kernel_loader(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("kernel loader touched on the CPU path")

    monkeypatch.setattr(_build, "load", boom)
    monkeypatch.setattr(_build, "build_all", boom)
    before = kernel.launches
    preds = torch.from_numpy(
        np.random.RandomState(0).randn(3, 9, 4).astype(np.float32))
    out = ops.committee_uq(preds, 0.5)
    assert out[0].shape == (9, 4) and kernel.launches == before
    eng = tacq.FusedEngine(lambda p, x: x @ p["w"], tcmte.params_from_numpy(
        {"w": np.ones((2, 4, 3), np.float32)}, "cpu"), 0.5, device="cpu")
    eng.score([np.ones(4, np.float32)])
    pal = _pal(tacq.CommitteeSpec(lambda p, x: x @ p["w"], eng.cparams),
               device="cpu")
    pal.engine.score([np.ones(4, np.float32)])
    assert kernel.launches == before


def test_kernel_build_paths_stay_inside_the_checkout():
    assert _build.BUILD_DIR == ROOT / "build" / "repro_torch_kernels"
    assert _build.SOURCES == ("committee_uq", "flash_attention", "ssd",
                              "wkv6")
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
        lib = _build.library_path(name)
        assert lib.parent == _build.BUILD_DIR and lib.suffix == ".so"


def test_train_entry_point_and_roofline_stand_alone(monkeypatch):
    """``launch/train.py`` and ``launch/roofline.py`` are among the modules
    imported with JAX blocked; importing them requests no emulated host
    devices (the reference's roofline does, at import); training defaults
    to CUDA and raises without it."""
    from repro_torch.launch import roofline, train

    assert {"repro_torch.launch.train",
            "repro_torch.launch.roofline"} <= set(MODULES)
    code = ("import os, sys\n"
            "sys.modules['jax'] = None\n"
            f"sys.path[:0] = [{str(ROOT / 'src')!r}]\n"
            "import repro_torch.launch.roofline, repro_torch.launch.train\n"
            "assert 'XLA_FLAGS' not in os.environ, os.environ['XLA_FLAGS']\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = ""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=str(ROOT))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    assert roofline.PEAK_FLOPS == 989e12
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--steps", "1", "--batch", "1", "--seq", "8"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.train(steps=1, batch=1, seq=8)
    out = train.train(steps=1, batch=1, seq=8, device="cpu")
    assert out["captures"] == 0 and len(out["metrics"]) == 1
