"""The port stands alone: no JAX and nothing of ``repro`` inside it.

* every ``repro_torch`` module imports in a fresh interpreter without
  ``jax`` or any ``repro`` module appearing in ``sys.modules``;
* no import statement in ``src/repro_torch``, ``chip_smoke.py``,
  ``chip_ab.py`` or ``chip_ssd_variants.py`` names ``jax`` or ``repro``;
* an entry point's default device is CUDA: without a usable GPU it raises
  rather than carrying on on the CPU — the Scenario path
  (``Scenario.run(substrate="engine")``) included;
* a kernel whose library cannot load raises: the CUDA route never falls
  back to the plain version.
"""
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
IMPORT_RE = re.compile(r"^\s*(?:from|import)\s+(jax|repro)(?:\.|\s|$)",
                       re.MULTILINE)


def _modules() -> list[str]:
    return sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PKG.rglob("*.py"))


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    assert {"repro_torch.serving.engine", "repro_torch.bench.engine_runner",
            "repro_torch.bench.scenario", "repro_torch.core.simulator",
            "repro_torch.kernels.autotune", "repro_torch.roofline.analysis",
            "repro_torch.resilience", "repro_torch.serving.router",
            "repro_torch.telemetry", "repro_torch.models.encdec",
            "repro_torch.launch.mesh", "repro_torch.launch.dryrun",
            "repro_torch.distributed.sharding",
            "repro_torch.distributed.mesh_ops"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_jax_or_repro_imports_in_sources():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "chip_ab.py",
                                         ROOT / "chip_ssd_variants.py"]
    offenders = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
                 for p in files for m in IMPORT_RE.finditer(p.read_text())]
    assert offenders == []


def test_default_device_raises_without_cuda(monkeypatch):
    from repro_torch.bench import Scenario, ScenarioApp
    from repro_torch.bench import engine_runner
    from repro_torch.configs.registry import get_config
    from repro_torch.device import resolve_device
    from repro_torch.launch import serve, train
    from repro_torch.models.factory import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("tinyllama-1.1b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--reduced", "--requests", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--reduced", "--steps", "1"])
    sc = Scenario(mode="concurrent", policy="chunked", total_chips=8,
                  apps=[ScenarioApp("chatbot", num_requests=1)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sc.run(substrate="engine")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine_runner.run_scenario_on_engine(sc)
    assert build_model(cfg, "cpu").device.type == "cpu"


def test_flash_attention_cuda_route_raises_when_the_library_cannot_load(
        monkeypatch):
    """The CUDA route of ``FlashAttention`` (and of the backward) goes to
    the kernel library; when it cannot be built or loaded the call raises,
    and the plain version is never called in its place. Meta tensors stand
    in for CUDA tensors past the device check."""
    import contextlib
    import types

    from repro_torch.kernels import build, common, ref
    from repro_torch.kernels import flash_attention as fa

    def no_library(name):
        raise RuntimeError(f"cannot load {name}")

    def no_fallback(*args, **kwargs):
        raise AssertionError("the plain version was called")

    monkeypatch.setattr(build, "load", no_library)
    monkeypatch.setattr(common, "check_flash_operands", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    for name in ("flash_attention_ref", "flash_attention_lse_ref",
                 "flash_attention_bwd_ref"):
        monkeypatch.setattr(ref, name, no_fallback)
    q = torch.empty((1, 4, 8, 16), device="meta", requires_grad=True)
    k = torch.empty((1, 2, 8, 16), device="meta", requires_grad=True)
    with pytest.raises(RuntimeError, match="cannot load flash_attention"):
        fa.FlashAttention.apply(q, k, k, True)
    lse = torch.empty((1, 4, 8), device="meta")
    with pytest.raises(RuntimeError, match="cannot load flash_attention_bwd"):
        fa.flash_attention_bwd(q, k, k, q.detach(), lse, q.detach())

