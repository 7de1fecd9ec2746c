"""The port's copies of JAX-free modules equal their originals.

A copy (``src/repro_torch/<path>``) is its original (``src/repro/<path>``)
with a two-line header naming the original and ``repro.`` written
``repro_torch.``. Anything else is a deviation: each is listed below by
file, as (original text, the copy's text with ``repro_torch.`` read back
as ``repro.``), with its reason, and must occur exactly once.
"""
import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1] / "src"
HEADER = ("# Copy of src/repro/{path}: the PyTorch port keeps its own copies "
          "and imports\n# nothing of the JAX package.\n")

COPIES = sorted([
    "bench/__init__.py", "bench/arrival.py", "bench/conversation.py",
    "bench/engine_runner.py", "bench/policy.py", "bench/scenario.py",
    "bench/seeding.py",
    "configs/base.py", "configs/chameleon_34b.py",
    "configs/jamba_v0_1_52b.py", "configs/kimi_k2_1t_a32b.py",
    "configs/mamba2_1_3b.py", "configs/moonshot_v1_16b_a3b.py",
    "configs/qwen3_14b.py", "configs/registry.py",
    "configs/seamless_m4t_large_v2.py", "configs/stablelm_12b.py",
    "configs/stablelm_3b.py", "configs/tinyllama_1_1b.py",
    "core/__init__.py", "core/apps.py", "core/costs.py", "core/dag.py",
    "core/simulator.py", "core/slo.py", "core/workflow.py",
    "kernels/autotune.py",
    "resilience/__init__.py", "resilience/degradation.py",
    "resilience/faults.py",
    "roofline/analysis.py", "roofline/hw.py",
    "serving/block_allocator.py", "serving/prefix_cache.py",
    "serving/request.py", "serving/router.py",
    "telemetry/__init__.py", "telemetry/export.py", "telemetry/host.py",
    "telemetry/recorder.py", "telemetry/requests.py",
    "telemetry/streaming.py", "telemetry/timeline.py",
])

#: path -> [(original text, copy's text, reason)]
DEVIATIONS = {
    "kernels/autotune.py": [
        ('''        import jax
        return str(jax.devices()[0].device_kind).replace(" ", "-").lower()''',
         '''        import torch
        if not torch.cuda.is_available():
            return "cpu"
        return torch.cuda.get_device_name(0).replace(" ", "-").lower()''',
         "device_kind asks torch, not jax.devices(): 'cpu' without a card "
         "(JAX's string on the CPU), else the card's name normalised as "
         "JAX normalises its device kind"),
        ('''".cache", "repro",''', '''".cache", "repro_torch",''',
         "the port's picks live in their own default file, so the two "
         "packages never read each other's entries"),
    ],
    "bench/engine_runner.py": [
        ('''@lru_cache(maxsize=1)
def engine_model():''', '''@lru_cache(maxsize=None)
def engine_model(device: str = "cuda"):''',
         "the vehicle is built on a device, cached per device"),
        ('''    Cached so repeated scenario runs reuse one set of jitted executables."""
    import jax''', '''    Cached per device so repeated scenario runs reuse one set of weights;
    they are drawn from seed 0 by a CPU generator and moved to ``device``,
    so the card and the CPU run the same model."""
    import torch
    from torch.utils._pytree import tree_map''',
         "weights from seed 0 through a torch.Generator, not a JAX key"),
        ('''    model = build_model(cfg)
    params = model.init(jax.random.key(0))''', '''    model = build_model(cfg, device)
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    params = tree_map(lambda t: t.to(model.device), params)''',
         "the port's build_model takes the device; the weights are drawn on "
         "the CPU, whose generator gives one stream on every machine (a CUDA "
         "generator gives another), and moved, so the card and the CPU run "
         "the same model as JAX's key(0) does on every backend"),
        ('''                kv_tok_of: Optional[dict[str, float]] = None):''',
         '''                kv_tok_of: Optional[dict[str, float]] = None,
                device: str = "cuda"):''',
         "the device keyword, passed down to the vehicle"),
        ('''    model, params, ecfg = engine_model()''',
         '''    model, params, ecfg = engine_model(device)''',
         "the device keyword, passed down to the vehicle"),
        ('''def run_scenario_on_engine(sc: Scenario) -> ScenarioResult:''',
         '''def run_scenario_on_engine(sc: Scenario, *,
                           device: str = "cuda") -> ScenarioResult:''',
         "the entry point runs on the card unless asked for the CPU"),
        ('''    schema as the simulator substrate (``substrate`` field aside)."""''',
         '''    schema as the simulator substrate (``substrate`` field aside). The
    engines run on ``device``: the card unless the caller asks for the
    CPU."""''', "the device keyword, documented"),
        ('''        return _run_exclusive(sc)''',
         '''        return _run_exclusive(sc, device)''', "device passed down"),
        ('''        return _run_concurrent(sc)
    return _run_workflow(sc)''', '''        return _run_concurrent(sc, device)
    return _run_workflow(sc, device)''', "device passed down"),
        ('''def _run_concurrent(sc: Scenario) -> ScenarioResult:''',
         '''def _run_concurrent(sc: Scenario, device: str) -> ScenarioResult:''',
         "device passed down"),
        ('''    sim, stats, _ = _run_traces(sc, traces, sc.total_chips,
                                conv_of=conv_of, kv_tok_of=kv_tok_of)''',
         '''    sim, stats, _ = _run_traces(sc, traces, sc.total_chips,
                                conv_of=conv_of, kv_tok_of=kv_tok_of,
                                device=device)''', "device passed down"),
        ('''def _run_exclusive(sc: Scenario) -> ScenarioResult:''',
         '''def _run_exclusive(sc: Scenario, device: str) -> ScenarioResult:''',
         "device passed down"),
        ('''                                 conv_of=conv_of, kv_tok_of=kv_tok_of)''',
         '''                                 conv_of=conv_of, kv_tok_of=kv_tok_of,
                                 device=device)''', "device passed down"),
        ('''def _run_workflow(sc: Scenario) -> ScenarioResult:''',
         '''def _run_workflow(sc: Scenario, device: str) -> ScenarioResult:''',
         "device passed down"),
        ('''        dep_map=dep_map, release=sc.workflow_release)''',
         '''        dep_map=dep_map, release=sc.workflow_release, device=device)''',
         "device passed down"),
    ],
}


def _copy_read_back(path: str) -> str:
    """The copy without its header, ``repro_torch.`` read as ``repro.``."""
    text = (ROOT / "repro_torch" / path).read_text()
    header = HEADER.format(path=path)
    assert text.startswith(header), f"{path}: missing the copy header"
    return re.sub(r"\brepro_torch\.", "repro.", text[len(header):])


@pytest.mark.parametrize("path", COPIES)
def test_copy_equals_its_original(path):
    want = (ROOT / "repro" / path).read_text()
    for orig, port, reason in DEVIATIONS.get(path, []):
        assert want.count(orig) == 1, (path, reason, orig)
        want = want.replace(orig, port)
    assert _copy_read_back(path) == want


def test_every_copy_is_listed():
    """A module carrying the copy header is checked above; none escapes."""
    marked = sorted(
        str(p.relative_to(ROOT / "repro_torch"))
        for p in (ROOT / "repro_torch").rglob("*.py")
        if p.read_text().startswith("# Copy of src/repro/"))
    assert marked == COPIES
    assert set(DEVIATIONS) <= set(COPIES)


def test_encdec_frame_arithmetic_is_the_originals():
    """``models/encdec.py``'s frame arithmetic, which the roofline
    analysis reads, is written as the original writes it (the rest of the
    module is the family's port, held to the JAX package by
    tests/test_torch_families.py)."""
    def defs(path):
        src = (ROOT / path).read_text()
        return {n.targets[0].id if isinstance(n, ast.Assign) else n.name:
                ast.get_source_segment(src, n)
                for n in ast.parse(src).body
                if isinstance(n, (ast.Assign, ast.FunctionDef))}
    port = defs("repro_torch/models/encdec.py")
    orig = defs("repro/models/encdec.py")
    for name in ("FRAME_RATIO", "frames_len"):
        assert port[name] == orig[name]
