"""The harness finds every cell, configuration, mix, limit and metric by
name; a new mix and a new metric run without an edit to any file; and
nothing under portbench/ loads JAX or the JAX package."""
import ast
import json
from pathlib import Path

import pytest

from portbench.tests.tiny import REPO, few_threads, run_tiny, tiny_root  # noqa: F401

BENCH = REPO / "portbench"
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_are_found_by_name(cell):
    from portbench import harness
    from portbench.reference import transformer as ref
    c = harness.load_cell(cell, REPO)
    assert c.metrics and c.per_layer and c.limits
    assert "setup_s" in {m["name"] for m in c.metrics}
    cfg = harness.program_config(c.config)        # the port agrees
    shapes = ref.param_shapes(c.config["model"])
    assert shapes["embedding"][1] == cfg.d_model
    for m in c.per_layer:
        assert m["moves"] in {e["name"] for e in c.metrics}


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    SPEC["end_to_end"] + SPEC["per_layer"]])
def test_every_metric_has_a_reader(metric):
    from portbench import harness
    assert callable(harness.load_reader(metric))


def test_a_new_mix_and_metric_run_without_edits(tiny_root, few_threads):
    bench = tiny_root / "portbench"
    mix = json.loads((bench / "traffic" / "tiny_open.json").read_text())
    mix["rate_per_s"] = 6.0
    (bench / "traffic" / "burst.json").write_text(json.dumps(mix))
    (bench / "metrics" / "rows_served.py").write_text(
        "def read(run):\n    return float(len(run.dispatches))\n")
    (bench / "limits" / "t.burst.json").write_text(
        (bench / "limits" / "t.open.json").read_text())
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "t.burst", "config": "tiny_dense",
                              "traffic": "burst", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "rows_served", "unit": "n",
                              "better": "higher", "source": "host_clock",
                              "layer": "scheduler", "moves": "tbt_p95_ms",
                              "workloads": ["t.burst"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    out = run_tiny(tiny_root, "t.burst", traced=True)
    assert out["correct"]
    assert out["metrics"]["rows_served"]["value"] > 0
    assert list(out)[-1] == "checks"


def test_forbidden_modules_by_whole_top_level_name():
    from portbench import harness
    names = ["jax.numpy", "jaxlib", "flax.linen", "repro", "repro.core.slo",
             "repro_torch", "repro_torch.models.moe", "jaxtyping", "reprox",
             "portbench.harness"]
    assert harness.forbidden_modules(names) == [
        "flax.linen", "jax.numpy", "jaxlib", "repro", "repro.core.slo"]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "repro"}
    assert "bench" "marks/" not in path.read_text()     # the JAX package's


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert _imports(path) <= {"__future__", "contextlib", "math",
                              "dataclasses", "numpy", "torch"}
