"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's.

* the mini cells of ``tests/test_distributed.py``'s
  ``test_mini_dryrun_train_and_decode`` (five archs, reduced, train and
  decode, 8 x 64, on a ``(4, 4)`` mesh of a 16-rank fake process group)
  run; every collective the run issues is seen both by ``CommDebugMode``
  and by the per-kind byte count, and the per-device argument bytes equal
  XLA's ``memory_analysis().argument_size_in_bytes`` for tinyllama-1.1b
  and moonshot-v1-16b-a3b, train and decode;
* the elastic re-mesh of ``test_elastic_remesh_shrink_lowering``: the
  same train cell on ``(dp, 4)`` meshes, dp 4, 3 and 2;
* ``cell_is_applicable``'s skips and ``model_flops_for`` equal JAX's for
  every config and shape;
* ``main`` on a production cell (tinyllama-1.1b x decode_32k under
  ``--autotune``, 256 fake ranks) writes a document with every key of
  JAX's ``run_cell`` output and ``main``'s, and a second ``main`` on the
  same ``--out`` resumes: it runs nothing and appends nothing.

Each side runs in a subprocess (a process has one default process group;
JAX needs its forced host devices before it starts).

``python tests/test_torch_dryrun.py`` prints, for the ten mini cells, the
port's per-device FLOPs, bytes accessed and collective bytes beside JAX's
depth-extrapolated ones (``extrapolated_costs``, as ``run_cell`` reports)
and their ratios: eager PyTorch and XLA count different ops, so they are
recorded, not held equal.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ["tinyllama-1.1b", "mamba2-1.3b", "jamba-v0.1-52b",
         "moonshot-v1-16b-a3b", "seamless-m4t-large-v2"]
BYTES_ARCHS = ["tinyllama-1.1b", "moonshot-v1-16b-a3b"]

PORT_SIDE = """
import json, sys, time
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import CONFIGS
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
dryrun.init_fake_group(16)
mesh = make_mesh((4, 4), ("data", "model"))
out = {}
for name in %(archs)r:
    cfg = CONFIGS[name].reduced()
    for kind in ("train", "decode"):
        outputs, c, mf = dryrun.lower_cell(cfg, ShapeConfig("t", 64, 8, kind),
                                           mesh)
        det = c.collective_detail()
        out[f"{name}/{kind}"] = dict(
            flops=c.flops, bytes=c.bytes_accessed, coll=det["total_bytes"],
            count=det["total_count"], comm_debug=c.comm_debug_counts,
            argument_bytes=c.argument_bytes, output_bytes=c.output_bytes,
            model_flops=mf)
cfg = CONFIGS["tinyllama-1.1b"].reduced()
for dp in (4, 3, 2):   # lose data shards, remesh, rerun
    _, c, _ = dryrun.lower_cell(cfg, ShapeConfig("t", 64, 8, "train"),
                                make_mesh((dp, 4), ("data", "model")))
    out[f"elastic/{dp}"] = c.argument_bytes
json.dump(out, open(sys.argv[1], "w"))
"""

JAX_SIDE = """
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
import jax
from repro.configs.base import ShapeConfig
from repro.configs.registry import CONFIGS
from repro.launch import dryrun
from repro.roofline import analysis
mesh = jax.make_mesh((4, 4), ("data", "model"))
extrapolate = sys.argv[3] == "1"
out = {}
for name in json.loads(sys.argv[2]):
    cfg = CONFIGS[name].reduced()
    for kind in ("train", "decode"):
        shape = ShapeConfig("t", 64, 8, kind)
        _, compiled, mf = dryrun.lower_cell(cfg, shape, mesh)
        m = compiled.memory_analysis()
        d = dict(argument_bytes=m.argument_size_in_bytes,
                 output_bytes=m.output_size_in_bytes, model_flops=mf)
        if extrapolate:
            f, b, c, _ = dryrun.extrapolated_costs(cfg, shape, mesh, "full")
            d.update(flops=f, bytes=b, coll=c)
        out[f"{name}/{kind}"] = d
json.dump(out, open(sys.argv[1], "w"))
"""


MAIN = """
import sys
from repro_torch.launch import dryrun
args = ["--arch", "tinyllama-1.1b", "--shape", "decode_32k", "--autotune",
        "--out", sys.argv[1]]
dryrun.main(args)
dryrun.main(args)
"""


def _start(code: str, args) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code),
                             *map(str, args)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)


def _wait(proc: subprocess.Popen, timeout: int) -> str:
    out = proc.communicate(timeout=timeout)[0]
    assert proc.returncode == 0, out[-6000:]
    return out


def _run(code: str, args, timeout: int) -> str:
    return _wait(_start(code, args), timeout)


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """The port's mini cells, JAX's and ``main``'s production cell, run
    side by side."""
    d = tmp_path_factory.mktemp("dry")
    procs = [_start(PORT_SIDE % dict(archs=ARCHS), [d / "port.json"]),
             _start(JAX_SIDE, [d / "jax.json", json.dumps(BYTES_ARCHS), 0]),
             _start(MAIN, [d / "cells.jsonl"])]
    outs = [_wait(p, 400) for p in procs]
    return (json.loads((d / "port.json").read_text()),
            json.loads((d / "jax.json").read_text()),
            (d / "cells.jsonl").read_text(), outs[2])


@pytest.fixture(scope="module")
def port(sides):
    return sides[0]


@pytest.fixture(scope="module")
def jax_side(sides):
    return sides[1]


#: the collectives a device issues in tinyllama-1.1b's mini train cell, by
#: torch release: where the port does not place an op the release's
#: DTensor rules choose, so a new release may move the count, and then
#: this fails until the pin (and PERF.md's reading of it) is renewed
PINNED_COLLECTIVES = {"2.11": 132, "2.13": 235}


def test_mini_cell_collective_count_is_pinned(port):
    """tinyllama-1.1b's mini train cell issues the collectives pinned for
    this torch release."""
    release = ".".join(torch.__version__.split(".")[:2])
    count = port["tinyllama-1.1b/train"]["count"]
    assert release in PINNED_COLLECTIVES, (
        f"no pin for torch {release}: the cell issues {count} collectives")
    assert count == PINNED_COLLECTIVES[release]


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_mini_cell_runs_and_counts_its_collectives(port, arch, kind):
    """The cell runs on the fake mesh without allocating; CommDebugMode
    counts as many collectives as the per-kind byte count, which is not
    empty (a sharded step communicates); FLOPs and bytes are counted."""
    c = port[f"{arch}/{kind}"]
    assert c["comm_debug"] == c["count"] > 0
    assert c["coll"] > 0 and c["flops"] > 0 and c["bytes"] > 0


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("arch", BYTES_ARCHS)
def test_argument_bytes_match_xla(port, jax_side, arch, kind):
    """A device's argument bytes — params, ZeRO-1 optimizer state and
    batch, or params, cache, tokens and lengths — from the placements'
    shard shapes equal XLA's ``argument_size_in_bytes`` for the same
    specs; so do the cells' MODEL_FLOPS."""
    p, j = port[f"{arch}/{kind}"], jax_side[f"{arch}/{kind}"]
    assert p["argument_bytes"] == j["argument_bytes"]
    assert p["model_flops"] == j["model_flops"]


def test_elastic_remesh_shrink(port):
    """The same train cell reruns on meshes with fewer data shards; a
    device holds the least on the widest (ZeRO-1 state over the most
    shards; at dp 3 most dims do not divide and stay replicated)."""
    got = [port[f"elastic/{dp}"] for dp in (4, 3, 2)]
    assert 0 < got[0] < min(got[1:])


def test_cell_applicability_and_model_flops_match_jax():
    from repro.configs.registry import CONFIGS as JCONFIGS
    from repro.configs.shapes import SHAPES as JSHAPES
    from repro.configs.shapes import cell_is_applicable as japplicable
    from repro.roofline.analysis import model_flops_for as jflops
    from repro_torch.configs.registry import CONFIGS
    from repro_torch.configs.shapes import SHAPES, cell_is_applicable
    from repro_torch.roofline.analysis import model_flops_for
    skipped = 0
    for name in JCONFIGS:
        for sname in JSHAPES:
            ok, why = cell_is_applicable(CONFIGS[name], SHAPES[sname])
            assert (ok, why) == japplicable(JCONFIGS[name], JSHAPES[sname])
            skipped += not ok
            assert model_flops_for(CONFIGS[name], SHAPES[sname]) == \
                jflops(JCONFIGS[name], JSHAPES[sname])
    assert skipped


def test_main_document_keys_and_resume(sides):
    """``main`` writes one line for the cell, ``status`` ok, with every key
    of JAX's ``run_cell`` document (``RooflineResult.to_dict()``,
    ``memory_analysis``, ``compile_s``, ``cost_compile_s``) and ``main``'s
    (``status``, ``hints`` under ``--autotune``); its ``notes`` name what
    counted each term and its seconds the simulated chip. Run again on
    the same ``--out``, it skips the cell."""
    import dataclasses

    from repro.roofline import analysis as janalysis
    text, stdout = sides[2], sides[3]
    lines = text.splitlines()
    assert len(lines) == 1, lines
    doc = json.loads(lines[0])
    fields = {f.name: 0 for f in dataclasses.fields(
        janalysis.RooflineResult) if f.default is dataclasses.MISSING}
    fields.update(arch="a", shape="s", mesh="m")
    want = set(janalysis.RooflineResult(**fields).to_dict()) | {
        "memory_analysis", "compile_s", "cost_compile_s", "status", "hints"}
    assert set(doc) == want
    assert doc["status"] == "ok" and doc["mesh"] == "16x16(data,model)"
    assert doc["hints"] == "autotune:kv_cache_dtype=int8;remat=full"
    assert doc["chips"] == 256 and "tpu-v5e" in doc["notes"]
    # what counted each term: not XLA's counts
    assert "flop_registry" in doc["notes"] and "unfused" in doc["notes"]
    assert f"torch {torch.__version__}" in doc["notes"]
    assert isinstance(doc["memory_analysis"]["argument_bytes"], int)
    assert stdout.count("[dryrun] OK") == 1
    assert "all 0 cells done" in stdout


if __name__ == "__main__":
    # the ratio table: port / JAX per-device FLOPs, bytes, collective bytes
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        _run(PORT_SIDE % dict(archs=ARCHS), [f"{d}/p.json"], 900)
        _run(JAX_SIDE, [f"{d}/j.json", json.dumps(ARCHS), 1], 1800)
        p = json.load(open(f"{d}/p.json"))
        j = json.load(open(f"{d}/j.json"))
    print("cell | FLOPs port / JAX | bytes port / JAX | collective bytes "
          "port / JAX")
    for key in j:
        row = [key]
        for m in ("flops", "bytes", "coll"):
            row.append(f"{p[key][m]:.4g} / {j[key][m]:.4g} = "
                       f"{p[key][m] / j[key][m]:.3f}" if j[key][m] else
                       f"{p[key][m]:.4g} / 0")
        print(" | ".join(row))
