"""Tiny cells on the CPU for the harness's tests, with their fixtures
(the test modules import both): a copy of ``portbench/`` and a
``BENCHMARK.json`` beside it in a temporary directory, configurations cut
to a few dozen widths and mixes of a second or two."""
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {"num_layers": 2, "d_model": 128, "num_heads": 4, "head_dim": 32,
        "vocab_size": 8192, "vocab_pad_multiple": 16, "rope_theta": 10000.0,
        "norm_eps": 1e-05, "tie_embeddings": False}
TINY_DENSE = dict(TINY, family="vlm", num_kv_heads=2, d_ff=256,
                  use_qk_norm=True)
OPEN = {"kind": "open_poisson", "rate_per_s": 60.0, "ramp_s": 0.3,
        "base_seed": 1,
        "prompt": {"dist": "lognormal", "median": 20, "sigma": 0.8,
                   "min": 4, "max": 40},
        "output": {"dist": "lognormal", "median": 24, "sigma": 0.5,
                   "min": 8, "max": 40},
        "slo": {"ttft_s": 1.0, "tpot_s": 0.25},
        "engine": {"max_slots": 16, "max_seq": 96, "policy": "mixed",
                   "prefill_chunk": 16, "page_size": 8},
        "check": {"requests": 1000},
        "trace": {"at": 0.3, "steps": 4, "min_prefill": 0, "max_steps": 8},
        "drain_s": 60}
CLOSED = {"kind": "closed_loop", "clients": 3, "per_client": 400,
          "stagger_s": 0.2, "think_s": 0.0, "base_seed": 2,
          "prompt": {"dist": "uniform", "min": 4, "max": 12},
          "output": {"dist": "fixed", "value": 12},
          "engine": {"max_slots": 4, "max_seq": 32, "policy": "mixed",
                     "prefill_chunk": 16, "page_size": 8},
          "check": {"requests": 2},
          "trace": {"at": 0.3, "steps": 4, "max_steps": 4},
          "drain_s": 60}
#: set as the cells' limits are: the port on the CPU reads 0 on every seed
#: tried; the TF32 control at least 3.8e-4 (widest) and 7.0e-7 (mean) on
#: eight seeds of the open cell (its argmax flips at 0.14-0.43% of tokens)
LIMITS = {"max_gap": {"limit": 5e-5}, "mean_gap": {"limit": 5e-8}}


def tiny_config(model: dict, arch: str) -> dict:
    over = {k: v for k, v in model.items() if k != "family"}
    return {"arch": arch, "reference": "transformer",
            "port_overrides": over, "model": model}


def make_root(tmp: Path) -> Path:
    """``tmp`` holding a copy of ``portbench/`` and a BENCHMARK.json of the
    real metrics with two tiny cells of one configuration (grouped heads
    with qk-norm): ``t.open`` (open loop) and ``t.dense`` (closed loop)."""
    bench = tmp / "portbench"
    shutil.copytree(REPO / "portbench", bench,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (bench / "configs" / "tiny_dense.json").write_text(
        json.dumps(tiny_config(TINY_DENSE, "chameleon-34b")))
    (bench / "traffic" / "tiny_open.json").write_text(json.dumps(OPEN))
    (bench / "traffic" / "tiny_closed.json").write_text(json.dumps(CLOSED))
    for cell in ("t.open", "t.dense"):
        (bench / "limits" / f"{cell}.json").write_text(json.dumps(LIMITS))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"] = [
        {"name": "tiny_dense", "source": "x",
         "file": "portbench/configs/tiny_dense.json", "reduced": [],
         "why": "x"}]
    spec["workloads"] = [
        {"name": "t.open", "config": "tiny_dense", "traffic": "tiny_open",
         "chips": 1, "why": "x"},
        {"name": "t.dense", "config": "tiny_dense", "traffic": "tiny_closed",
         "chips": 1, "why": "x"}]
    real = {"chat.chameleon": "t.open", "imagegen.chameleon": "t.dense"}
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [real[w] for w in m["workloads"]]
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)


@pytest.fixture
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run_tiny(root: Path, cell: str, *, seed: int = 2**31 + 11,
             seconds: float = 1.0, traced: bool = False, fault=None,
             control: bool = False, readings: dict | None = None):
    """One CPU run of a tiny cell; ``readings`` (a dict) receives the
    check's readings."""
    from portbench import harness
    c = harness.load_cell(cell, root, root / "portbench")
    return harness.execute(c, seed, seconds, traced, "cpu", fault=fault,
                           log=lambda s: None, control=control,
                           on_run=(None if readings is None else
                                   lambda run, r: readings.update(r)))
