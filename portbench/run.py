"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (imports, CUDA context, the kernels'
build where there is none yet, weights drawn from the seed, engine,
warm-up), then the cell's traffic through ``repro_torch``'s serving
engine: a ramp, the measured window of ``--seconds``, a drain; then the
served tokens are checked against the plain reference. The last line of
standard output is the result as JSON; the numbers compared for
``correct`` are the last lines of standard error. Exits non-zero, with
no result, without a CUDA card (or fewer than the cell needs), without
``src/repro_torch`` beside it, or if JAX or the JAX package was loaded.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def prepare() -> bool:
    """Every cache of the program at a fixed place inside the checkout, and
    the port and the harness importable; False without the port."""
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(CACHE / "autotune.json")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    if not (ROOT / "src" / "repro_torch").is_dir():
        log("portbench: no src/repro_torch in this checkout")
        return False
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    if not prepare():
        return 2
    import torch
    from portbench import harness
    cell = harness.load_cell(a.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"portbench: {a.workload} needs {cell.chips} CUDA card(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    out = harness.execute(cell, a.seed, a.seconds, bool(a.trace), "cuda",
                          T_START, log=log)
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        log(f"portbench: JAX or the JAX package was loaded: {', '.join(bad)}")
        return 4
    for name, c in out["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
