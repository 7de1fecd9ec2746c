"""The readings that the limits of ``correct`` are set from (on the card).

    python3 portbench/control.py --workload <cell> --seeds 12 --control 3 \\
        --seconds 15 [--first-seed N] [--rate R]

In one process, for each of ``--seeds`` seeds: a run of the cell at its
own load with a window of ``--seconds`` (long enough to finish the mix's
longest requests), judged as a run judges it; on the first ``--control``
seeds also the control: the reference in TF32, put in the program's
place, read at the same prompts and served tokens (the token TF32 puts
first is its served token) and judged by the cell's limits as the
program is. One JSON line a seed on standard output; exits 1 if the
control came out correct on any seed. ``--rate`` replaces an open mix's
rate (readings at a rate before it is written into the mix). The
benchmark's own runs never run the control.
"""
import sys
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from portbench.run import ROOT, log, prepare  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--first-seed", type=int, default=2**31 + 101)
    ap.add_argument("--rate", type=float, default=None)
    a = ap.parse_args(argv)
    if not prepare():
        return 2
    import torch
    from portbench import harness
    cell = harness.load_cell(a.workload, ROOT)
    if a.rate is not None:
        cell.mix["rate_per_s"] = a.rate
    control_passed = 0
    for i in range(a.seeds):
        seed = a.first_seed + 7919 * i
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        got = {}
        out = harness.execute(cell, seed, a.seconds, False, "cuda",
                              log=log, control=i < a.control,
                              on_run=lambda run, r: got.update(r))
        print(json.dumps({"seed": seed, "correct": out["correct"],
                          "attempted": out["attempted"],
                          "failed": out["failed"], "readings": got,
                          "seconds": time.monotonic() - t0}), flush=True)
        control_passed += bool(got.get("control_correct"))
    if control_passed:
        log(f"portbench: the control came out correct on {control_passed} "
            "seed(s): the limits do not separate it")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
