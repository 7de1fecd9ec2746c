"""The knee of an open-loop cell: its traffic at a list of rates (on the card).

    python3 portbench/sweep.py --workload chat.chameleon --rates 0.4,0.8,1.2 \\
        --seconds 50 [--seed N]

In one process, one run of the cell a rate (the mix's ``rate_per_s``
replaced), output not checked. A line a rate: the SLO attainment, the
TTFT p50 and p90, the token gaps' p50/p95/p99, the requests due in the
window still waiting for their first token at its close (the backlog)
and those not finished by the drain's end. The knee is the highest rate
at which 90% of the requests meet the SLO without a backlog that grows
through the window; the cell runs at about four fifths of it, a number
written into its mix.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from portbench.run import ROOT, log, prepare  # noqa: E402


def knee(rows: list) -> float | None:
    """The highest rate at which, as at every lower rate, at least 90% of
    the requests due in the window met the SLO, every one finished, no
    more than two seconds' worth of arrivals still wait for a first token
    at the window's close, and the second half's TTFT p90 is within twice
    the first half's (plus 1 s)."""
    best = None
    for r in sorted(rows, key=lambda r: r["rate_per_s"]):
        ok = (r["failed"] == 0 and r["slo_attainment"] >= 90.0
              and r["waiting_at_close"] <= max(2, 2 * r["rate_per_s"])
              and r["ttft_p90_second_half"]
              <= 2 * r["ttft_p90_first_half"] + 1.0)
        if not ok:
            break
        best = r["rate_per_s"]
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=50.0)
    ap.add_argument("--seed", type=int, default=2**31 + 55)
    a = ap.parse_args(argv)
    if not prepare():
        return 2
    from portbench import harness, readings
    cell = harness.load_cell(a.workload, ROOT)
    rows = []
    for rate in (float(r) for r in a.rates.split(",")):
        cell.mix["rate_per_s"] = rate
        got = {}

        def on_run(run, _readings):
            half = run.w0 + run.window_s / 2
            first = [r for r in run.due if r.arrival_s < half]
            second = [r for r in run.due if r.arrival_s >= half]
            ttft = lambda rs: readings.percentile(
                [readings.ttft_s(run, r) for r in rs], 90)
            gaps = readings.token_gaps_s(run)
            got.update(
                waiting_at_close=sum(r.t_first_token is None
                                     or r.t_first_token >= run.w1
                                     for r in run.due),
                slo_attainment=harness.load_reader("slo_attainment")(run),
                ttft_p50=readings.percentile(
                    [readings.ttft_s(run, r) for r in run.due], 50),
                ttft_p90_first_half=ttft(first),
                ttft_p90_second_half=ttft(second),
                **{f"tbt_p{q}_ms": 1e3 * readings.percentile(gaps, q)
                   for q in (50, 95, 99)},
                step_count=len(run.steps))
        out = harness.execute(cell, a.seed, a.seconds, False, "cuda",
                              log=log, judge=False, on_run=on_run)
        got.update(rate_per_s=rate, attempted=out["attempted"],
                   failed=out["failed"],
                   **{k: v["value"] for k, v in out["metrics"].items()})
        print(json.dumps(got), flush=True)
        rows.append(got)
    k = knee(rows)
    print(json.dumps({"knee_per_s": k,
                      "cell_rate_per_s": None if k is None
                      else round(0.8 * k, 3)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
