"""Share of the requests due in the window that met the mix's SLO
(ConsumerBench's chatbot: TTFT <= 1 s and the request's mean time per
output token <= 0.25 s), in %; a request not finished by the drain's end
missed it."""


def read(run):
    slo = run.cell.mix["slo"]
    if not run.due:
        return None
    met = sum(r.t_done is not None and r.ttft <= slo["ttft_s"]
              and (r.tpot or 0.0) <= slo["tpot_s"] for r in run.due)
    return 100.0 * met / len(run.due)
