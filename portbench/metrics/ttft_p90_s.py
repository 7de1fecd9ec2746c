"""90th percentile of time to first token over every request due in the
window, from its arrival; one without a first token by the drain's end
counts as waiting until then."""
from portbench import readings


def read(run):
    return readings.percentile([readings.ttft_s(run, r) for r in run.due], 90)
