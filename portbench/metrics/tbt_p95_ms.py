"""95th percentile of every gap between consecutive output tokens of a
request, over all tokens emitted in the window, in ms."""
from portbench import readings


def read(run):
    gaps = readings.token_gaps_s(run)
    p = readings.percentile(gaps, 95)
    return None if p is None else 1e3 * p
