"""99th percentile of every gap between consecutive output tokens of a
request, over all tokens emitted in the window, in ms: in the chat cell
the stall a streaming user sees while another prompt is prefilled."""
from portbench import readings


def read(run):
    p = readings.percentile(readings.token_gaps_s(run), 99)
    return None if p is None else 1e3 * p
