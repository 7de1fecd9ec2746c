"""Output tokens emitted in the window, over the window's seconds."""
from portbench import readings


def read(run):
    n = sum(readings.in_window(run, t) for r in run.requests
            for t in r.t_tokens)
    return n / run.window_s if n else None
