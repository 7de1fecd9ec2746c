"""90th percentile, over the requests due in the window, of the wait from
arrival to admission (the engine's ``admit`` instants, recorded in a
traced run); one never admitted waits until the drain's end."""
from portbench import readings


def read(run):
    if not run.admits:
        return None
    return readings.percentile(
        [run.admits.get(r.request_id, run.t_end) - r.arrival_s
         for r in run.due], 90)
