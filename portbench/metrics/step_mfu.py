"""The whole step's share of the card's dense bfloat16 peak: model FLOPs
of the window's steps over their host wall times (``readings.step_mfu``),
in %."""
from portbench import readings


def read(run):
    return readings.step_mfu(run)
