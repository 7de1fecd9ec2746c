"""1 - device busy (the union of the traced slice's device operations)
over the slice's wall time, in %."""
from portbench import readings


def read(run):
    return readings.device_idle(run)
