"""The paged decode kernel's least time (``roofline.decode_bound_s``) over
its profiled time, summed over the traced slice's launches, in %."""
from portbench import readings


def read(run):
    return readings.kernel_roofline(run, "decode", "paged_decode_kernel")
