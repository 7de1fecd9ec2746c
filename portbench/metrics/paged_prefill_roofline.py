"""The paged prefill kernel's least time (``roofline.prefill_bound_s``)
over its profiled time, summed over the traced slice's launches, in %."""
from portbench import readings


def read(run):
    return readings.kernel_roofline(run, "prefill", "paged_prefill_kernel")
