"""Share of the model step's projections that took the skinny GEMM kernel
in the decode steps: 100 x the sum of ``proj_kernel`` over the sum of
``proj_calls`` of the engine's ``engine.decode`` scopes begun in the
window, in %. None where the scopes do not count ``proj_calls`` (a program
without the kernel's route) or count none."""
from portbench import spans


def read(run):
    found = spans.window_scopes(run, "engine.decode")
    if not found or any("proj_calls" not in s.counts for s in found):
        return None
    calls = sum(s.counts["proj_calls"] for s in found)
    if calls == 0:
        return None
    return 100.0 * sum(s.counts["proj_kernel"] for s in found) / calls
