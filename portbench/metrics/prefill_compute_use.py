"""Share of the rows the model computed in the prefill dispatches that
carried real prompt tokens: 100 x the sum of ``useful`` over the sum of
``computed`` x ``width`` of the engine's ``engine.prefill`` scopes begun in
the window, in %. None where the scopes do not count ``computed`` (a
program that runs every slot's row, and says so with ``rows`` alone)."""
from portbench import spans


def read(run):
    found = spans.window_scopes(run, "engine.prefill")
    if not found or any("computed" not in s.counts for s in found):
        return None
    cells = sum(s.counts["computed"] * s.counts["width"] for s in found)
    return 100.0 * sum(s.counts["useful"] for s in found) / cells
