"""Share of the prefill dispatches' batch rows x width that carried real
prompt tokens: 100 x the sum of ``useful`` over the sum of ``rows`` x
``width`` of the engine's ``engine.prefill`` scopes begun in the window,
in %. A piece runs every slot's row at the widest row's tokens."""
from portbench import spans


def read(run):
    found = spans.window_scopes(run, "engine.prefill")
    if not found:
        return None
    cells = sum(s.counts["rows"] * s.counts["width"] for s in found)
    return 100.0 * sum(s.counts["useful"] for s in found) / cells
