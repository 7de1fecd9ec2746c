"""The distributed layer: the hints and the per-cell hint table (copies)
and the sharding rules with their DTensor placements. Pipelining waits
for its own slice."""
