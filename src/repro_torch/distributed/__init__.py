"""The distributed layer: the hints and the per-cell hint table (copies),
the sharding rules with their DTensor placements, and the GPipe schedule
over a stage axis (:mod:`~repro_torch.distributed.pipeline`)."""
