"""The distributed layer's JAX-free modules: the hints and the per-cell
hint table (copies). Sharding, pipelining and the shard_map MoE wait for
the port's device mesh."""
