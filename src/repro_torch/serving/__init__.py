"""Serving: request types, page allocator, prefix cache, engine."""
