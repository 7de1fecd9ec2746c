# Copy of src/repro/bench/seeding.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""Deterministic seed derivation: every stochastic path in a scenario run
(arrival processes, synthetic prompts, fault schedules) draws from a child
of ONE root — ``Scenario.seed`` — through :func:`numpy.random.SeedSequence`.

Ad-hoc schemes like ``seed + idx`` collide across namespaces (app 1's
arrivals vs. trace 0's prompts) and correlate neighbouring streams;
``SeedSequence`` spawn keys give independent, collision-free streams while
staying bit-stable across platforms and numpy versions (the spawn-key
expansion is part of numpy's compatibility guarantee). String path
components hash through ``zlib.crc32``, which is stable by definition
(RFC 1952), so the derivation itself never depends on ``PYTHONHASHSEED``.

Two runs of the same YAML therefore produce byte-identical result
documents — pinned in tests/test_resilience.py.
"""
from __future__ import annotations

import zlib

import numpy as np


def _key(part) -> int:
    if isinstance(part, (int, np.integer)):
        return int(part)
    return zlib.crc32(str(part).encode("utf-8"))


def child_sequence(root: int, *path) -> np.random.SeedSequence:
    """The :class:`~numpy.random.SeedSequence` for ``path`` under ``root``."""
    return np.random.SeedSequence(int(root),
                                  spawn_key=tuple(_key(p) for p in path))


def child_seed(root: int, *path) -> int:
    """A stable derived integer seed (for APIs that take a plain int)."""
    return int(child_sequence(root, *path).generate_state(1, np.uint32)[0])


def child_rng(root: int, *path) -> np.random.Generator:
    """An independent Generator for the stream named by ``path``."""
    return np.random.default_rng(child_sequence(root, *path))
