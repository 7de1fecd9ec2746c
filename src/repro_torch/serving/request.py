# Copy of src/repro/serving/request.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""Serving request types and synthetic request traces.

Traces mimic the paper's datasets: LMSYS-style chat prompts (lognormal
lengths), Earnings-21-style fixed-cadence audio segments, COCO-caption-style
image prompts. Synthetic token ids — the benchmark measures systems, not
quality.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class Request:
    request_id: int
    prompt: np.ndarray                 # int32 token ids
    max_new_tokens: int
    arrival_s: float = 0.0
    deadline_s: Optional[float] = None  # absolute deadline hint (SLO-aware)
    app: str = ""                      # owning application (scenario runner)
    priority: int = 0                  # admission class (0 = most urgent)
    # filled by the engine:
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None
    tokens_out: list = field(default_factory=list)
    t_tokens: list = field(default_factory=list)
    t_prefill: list = field(default_factory=list)  # per prefill-chunk advance

    @property
    def ttft(self) -> Optional[float]:
        return None if self.t_first_token is None else \
            self.t_first_token - self.arrival_s

    @property
    def tpot(self) -> Optional[float]:
        if len(self.t_tokens) < 2:
            return 0.0 if self.t_tokens else None
        return (self.t_tokens[-1] - self.t_tokens[0]) / (len(self.t_tokens) - 1)


def chat_trace(n: int, vocab: int, *, mean_prompt: int = 64,
               max_new: int = 32, spacing_s: float = 0.0,
               seed: int = 0) -> list[Request]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(np.clip(rng.lognormal(np.log(mean_prompt), 0.4), 4, 4 * mean_prompt))
        out.append(Request(
            request_id=i,
            prompt=rng.integers(0, vocab, size=plen).astype(np.int32),
            max_new_tokens=max_new,
            arrival_s=i * spacing_s,
        ))
    return out


def segment_trace(n: int, vocab: int, *, cadence_s: float = 2.0,
                  frames: int = 32, new_tokens: int = 16,
                  seed: int = 0) -> list[Request]:
    """LiveCaptions: a segment every ``cadence_s`` seconds."""
    rng = np.random.default_rng(seed)
    return [Request(
        request_id=i,
        prompt=rng.integers(0, vocab, size=frames).astype(np.int32),
        max_new_tokens=new_tokens,
        arrival_s=i * cadence_s,
        deadline_s=i * cadence_s + cadence_s,
    ) for i in range(n)]
