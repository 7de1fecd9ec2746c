# Copy of src/repro/bench/conversation.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""Multi-turn conversation workloads: the traffic prefix sharing exists for.

ConsumerBench's chatbot app issues independent single-shot requests; real
chat traffic is SESSIONS — a user sends turn after turn, each prompt
carrying the full accumulated history, and every concurrent user's prompt
begins with the same system preamble. That structure is exactly what the
radix prefix cache (:mod:`repro_torch.serving.prefix_cache`) exploits: turn
``t`` re-arrives with turn ``t-1``'s entire prompt as a literal prefix,
and turn 0 of every session shares the system block published by whichever
session finished first.

One :class:`ConversationSpec` describes the session shape; two builders
consume it, one per substrate:

* :func:`conversation_trace` — the simulator/cost side. Emits one
  :class:`~repro_torch.core.simulator.SimRequest` per (session, turn) with
  roofline prefill/decode items at batch 1 and the analytic prefix keys
  (``prefix_key`` = the session, ``prefix_sys_key`` = the app-wide system
  block) the :class:`~repro_torch.core.simulator.PodSimulator` prefix model
  consumes. Arrivals are floors: session ``s`` starts at ``s *
  stagger_s`` and thinks ``think_time_s`` between turns.
* :func:`conversation_prompt` — the engine side. Deterministic LITERAL
  token blocks (shared system block, per-session scripted user/assistant
  turns) so the real trie actually matches: turn ``t``'s prompt is
  byte-for-byte ``prompt(t-1) ++ assistant(t-1) ++ user(t)``.

Keep every block size a multiple of ``lcm(page_size, prefill_chunk)`` and
the two substrates floor hits onto the SAME grid — the fig_prefix parity
check (engine vs. simulator hit rate within 5%) relies on it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, fields

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import costs
from repro_torch.core.costs import WorkItem
from repro_torch.core.simulator import AppTrace, SimRequest
from repro_torch.core.slo import SLO

#: decode tokens per engine step / sim work item (the chatbot chunking)
DECODE_GROUP = 8


@dataclass(frozen=True)
class ConversationSpec:
    """Shape of one multi-turn chat workload (token counts at full scale).

    ``num_requests`` on the enclosing ScenarioApp counts SESSIONS; each
    session issues ``turns`` requests, so an app contributes
    ``sessions * turns`` requests total. Turn ``t``'s prompt is
    ``system_tokens + t * (user_tokens + assistant_tokens) +
    user_tokens`` long; its decode generates ``assistant_tokens``."""
    turns: int = 4
    system_tokens: int = 256       # shared preamble across ALL sessions
    user_tokens: int = 64          # new user message per turn
    assistant_tokens: int = 64     # scripted assistant reply per turn
    think_time_s: float = 2.0      # user think time between turns
    stagger_s: float = 0.25        # session start offsets

    def __post_init__(self):
        if self.turns < 1:
            raise ValueError("conversation needs at least one turn")
        for f in ("system_tokens", "user_tokens", "assistant_tokens"):
            if getattr(self, f) < 1:
                raise ValueError(f"conversation {f} must be positive")
        for f in ("think_time_s", "stagger_s"):
            if getattr(self, f) < 0:
                raise ValueError(f"conversation {f} must be non-negative")

    # ------------------------------------------------------------ geometry
    def prompt_tokens(self, turn: int) -> int:
        return (self.system_tokens
                + turn * (self.user_tokens + self.assistant_tokens)
                + self.user_tokens)

    def max_prompt_tokens(self) -> int:
        return self.prompt_tokens(self.turns - 1)

    # --------------------------------------------------------------- io
    @classmethod
    def from_dict(cls, d: dict) -> "ConversationSpec":
        known = {f.name for f in fields(cls)}
        bad = set(d) - known
        if bad:
            raise ValueError(f"unknown conversation key(s): {sorted(bad)}")
        return cls(**d)

    def to_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}


# ----------------------------------------------------------- sim substrate
def conversation_trace(name: str, cfg: ModelConfig, spec: ConversationSpec,
                       slo: SLO, sessions: int, *, start_s: float = 0.0,
                       background: bool = False) -> AppTrace:
    """All (session, turn) requests of one conversation app, with analytic
    prefix keys. ``rid = session * turns + turn`` — the engine substrate
    recovers (session, turn) from the trace index the same way."""
    ttft = slo.ttft or 1.0
    tpot = slo.tpot or 0.25
    reqs = []
    for s in range(sessions):
        t0 = start_s + s * spec.stagger_s
        for t in range(spec.turns):
            prompt = spec.prompt_tokens(t)
            rid = s * spec.turns + t
            pf, pb, pc = costs.prefill_cost(cfg, 1, prompt)
            items = [WorkItem(name, rid, "prefill", pf, pb, pc,
                              chunkable=True, slo_hint_s=ttft,
                              tokens=prompt)]
            df, db, dc, hf, hb = costs.decode_cost(cfg, 1, prompt)
            left = spec.assistant_tokens
            first = True
            while left > 0:
                n = min(DECODE_GROUP, left)
                items.append(WorkItem(
                    name, rid, "decode", df * n, db * n, dc * n,
                    host_flops=hf * n, host_bytes=hb * n, tokens=n,
                    slo_hint_s=ttft if first else tpot * n))
                left -= n
                first = False
            reqs.append(SimRequest(
                name, rid, t0 + t * spec.think_time_s, items,
                deadline_hint_s=ttft, background=background,
                kv_tokens=prompt + spec.assistant_tokens,
                prefix_key=f"{name}/s{s}", prefix_tokens=prompt,
                prefix_sys_key=f"{name}/sys",
                prefix_sys_tokens=spec.system_tokens))
    return AppTrace(name, slo, reqs, background=background,
                    closed_loop=False)


# -------------------------------------------------------- engine substrate
def conversation_prompt(spec: ConversationSpec, session: int, turn: int,
                        vocab: int, seed: int = 0) -> np.ndarray:
    """Literal prompt tokens for (session, turn): the shared system block
    plus the session's scripted user/assistant history plus the new user
    message. Deterministic in (seed, session) and PREFIX-CONSISTENT across
    turns — turn ``t``'s prompt literally begins with turn ``t-1``'s, so
    the engine's radix trie matches exactly what the analytic model
    predicts."""
    if turn >= spec.turns:
        raise ValueError(f"turn {turn} out of range (spec.turns={spec.turns})")
    sys_block = np.random.default_rng([seed, 0]).integers(
        0, vocab, size=spec.system_tokens)
    # one deterministic per-session token stream, sliced per turn: user and
    # assistant blocks interleave as [u0, a0, u1, a1, ...]
    stream = np.random.default_rng([seed, session + 1]).integers(
        0, vocab, size=spec.turns * (spec.user_tokens
                                     + spec.assistant_tokens))
    history = stream[:turn * (spec.user_tokens + spec.assistant_tokens)
                     + spec.user_tokens]
    return np.concatenate([sys_block, history]).astype(np.int32)


def session_turn(spec: ConversationSpec, trace_idx: int) -> tuple[int, int]:
    """Invert ``rid = session * turns + turn`` (trace order = rid order)."""
    return divmod(trace_idx, spec.turns)


def decode_steps(spec: ConversationSpec) -> int:
    return math.ceil(spec.assistant_tokens / DECODE_GROUP)
