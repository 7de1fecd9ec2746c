"""Traffic generators, found by a mix's ``kind``.

A mix is a JSON file of parameters (``traffic/<mix>.json``). Its
``kind`` names one generator below; the generator turns the parameters
and ``--seed`` into :class:`Plan` objects: requests with a prompt of
token ids, a number of tokens to serve, and an arrival offset (open loop)
or a client (closed loop).

Every seed serves the same work: the lengths, and for the open loop the
inter-arrival gaps, are drawn once from the mix's ``base_seed``; the
token ids are drawn from ``--seed``. The open loop keeps the base
schedule's order too: which long prompts arrive close together sets its
tails, and over the 40 requests a window holds at the knee, six orders
of one set of lengths and gaps read TTFT p90 0.24-0.53 s where two runs
of one order agree within 8% (PERF.md). The closed loop's order (which
client gets which prompt length) is drawn from ``--seed``.

The processes copy ``repro_torch.bench.arrival``'s Poisson process
(exponential gaps at ``rate_per_s``) and ConsumerBench's closed-loop
clients (``core/apps.py``: ImageGen's next request when the last is done).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

GENERATORS: dict = {}


def generator(kind: str):
    def deco(fn):
        GENERATORS[kind] = fn
        return fn
    return deco


@dataclass
class Plan:
    """One request as the client will send it."""
    index: int
    prompt: np.ndarray          # int32 token ids
    max_new_tokens: int
    offset_s: float = 0.0       # open loop: arrival after the ramp's start
    in_window: bool = True      # open loop: due inside the measured window


@dataclass
class Traffic:
    kind: str
    plans: list = field(default_factory=list)   # open: all; closed: per client
    ramp_s: float = 0.0
    clients: int = 0
    stagger_s: float = 0.0


def lengths(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` lengths from ``spec``: ``lognormal`` (median, sigma, clipped
    to [min, max]), ``uniform`` (min..max inclusive) or ``fixed`` (value)."""
    dist = spec["dist"]
    if dist == "fixed":
        return np.full(n, int(spec["value"]), np.int64)
    if dist == "uniform":
        return rng.integers(int(spec["min"]), int(spec["max"]) + 1, size=n)
    if dist == "lognormal":
        x = rng.lognormal(math.log(spec["median"]), spec["sigma"], size=n)
        return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)
    raise ValueError(f"unknown length distribution {dist!r}")


def _prompts(lens, vocab: int, rng: np.random.Generator) -> list:
    return [rng.integers(0, vocab, size=int(n)).astype(np.int32)
            for n in lens]


def _gaps(rate: float, n: int, span: float, rng) -> np.ndarray:
    """``n`` exponential gaps at ``rate``, scaled so that they sum to
    ``span``: the count and the span stay fixed, the shape is Poisson's."""
    g = rng.exponential(1.0 / rate, size=n)
    return g * (span / g.sum())


@generator("open_poisson")
def open_poisson(mix: dict, seconds: float, seed: int, vocab: int) -> Traffic:
    """Open loop: Poisson arrivals at ``rate_per_s`` over a ramp of
    ``ramp_s`` and the window of ``seconds``; arrivals stop at the window's
    end. Prompt and output lengths from ``prompt`` and ``output``."""
    rate, ramp = float(mix["rate_per_s"]), float(mix["ramp_s"])
    n_ramp, n_win = round(rate * ramp), max(1, round(rate * seconds))
    base = np.random.default_rng(mix["base_seed"])
    parts = []
    for n, span in ((n_ramp, ramp), (n_win, seconds)):
        parts.append((_gaps(rate, n, span, base) if n else np.zeros(0),
                      lengths(mix["prompt"], n, base),
                      lengths(mix["output"], n, base)))
    rng = np.random.default_rng([seed, 1])
    plans, t0 = [], 0.0
    for k, (gaps, plen, olen) in enumerate(parts):
        # the window's first arrival lands at its start, a ramp's at 0
        offs = t0 + np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
        prompts = _prompts(plen, vocab, rng)
        for i in range(len(gaps)):
            plans.append(Plan(len(plans), prompts[i], int(olen[i]),
                              offset_s=float(offs[i]), in_window=k == 1))
        t0 = ramp
    return Traffic("open_poisson", plans, ramp_s=ramp)


@generator("closed_loop")
def closed_loop(mix: dict, seconds: float, seed: int, vocab: int) -> Traffic:
    """Closed loop: ``clients`` clients, each sending its next request
    ``think_s`` after its last is done; client ``i`` starts ``i *
    stagger_s`` into the ramp, so the clients do not move in step. The
    ramp is ``clients * stagger_s``; arrivals stop at the window's end.
    Each client has ``per_client`` requests ready (more than a run can
    use)."""
    clients, per = int(mix["clients"]), int(mix["per_client"])
    base = np.random.default_rng(mix["base_seed"])
    plen = lengths(mix["prompt"], clients * per, base)
    olen = lengths(mix["output"], clients * per, base)
    rng = np.random.default_rng([seed, 2])
    perm = rng.permutation(clients * per)
    prompts = _prompts(plen[perm], vocab, rng)
    plans = [[] for _ in range(clients)]
    for i in range(clients * per):
        c = i % clients
        plans[c].append(Plan(i, prompts[i], int(olen[perm][i])))
    stagger = float(mix["stagger_s"])
    return Traffic("closed_loop", plans, ramp_s=clients * stagger,
                   clients=clients, stagger_s=stagger)


def make(mix: dict, seconds: float, seed: int, vocab: int) -> Traffic:
    try:
        gen = GENERATORS[mix["kind"]]
    except KeyError:
        raise ValueError(f"no traffic generator of kind {mix.get('kind')!r}; "
                         f"known: {sorted(GENERATORS)}") from None
    return gen(mix, seconds, seed, vocab)
