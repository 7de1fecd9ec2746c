"""One run of one cell: set up, warm up, measure, check, report.

Everything that belongs to one configuration, one traffic mix, one metric
or one cell's limits is a file found by its name (``configs/``,
``traffic/``, ``metrics/``, ``limits/``, and the reference module a
configuration names under ``reference/``); this module holds no name of a
cell. :func:`execute` does the run on a given device and returns the
result line; ``run.py`` adds the look for the card and prints it.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from portbench import check, readings, roofline, trace, traffic

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names) -> list[str]:
    """The loaded modules whose top-level name (before the first dot) is,
    as a whole, ``jax``, ``jaxlib``, ``flax`` or the JAX package's."""
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


# ------------------------------------------------------------------ lookups

@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    metrics: list          # the metric entries this cell reports
    per_layer: list
    bench: Path = HERE     # where its files were found
    ref: object = None     # the configuration's reference module


def load_cell(name: str, root: Path, bench: Path = HERE) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, its configuration,
    traffic mix, limits and metrics, each found by name under ``bench``."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    try:
        wl = next(w for w in spec["workloads"] if w["name"] == name)
    except StopIteration:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json") from None
    centry = next(c for c in spec["configs"] if c["name"] == wl["config"])
    config = json.loads((root / centry["file"]).read_text())
    mix = json.loads((bench / "traffic" / f"{wl['traffic']}.json").read_text())
    limits = json.loads((bench / "limits" / f"{name}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per = [m for m in spec["per_layer"]
           if (name in m["workloads"] if "workloads" in m
               else m["moves"] in e2e_names)]
    return Cell(name, wl["chips"], config, mix, limits, e2e, per, bench,
                load_module(bench / "reference" / f"{config['reference']}.py",
                            "portbench_reference_"))


def load_module(path: Path, prefix: str):
    """The Python file ``path`` as a module (named ``prefix`` + its stem)."""
    mod_name = prefix + "".join(ch if ch.isalnum() else "_"
                                for ch in path.stem)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str, bench: Path = HERE):
    """``metrics/<name>.py``'s ``read(run)``, or where there is none that
    of the name's stem before its first dot (``step_mfu.chat`` reads with
    ``metrics/step_mfu.py``): one quantity split by the end-to-end metric
    it moves keeps one reader."""
    path = bench / "metrics" / f"{name}.py"
    if not path.is_file():
        path = bench / "metrics" / f"{name.split('.')[0]}.py"
    return load_module(path, "portbench_metric_").read


# ------------------------------------------------------------- set-up parts

def program_config(config: dict):
    """The port's ModelConfig: the registry's arch with the file's
    ``port_overrides``, held against the file's ``model`` sizes."""
    from repro_torch.configs.registry import get_config
    cfg = dataclasses.replace(get_config(config["arch"]),
                              **config.get("port_overrides", {}))
    have = dataclasses.asdict(cfg)
    have["head_dim"] = cfg.resolved_head_dim
    wrong = {k: (have.get(k), v) for k, v in config["model"].items()
             if k in have and have[k] != v}
    if wrong:
        raise ValueError(f"the port's config differs from the file's: {wrong}")
    return cfg


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def draw_weights(shapes: dict, is_norm, seed: int, device,
                 scale: float = 0.02, chunk: int = 1 << 30) -> dict:
    """Every weight in one float32 buffer, drawn N(0, scale) on ``device``
    from ``seed`` in a few large calls; norm scales (the leaves whose name
    ``is_norm``) are ones. Leaves are views of the buffer, in ``shapes``'
    names."""
    leaves = list(_leaves(shapes))
    drawn = [(p, s) for p, s in leaves if not is_norm(p[-1])]
    total = sum(math.prod(s) for _, s in drawn)
    buf = torch.empty(total, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for lo in range(0, total, chunk):
        buf[lo:lo + chunk].normal_(0.0, scale, generator=gen)
    out: dict = {}
    off = 0
    for p, s in leaves:
        if is_norm(p[-1]):
            _put(out, p, torch.ones(s, dtype=torch.float32, device=device))
        else:
            n = math.prod(s)
            _put(out, p, buf[off:off + n].view(s))
            off += n
    return out


def check_shapes(params: dict, abstract: dict) -> None:
    mine = {p: tuple(t.shape) for p, t in _leaves(params)}
    theirs = {p: tuple(t.shape) for p, t in _leaves(abstract)}
    if mine != theirs:
        raise ValueError("the benchmark's weights do not fit the port's "
                         f"leaves: {sorted(set(mine.items()) ^ set(theirs.items()))[:6]}")


# ------------------------------------------------------------- dispatches

@dataclass
class Dispatch:
    kind: str                 # "prefill" | "decode"
    tokens: torch.Tensor      # (B, C) as handed to the model
    starts: torch.Tensor      # (B,) cached tokens before the dispatch
    active: torch.Tensor | None
    valid: torch.Tensor | None
    slots: list               # request id in each batch row, -1 empty
    step: int
    traced: str | None        # the profiled slice it ran in, if any


class Recorder:
    """Wraps the bundle's two serving steps: keeps each dispatch's inputs
    (the engine hands every dispatch fresh tensors, so keeping them costs
    no copy) and the request in each batch row, and marks the host spans.
    A ``fault`` (tests) may replace a step by a broken one."""

    def __init__(self, engine, bundle, driver, spans, fault=None):
        self.items: list[Dispatch] = []
        self.on = False
        pf, dc = bundle.prefill_chunk_paged, bundle.decode_step_paged
        if fault is not None:
            pf, dc = fault(engine, pf, dc)

        def slots():
            return [r.request_id if r is not None else -1
                    for r in engine.active]

        def prefill(params, cache, tokens, start_len, tables, active=None,
                    valid=None):
            if self.on:
                self.items.append(Dispatch("prefill", tokens, start_len,
                                           active, valid, slots(),
                                           len(driver.steps), driver.tracing))
            spans.enter("prefill_enqueue")
            out = pf(params, cache, tokens, start_len, tables, active, valid)
            spans.enter("admission")
            return out

        def decode(params, cache, tokens, lengths, tables, active=None):
            if self.on:
                self.items.append(Dispatch("decode", tokens, lengths, active,
                                           None, slots(), len(driver.steps),
                                           driver.tracing))
            spans.enter("decode_enqueue")
            out = dc(params, cache, tokens, lengths, tables, active)
            spans.enter("argmax_wait")
            return out

        bundle.prefill_chunk_paged = prefill
        bundle.decode_step_paged = decode


# ------------------------------------------------------------------ driving

@dataclass
class Driver:
    engine: object
    spans: trace.Spans
    device: torch.device
    trace_plan: dict | None = None     # the mix's "trace": when and how long
    steps: list = field(default_factory=list)   # (t0, t1, slice or None)
    tracing: str | None = None                  # the slice being profiled
    prof: object = None
    slices: dict = field(default_factory=dict)  # slice -> (profiler, wall s)
    _t_slice: float = 0.0
    _slice_steps: int = 0
    _slice_prefills: int = 0
    recorder: Recorder | None = None

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def step(self, trace_from: float | None = None):
        e = self.engine
        if (self.trace_plan and self.tracing is None
                and trace_from is not None and e.now() >= trace_from
                and len(self.slices) < len(trace.SLICES)):
            self._open(trace.SLICES[len(self.slices)])
        n_pf = len(self.recorder.items) if self.recorder else 0
        t0 = e.now()
        self.spans.enter("admission")
        e.step()
        self.spans.enter("client")
        self.steps.append((t0, e.now(), self.tracing))
        if self.tracing is not None:
            self._slice_steps += 1
            if self.recorder:
                self._slice_prefills += sum(
                    d.kind == "prefill" for d in self.recorder.items[n_pf:])
            p = self.trace_plan
            if self.tracing == "host":      # a short slice: every host op
                done = self._slice_steps >= p.get("host_steps", p["steps"])
            else:
                done = (self._slice_steps >= p["steps"]
                        and self._slice_prefills >= p.get("min_prefill", 0)
                        or self._slice_steps >= p["max_steps"])
            if done:
                self.close_slice()

    def _open(self, which: str):
        self.spans.close()          # no host range straddles a start or stop
        self.prof = trace.start(self.device, which)
        self._t_slice = time.monotonic()
        self.tracing = which
        self._slice_steps = self._slice_prefills = 0

    def close_slice(self):
        if self.tracing is None:
            return
        self.sync()
        wall = time.monotonic() - self._t_slice
        self.spans.close()
        self.prof.stop()
        self.slices[self.tracing] = (self.prof, wall)
        self.prof, self.tracing = None, None

    def idle_until(self, t: float):
        self.spans.enter("client")
        dt = t - self.engine.now()
        if dt > 0:
            time.sleep(dt)


def _due(engine, now: float) -> bool:
    return any(r.arrival_s <= now for r in engine.waiting)


def _busy(engine) -> bool:
    return any(a is not None for a in engine.active)


def run_until(drv: Driver, deadline: float, *, trace_from=None,
              on_step=None, stop=None) -> None:
    """Step the engine until ``deadline`` (engine clock) or until
    ``stop()``; sleep to the next arrival when there is nothing to do."""
    e = drv.engine
    while True:
        now = e.now()
        if now >= deadline or (stop is not None and stop()):
            return
        if not _busy(e) and not _due(e, now):
            nxt = min((r.arrival_s for r in e.waiting), default=deadline)
            drv.idle_until(min(nxt, deadline))
            continue
        drv.step(trace_from)
        if on_step is not None:
            on_step()


def warm_up(engine, mix: dict, vocab: int) -> None:
    """Serve the shortest prompt of the mix and its longest up to one
    prefill chunk once, four tokens each: every kernel is loaded and the
    allocator holds the widest dispatch's memory."""
    from repro_torch.serving.request import Request
    spec = mix["prompt"]
    top = spec["value"] if spec["dist"] == "fixed" else spec["max"]
    low = spec["value"] if spec["dist"] == "fixed" else spec["min"]
    lens = sorted({int(low), int(min(top, engine.prefill_chunk))})
    reqs = [Request(-(i + 1), (np.arange(n) * 7919 % vocab).astype(np.int32),
                    4, arrival_s=0.0) for i, n in enumerate(lens)]
    for r in reqs:
        engine.submit(r)
    while any(r.t_done is None for r in reqs):
        engine.step()


# -------------------------------------------------------------------- run

@dataclass
class Run:
    """What the metric readers read."""
    cell: Cell
    model: dict
    ref: object               # the configuration's reference module
    vocab: int
    setup_s: float
    t_end: float              # the drain's end (engine clock)
    w0: float
    w1: float
    due: list                 # requests due in the window
    requests: list            # every request sent
    stats0: object
    stats1: object
    steps: list
    dispatches: list          # host copies (_host_dispatches)
    traced: dict | None
    peaks: dict | None
    admits: dict              # request id -> admit time (traced run)

    @property
    def window_s(self) -> float:
        return self.w1 - self.w0


def _host_dispatches(items, page: int):
    """Each recorded dispatch on the host: its kind, token ids, active
    rows as (start, tokens, batch row), width, the request in each batch
    row, its step and slice, and the pool's page size."""
    out = []
    for d in items:
        tok = d.tokens.cpu().numpy()
        st = d.starts.cpu().numpy()
        act = (np.ones(tok.shape[0], bool) if d.active is None
               else d.active.cpu().numpy())
        val = None if d.valid is None else d.valid.cpu().numpy()
        rows = []
        for r in np.flatnonzero(act):
            n = tok.shape[1] if val is None else int(val[r])
            rows.append((int(st[r]), n, int(r)))
        out.append({"kind": d.kind, "tokens": tok, "rows": rows,
                    "B": tok.shape[0], "C": tok.shape[1], "slots": d.slots,
                    "step": d.step, "traced": d.traced, "page": page})
    return out


def execute(cell: Cell, seed: int, seconds: float, traced: bool,
            device="cuda", t_start: float | None = None,
            fault=None, log=print, control: bool = False,
            judge: bool = True, on_run=None) -> dict:
    """One run of ``cell``; the result line's object. ``on_run(run,
    readings)`` sees the run and every reading of the check (sweep.py,
    control.py); ``control`` also reads the control and the look."""
    from repro_torch.models.factory import build_model
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.request import Request
    from repro_torch.telemetry.recorder import TraceRecorder

    t_start = time.monotonic() if t_start is None else t_start
    dev = torch.device(device)
    m, mix, ref = cell.config["model"], cell.mix, cell.ref
    cfg = program_config(cell.config)
    vocab = m["vocab_size"]
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.build()
    bundle = build_model(cfg, dev)
    params = draw_weights(ref.param_shapes(m), ref.is_norm, seed, dev)
    check_shapes(params, bundle.abstract_params(torch.float32))
    opts = mix["engine"]
    recorder = TraceRecorder() if traced else None
    engine = InferenceEngine(bundle, max_slots=opts["max_slots"],
                             max_seq=opts["max_seq"], policy=opts["policy"],
                             prefill_chunk=opts.get("prefill_chunk"),
                             page_size=opts.get("page_size"),
                             recorder=recorder)
    engine.load_params(params)
    spans = trace.Spans(traced)
    drv = Driver(engine, spans, dev,
                 trace_plan=mix.get("trace") if traced else None)
    rec = Recorder(engine, bundle, drv, spans, fault)
    drv.recorder = rec
    warm_up(engine, mix, vocab)
    drv.sync()
    setup_s = time.monotonic() - t_start
    log(f"portbench: {cell.name}: chunk {engine.prefill_chunk}, page "
        f"{engine.page_size}, set-up {setup_s:.2f} s")
    rec.on = True
    tr = traffic.make(mix, seconds, seed, vocab)
    t0 = engine.now() + 0.01
    w0, w1 = t0 + tr.ramp_s, t0 + tr.ramp_s + seconds
    reqs, due = {}, []

    def send(plan, arrival):
        r = Request(plan.index, plan.prompt, plan.max_new_tokens,
                    arrival_s=arrival, app=cell.name)
        reqs[plan.index] = r
        engine.submit(r)
        if w0 <= arrival < w1:
            due.append(r)

    on_step = None
    if tr.kind == "open_poisson":
        for p in tr.plans:
            send(p, t0 + p.offset_s)
    else:
        nxt = [1] * tr.clients
        client_of = {}
        for c in range(tr.clients):
            p = tr.plans[c][0]
            client_of[p.index] = c
            send(p, t0 + c * tr.stagger_s)
        seen = [len(engine.done)]
        think = float(mix.get("think_s", 0.0))

        def on_step():
            for r in engine.done[seen[0]:]:
                c = client_of.get(r.request_id)
                if c is None or r.t_done + think >= w1:
                    continue
                if nxt[c] == len(tr.plans[c]):
                    raise RuntimeError(f"client {c} ran out of requests: "
                                       "raise the mix's per_client")
                p = tr.plans[c][nxt[c]]
                nxt[c] += 1
                client_of[p.index] = c
                send(p, r.t_done + think)
            seen[0] = len(engine.done)
    at = mix.get("trace", {}).get("at", 0.5)
    run_until(drv, w0, on_step=on_step)
    stats0 = dataclasses.replace(engine.stats)
    run_until(drv, w1, trace_from=w0 + at * seconds, on_step=on_step)
    drv.sync()
    w1_real = engine.now()
    stats1 = dataclasses.replace(engine.stats)
    if drv.steps and drv.steps[-1][1] < w1_real:
        t0s, _, tr_flag = drv.steps[-1]
        drv.steps[-1] = (t0s, w1_real, tr_flag)
    drv.close_slice()                # a slice that outlived the window
    cap = float(mix.get("drain_s", seconds))
    run_until(drv, w1_real + cap, on_step=None,
              stop=lambda: all(r.t_done is not None for r in due))
    drv.sync()
    t_end = engine.now()
    rec.on = False
    spans.close()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    page = engine.page_size
    disp = _host_dispatches(rec.items, page)
    admits = ({e.request_id: e.t0 for e in recorder.events
               if e.kind == "admit"} if recorder is not None else {})
    failed = sum(r.t_done is None for r in due)
    # the program's state goes before the reference runs
    engine.cache = None
    del engine, bundle
    drv.engine = drv.recorder = rec = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    verdict = (check.judge(ref, params, m, disp, due, cell.limits,
                           mix.get("check", {}), seed, dev, log=log,
                           control=control) if judge
               else {"correct": None, "checks": {}, "readings": {}})
    traced_read = ({k: trace.read(p, wall) for k, (p, wall)
                    in drv.slices.items()} if drv.slices else None)
    drv.slices.clear()
    run = Run(cell, m, ref, ref.padded_vocab(m), setup_s, t_end, w0, w1_real,
              due,
              list(reqs.values()), stats0, stats1, drv.steps, disp,
              traced_read, roofline.peaks(kind), admits)
    gaps = readings.token_gaps_s(run)
    if gaps:
        log("portbench: token gaps ms p50/p90/p95/p99 " + " ".join(
            f"{1e3 * readings.percentile(gaps, q):.2f}"
            for q in (50, 90, 95, 99)) + f" of {len(gaps)}")
    entries = cell.per_layer if traced else cell.metrics
    metrics = {}
    for e in entries:
        v = load_reader(e["name"], cell.bench)(run)
        if v is not None:
            metrics[e["name"]] = {"value": v, "unit": e["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": kind, "count": cell.chips,
                   "memory_peak_bytes": int(peak)}
    out = {"correct": verdict["correct"], "attempted": len(due),
           "failed": failed, "metrics": metrics, "device": device_info}
    if traced and traced_read and traced_read.get("device"):
        device_info["busy_s"] = traced_read["device"]["busy_s"]
        device_info["window_s"] = traced_read["device"]["window_s"]
        out["breakdown"] = trace.breakdown(traced_read)
    if on_run is not None:
        on_run(run, verdict["readings"])
    out["checks"] = verdict["checks"]
    return out
