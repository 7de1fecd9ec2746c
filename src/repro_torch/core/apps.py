# Copy of src/repro/core/apps.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""The paper's four applications (Table 1), mapped to assigned architectures
and scaled to pod-tenant workloads (DESIGN.md §2: the consumer GPU's
"multiple apps on one device" reappears as multi-tenant pods).

Each Application provides the paper's API — setup() / execute() / cleanup()
(real JAX execution on reduced configs for integration tests) — plus
``sim_requests``: the work-item chains the pod simulator executes with
roofline costs at full scale.

| paper app     | arch backend           | request shape (pod-tenant scale)  |
|---------------|------------------------|-----------------------------------|
| Chatbot       | tinyllama-1.1b (cfg'able) | prefill 2k ×8 + 128 decode     |
| DeepResearch  | stablelm-12b           | 12 × (prefill 64k + 256 decode)   |
| ImageGen      | chameleon-34b (DiT-ish)| 28 denoise fwd steps @8k×32 tokens|
| LiveCaptions  | seamless-m4t-large-v2  | encode segment + 24 decode, 2 s cadence |
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import costs
from repro_torch.core.costs import WorkItem
from repro_torch.core.simulator import AppTrace, SimRequest
from repro_torch.core.slo import SLO
from repro_torch.core.workflow import APP_DEFAULT_ARCH, TaskSpec


@dataclass
class AppDef:
    name: str
    app_type: str
    cfg: ModelConfig
    slo: SLO
    background: bool = False
    kv_cache_on_host: bool = False

    # --------------------------------------------------------- app shapes
    def request_chain(self, rid: int, arrival: float) -> SimRequest:
        c = self.cfg
        if self.app_type == "chatbot":
            b, prompt, new = 8, 2048, 128
            pf, pb, pc = costs.prefill_cost(c, b, prompt)
            ttft = self.slo.ttft or 1.0
            tpot = self.slo.tpot or 0.25
            items = [WorkItem(self.name, rid, "prefill", pf, pb, pc,
                              chunkable=True, slo_hint_s=ttft,
                              tokens=prompt)]
            df, db, dc, hf, hb = costs.decode_cost(
                c, b, prompt, kv_cache_on_host=self.kv_cache_on_host)
            for j in range(new // 8):
                # the first decode item carries the TTFT deadline
                hint = ttft if j == 0 else tpot * 8
                items.append(WorkItem(self.name, rid, "decode", df * 8,
                                      db * 8, dc * 8, host_flops=hf * 8,
                                      host_bytes=hb * 8, tokens=8,
                                      slo_hint_s=hint))
            return SimRequest(self.name, rid, arrival, items,
                              deadline_hint_s=self.slo.ttft or 1.0,
                              kv_tokens=b * (prompt + new))
        if self.app_type == "deep_research":
            items = []
            for _ in range(48):
                pf, pb, pc = costs.prefill_cost(c, 16, 131_072)
                items.append(WorkItem(self.name, rid, "prefill", pf, pb, pc,
                                      chunkable=True, tokens=131_072))
                df, db, dc, hf, hb = costs.decode_cost(
                    c, 16, 131_072, kv_cache_on_host=self.kv_cache_on_host)
                items.append(WorkItem(self.name, rid, "decode", df * 64,
                                      db * 64, dc * 64, host_flops=hf * 64,
                                      host_bytes=hb * 64, tokens=64))
            # one 16 x 131k context is resident at a time (the 48 rounds
            # run sequentially) — the KV giant that triggers contention
            return SimRequest(self.name, rid, arrival, items,
                              deadline_hint_s=3600.0, background=True,
                              kv_tokens=16 * (131_072 + 64))
        if self.app_type == "imagegen":
            items = []
            for _ in range(8):   # denoising steps (SD-3.5-TURBO: few-step)
                ff, fb, fc = costs.forward_cost(c, 32 * 8192)
                items.append(WorkItem(self.name, rid, "denoise", ff, fb, fc,
                                      chunkable=True,
                                      slo_hint_s=self.slo.step or 1.0))
            return SimRequest(self.name, rid, arrival, items,
                              deadline_hint_s=self.slo.step or 1.0)
        if self.app_type == "live_captions":
            seg = self.slo.segment or 2.0
            ef, eb, ec = costs.forward_cost(c, 256)   # 2 s of fbank frames
            items = [WorkItem(self.name, rid, "encode", ef, eb, ec,
                              slo_hint_s=seg / 4, tokens=256)]
            df, db, dc, hf, hb = costs.decode_cost(c, 1, 512)
            for _ in range(24):
                items.append(WorkItem(self.name, rid, "decode", df, db, dc,
                                      tokens=1, slo_hint_s=seg / 8))
            return SimRequest(self.name, rid, arrival, items,
                              deadline_hint_s=self.slo.segment or 2.0,
                              kv_tokens=512 + 24)
        raise ValueError(self.app_type)

    #: default inter-request cadence per app type (LiveCaptions' 2 s audio
    #: segments, Chatbot's 1 s think time, batch apps back to back)
    DEFAULT_SPACING_S = {"chatbot": 1.0, "deep_research": 0.0,
                         "imagegen": 0.0, "live_captions": 2.0}

    def sim_trace(self, num_requests: int, *, start_s: float = 0.0,
                  seed: int = 0, arrival=None) -> AppTrace:
        """``arrival`` is any object with ``times(n, start_s=, seed=)`` (see
        repro_torch.bench.arrival); None keeps the app type's fixed cadence. For
        closed-loop apps the generated times are arrival floors — request
        i+1 still waits for request i to complete."""
        closed = self.app_type in ("chatbot", "imagegen", "deep_research")
        if arrival is None:
            spacing = self.DEFAULT_SPACING_S[self.app_type]
            times = [start_s + i * spacing for i in range(num_requests)]
        else:
            times = arrival.times(num_requests, start_s=start_s, seed=seed)
        reqs = [self.request_chain(i, t) for i, t in enumerate(times)]
        return AppTrace(self.name, self.slo, reqs,
                        background=self.background, closed_loop=closed)


DEFAULT_SLOS = {
    "chatbot": SLO(ttft=1.0, tpot=0.25),
    "deep_research": SLO(),
    "imagegen": SLO(step=1.0),
    "live_captions": SLO(segment=2.0),
}

# Single source of truth lives next to the YAML task schema so workflow
# parsing and app construction can never disagree.
DEFAULT_ARCH = APP_DEFAULT_ARCH


def make_app(app_type: str, *, name: str | None = None, arch: str | None = None,
             slo: SLO | None = None, background: bool = False,
             kv_cache_on_host: bool = False) -> AppDef:
    cfg = get_config(arch or DEFAULT_ARCH[app_type])
    return AppDef(
        name=name or app_type,
        app_type=app_type,
        cfg=cfg,
        slo=slo if slo is not None else DEFAULT_SLOS[app_type],
        background=background or app_type == "deep_research",
        kv_cache_on_host=kv_cache_on_host,
    )


def app_from_task(task: TaskSpec) -> AppDef:
    slo = task.slo if not task.slo.is_null() else DEFAULT_SLOS.get(
        task.app_type, SLO())
    return AppDef(
        name=task.name,
        app_type=task.app_type,
        cfg=get_config(task.arch or DEFAULT_ARCH[task.app_type]),
        slo=slo,
        background=task.app_type == "deep_research",
        kv_cache_on_host=str(task.params.get("kv_cache", "")) == "cpu",
    )
