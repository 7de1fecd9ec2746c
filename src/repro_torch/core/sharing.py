# Copy of src/repro/core/sharing.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""Static model sharing via a shared inference server (paper §4.2.1).

Multiple tasks naming the same ``server_model`` share ONE engine/model
instance: memory is saved, but the server's static configuration (context
window, KV-cache placement) must satisfy every client — the paper shows a
16 GB host-resident KV cache (for DeepResearch's 128K context) costing
Chatbot ~40% of its SLOs. ``SharedServerRegistry`` reproduces both modes:

  kv_cache='device' — KV in HBM, small context (DeepResearch quality loss)
  kv_cache='host'   — KV in host DRAM, attention on host (Chatbot latency loss)

In simulation the host-KV penalty enters through WorkItem.host_flops/bytes
(costs.decode_cost(kv_cache_on_host=True)); in real mode clients share the
single InferenceEngine below.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.apps import AppDef, make_app
from repro_torch.core.slo import SLO


@dataclass
class SharedServerConfig:
    name: str
    arch: str = "tinyllama-1.1b"
    kv_cache: str = "device"        # device | host
    context_window: int = 4096      # static: every client gets this


class SharedServerRegistry:
    """setup()-level sharing: first client launches, others attach."""

    def __init__(self):
        self._servers: dict[str, SharedServerConfig] = {}
        self._engines: dict[str, object] = {}
        self._refcount: dict[str, int] = {}

    def configure(self, cfg: SharedServerConfig):
        self._servers[cfg.name] = cfg

    def acquire(self, name: str, engine_factory=None):
        """Returns the shared engine (real mode) or its config (sim mode)."""
        cfg = self._servers.setdefault(name, SharedServerConfig(name))
        self._refcount[name] = self._refcount.get(name, 0) + 1
        if engine_factory is not None and name not in self._engines:
            self._engines[name] = engine_factory(cfg)
        return self._engines.get(name, cfg)

    def release(self, name: str):
        self._refcount[name] = max(self._refcount.get(name, 1) - 1, 0)
        if self._refcount[name] == 0:
            self._engines.pop(name, None)

    def clients(self, name: str) -> int:
        return self._refcount.get(name, 0)


def shared_chatbot_apps(kv_cache: str) -> list[AppDef]:
    """Paper Fig. 6 pair: Chatbot + DeepResearch sharing one model.

    kv_cache='host' → Chatbot-KVCache-CPU (attention on host);
    kv_cache='device' → default Chatbot (DeepResearch context limited).
    """
    host = kv_cache == "host"
    chatbot = make_app("chatbot", name="Chatbot-KVCache-CPU" if host
                       else "Chatbot", kv_cache_on_host=host)
    research = make_app("deep_research", name="DeepResearch",
                        arch=chatbot.cfg.name,
                        kv_cache_on_host=host)
    return [chatbot, research]
