# Copy of src/repro/core/workflow.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""Workflow specification (paper Fig. 2 / Fig. 23 YAML schema).

A workflow names *tasks* (application instances: model/arch, placement,
request count, SLO) and *nodes* (workflow steps with ``uses`` and
``depend_on`` edges). ``parse_workflow`` accepts a YAML string or a dict.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import yaml

from repro_torch.core.slo import SLO


@dataclass(frozen=True)
class TaskSpec:
    """One application instance ('Brainstorm (chatbot)' in the paper)."""
    name: str
    app_type: str                 # chatbot | deep_research | imagegen | live_captions | custom
    arch: str = ""                # assigned architecture backing the app
    num_requests: int = 1
    device: str = "gpu"           # gpu (pod) | cpu (host fallback)
    slo: SLO = field(default_factory=SLO)
    share_server: str = ""        # tasks naming the same server share one model
    mps: int = 100                # paper compat: % of resources under static partitioning
    params: dict = field(default_factory=dict)


@dataclass(frozen=True)
class NodeSpec:
    """One workflow node referencing a task, with dependencies."""
    name: str
    uses: str
    depend_on: tuple[str, ...] = ()
    background: bool = False


@dataclass
class WorkflowSpec:
    tasks: dict[str, TaskSpec]
    nodes: dict[str, NodeSpec]

    def to_dict(self) -> dict:
        """Inverse of ``parse_workflow``: a plain mapping that parses back
        to an equivalent spec (used by Scenario.to_json round-tripping)."""
        import dataclasses as _dc
        out: dict = {}
        for name, t in self.tasks.items():
            body: dict = {"type": t.app_type, "num_requests": t.num_requests,
                          "device": t.device, "mps": t.mps}
            if t.arch:
                body["arch"] = t.arch
            if not t.slo.is_null():
                body["slo"] = {k: v for k, v in _dc.asdict(t.slo).items()
                               if v is not None}
            if t.share_server:
                body["server_model"] = t.share_server
            body.update(t.params)
            out[name] = body
        out["workflows"] = {
            name: {"uses": n.uses, "depend_on": list(n.depend_on),
                   "background": n.background}
            for name, n in self.nodes.items()}
        return out

    def validate(self) -> None:
        for node in self.nodes.values():
            if node.uses not in self.tasks:
                raise ValueError(f"node {node.name!r} uses unknown task "
                                 f"{node.uses!r}")
            for dep in node.depend_on:
                if dep not in self.nodes:
                    raise ValueError(f"node {node.name!r} depends on unknown "
                                     f"node {dep!r}")


# Single source of truth for app-type -> assigned architecture (the table in
# repro/core/apps.py's docstring). apps.DEFAULT_ARCH aliases this mapping.
APP_DEFAULT_ARCH = {
    "chatbot": "tinyllama-1.1b",
    "deep_research": "stablelm-12b",
    "imagegen": "chameleon-34b",
    "live_captions": "seamless-m4t-large-v2",
}
_APP_DEFAULT_ARCH = APP_DEFAULT_ARCH   # backward-compat alias


def parse_workflow(src) -> WorkflowSpec:
    """src: YAML string or pre-parsed dict with task sections + 'workflows'."""
    if isinstance(src, str):
        src = yaml.safe_load(src)
    if not isinstance(src, dict):
        raise ValueError("workflow spec must be a mapping")

    raw_nodes = src.get("workflows", {})
    tasks: dict[str, TaskSpec] = {}
    for name, body in src.items():
        if name == "workflows":
            continue
        body = body or {}
        app_type = body.get("type", "custom")
        if app_type == "custom" and "(" in name and name.endswith(")"):
            app_type = name[name.rindex("(") + 1:-1].strip().lower()
        arch = body.get("arch") or _APP_DEFAULT_ARCH.get(app_type, "tinyllama-1.1b")
        tasks[name] = TaskSpec(
            name=name,
            app_type=app_type,
            arch=arch,
            num_requests=int(body.get("num_requests", 1)),
            device=str(body.get("device", "gpu")),
            slo=SLO.parse(body.get("slo")),
            share_server=str(body.get("server_model", body.get("model", ""))),
            mps=int(body.get("mps", 100)),
            params={k: v for k, v in body.items()
                    if k not in ("type", "arch", "num_requests", "device",
                                 "slo", "server_model", "model", "mps")},
        )

    nodes: dict[str, NodeSpec] = {}
    for name, body in raw_nodes.items():
        body = body or {}
        nodes[name] = NodeSpec(
            name=name,
            uses=str(body.get("uses", name)),
            depend_on=tuple(body.get("depend_on", ())),
            background=bool(body.get("background", False)),
        )
    if not nodes:  # no explicit workflow section: every task is a root node
        nodes = {name: NodeSpec(name=name, uses=name) for name in tasks}

    wf = WorkflowSpec(tasks=tasks, nodes=nodes)
    wf.validate()
    return wf


# The paper's content-creation workflow (Fig. 23), expressed on the assigned
# architecture pool. Used by benchmarks/fig7 and examples/.
CONTENT_CREATION_YAML = """
Brainstorm (chatbot):
  num_requests: 10
  device: gpu
  type: chatbot
  server_model: shared-llm
  slo: [1s, 0.25s]
  kv_cache: cpu

Analysis (deep_research):
  num_requests: 1
  device: gpu
  type: deep_research
  server_model: shared-llm

Preparing Outline (chatbot):
  num_requests: 20
  device: gpu
  type: chatbot
  slo: [1s, 0.25s]

Creating Cover Art (imagegen):
  num_requests: 10
  device: gpu
  type: imagegen
  slo: 1s

Generating Captions (live_captions):
  num_requests: 40
  device: gpu
  type: live_captions
  slo: 2s

workflows:
  analysis:
    uses: Analysis (deep_research)
    background: true
  brainstorm:
    uses: Brainstorm (chatbot)
  outline:
    uses: Preparing Outline (chatbot)
    depend_on: ["brainstorm", "analysis"]
  cover_art:
    uses: Creating Cover Art (imagegen)
    depend_on: ["outline"]
  generate_captions:
    uses: Generating Captions (live_captions)
    depend_on: ["outline"]
"""
