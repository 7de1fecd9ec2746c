# Copy of src/repro/core/dag.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""Workflow DAG (paper §3.2 step 2).

Each application node expands into setup → exec(×requests) → cleanup.
Validation: acyclic, every exec preceded by its setup, cleanup after all
execs, dependencies respect the node graph.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Optional

from repro_torch.core.workflow import NodeSpec, TaskSpec, WorkflowSpec


class Phase(str, Enum):
    SETUP = "setup"
    EXEC = "exec"
    CLEANUP = "cleanup"


@dataclass
class DagNode:
    id: str
    node: str                      # workflow node name
    task: TaskSpec
    phase: Phase
    deps: set[str] = field(default_factory=set)
    background: bool = False


@dataclass
class WorkflowDag:
    nodes: dict[str, DagNode]

    def roots(self) -> list[str]:
        return [n.id for n in self.nodes.values() if not n.deps]

    def successors(self, nid: str) -> list[str]:
        return [m.id for m in self.nodes.values() if nid in m.deps]

    # ------------------------------------------------------------ validate
    def validate(self) -> None:
        order = self.topo_order()  # raises on cycles
        pos = {nid: i for i, nid in enumerate(order)}
        for n in self.nodes.values():
            base = n.id.rsplit(":", 1)[0]
            if n.phase == Phase.EXEC:
                setup_id = f"{base}:setup"
                if setup_id not in self.nodes:
                    raise ValueError(f"{n.id} has no setup node")
                if pos[setup_id] > pos[n.id]:
                    raise ValueError(f"{setup_id} ordered after {n.id}")
                if setup_id not in n.deps:
                    raise ValueError(f"{n.id} does not depend on its setup")
            if n.phase == Phase.CLEANUP:
                ex = f"{base}:exec"
                if ex in self.nodes and pos[ex] > pos[n.id]:
                    raise ValueError(f"{n.id} ordered before {ex}")

    def topo_order(self) -> list[str]:
        indeg = {nid: len(n.deps) for nid, n in self.nodes.items()}
        ready = sorted(nid for nid, d in indeg.items() if d == 0)
        order: list[str] = []
        while ready:
            nid = ready.pop(0)
            order.append(nid)
            for succ in self.successors(nid):
                indeg[succ] -= 1
                if indeg[succ] == 0:
                    ready.append(succ)
            ready.sort()
        if len(order) != len(self.nodes):
            stuck = sorted(set(self.nodes) - set(order))
            raise ValueError(f"workflow graph has a cycle through {stuck}")
        return order


def build_dag(spec: WorkflowSpec) -> WorkflowDag:
    """Expand the node graph into setup/exec/cleanup DAG nodes."""
    nodes: dict[str, DagNode] = {}
    for node in spec.nodes.values():
        task = spec.tasks[node.uses]
        sid, eid, cid = (f"{node.name}:setup", f"{node.name}:exec",
                         f"{node.name}:cleanup")
        dep_execs = {f"{d}:exec" for d in node.depend_on}
        nodes[sid] = DagNode(sid, node.name, task, Phase.SETUP, set(),
                             node.background)
        nodes[eid] = DagNode(eid, node.name, task, Phase.EXEC,
                             {sid} | dep_execs, node.background)
        nodes[cid] = DagNode(cid, node.name, task, Phase.CLEANUP, {eid},
                             node.background)
    dag = WorkflowDag(nodes)
    dag.validate()
    return dag
