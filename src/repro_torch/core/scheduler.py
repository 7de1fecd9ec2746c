# Copy of src/repro/core/scheduler.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""DAG scheduler — real (threaded) execution mode.

Runs setup/exec/cleanup callables per DAG node with maximal concurrency
(paper §3.2 'DAG scheduler'). The simulation path lives in orchestrator.py;
this path drives REAL application objects (tiny models on CPU) and is used
by the integration tests and examples.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor, Future
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.core.dag import Phase, WorkflowDag


@dataclass
class NodeOutcome:
    node_id: str
    start_s: float
    end_s: float
    error: Optional[BaseException] = None

    @property
    def ok(self) -> bool:
        return self.error is None


class DagScheduler:
    """Executes a WorkflowDag; each node maps to a callable via ``runner``.

    runner(dag_node) -> None; raising marks the node (and its dependents)
    failed. Thread-pool width bounds real concurrency.
    """

    def __init__(self, dag: WorkflowDag,
                 runner: Callable[["DagNode"], None],
                 *, max_workers: int = 8):
        self.dag = dag
        self.runner = runner
        self.max_workers = max_workers
        self.outcomes: dict[str, NodeOutcome] = {}
        self._lock = threading.Lock()
        self._done: set[str] = set()
        self._failed: set[str] = set()

    def run(self) -> dict[str, NodeOutcome]:
        t0 = time.monotonic()
        pending = dict(self.dag.nodes)
        with ThreadPoolExecutor(max_workers=self.max_workers) as pool:
            in_flight: dict[str, Future] = {}

            def ready_nodes():
                out = []
                for nid, node in pending.items():
                    if nid in in_flight:
                        continue
                    if any(d in self._failed for d in node.deps):
                        # propagate failure without running
                        self._failed.add(nid)
                        self.outcomes[nid] = NodeOutcome(
                            nid, time.monotonic() - t0, time.monotonic() - t0,
                            error=RuntimeError("dependency failed"))
                        out.append((nid, None))
                    elif node.deps <= self._done:
                        out.append((nid, node))
                return out

            while pending or in_flight:
                progressed = False
                for nid, node in ready_nodes():
                    pending.pop(nid, None)
                    progressed = True
                    if node is None:
                        continue

                    def make(nid=nid, node=node):
                        def work():
                            start = time.monotonic() - t0
                            err = None
                            try:
                                self.runner(node)
                            except BaseException as e:  # noqa: BLE001
                                err = e
                            end = time.monotonic() - t0
                            with self._lock:
                                self.outcomes[nid] = NodeOutcome(nid, start,
                                                                 end, err)
                                (self._failed if err else self._done).add(nid)
                        return work

                    in_flight[nid] = pool.submit(make())
                finished = [nid for nid, f in in_flight.items() if f.done()]
                for nid in finished:
                    in_flight.pop(nid)
                    progressed = True
                if not progressed:
                    time.sleep(0.002)
        return self.outcomes
