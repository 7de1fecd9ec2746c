"""The port's copies of the JAX-free core, config and hint-table modules,
run as the JAX package's own tests run them and compared with the JAX
package's output on the same inputs.

* ``core/scheduler.py`` (tests/test_dag_scheduler.py): topological orders
  of seeded random DAGs and the scheduler's dependency order and failure
  propagation;
* ``core/sharing.py`` (tests/test_simulator.py's sharing case): the Fig. 6
  pair with the KV cache on the device and on the host, through
  ``core/orchestrator.py``, and the shared-server registry;
* ``core/report.py`` (tests/test_system.py): the content-creation
  workflow's report under each strategy, text for text;
* ``distributed/autotune.py`` (tests/test_autotune.py): ``best_hints``
  and ``best_batch_size`` for every config and step kind;
* ``configs/shapes.py`` (tests/test_configs.py): the shape suites and the
  40-cell matrix.

The copies themselves are held to their originals line by line in
tests/test_torch_copies.py; these tests hold what they compute.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest

from repro.configs import shapes as jshapes
from repro.configs.registry import CONFIGS
from repro.core import dag as jdag
from repro.core import report as jreport
from repro.core import sharing as jsharing
from repro.core import workflow as jworkflow
from repro.core.orchestrator import Orchestrator as JOrchestrator
from repro.core.scheduler import DagScheduler as JScheduler
from repro.distributed import autotune as jautotune
from repro_torch.configs import shapes as tshapes
from repro_torch.configs.registry import CONFIGS as TCONFIGS
from repro_torch.core import dag as tdag
from repro_torch.core import report as treport
from repro_torch.core import sharing as tsharing
from repro_torch.core import workflow as tworkflow
from repro_torch.core.orchestrator import Orchestrator as TOrchestrator
from repro_torch.core.scheduler import DagScheduler as TScheduler
from repro_torch.distributed import autotune as tautotune

KINDS = ("train", "prefill", "decode", "long_decode")


def _edges(seed: int) -> dict[str, list[str]]:
    """A random acyclic dependency map: each node depends only on earlier
    ones (tests/test_dag_scheduler.py's strategy, drawn with numpy)."""
    rng = np.random.default_rng(seed)
    names = [f"n{i}" for i in range(int(rng.integers(2, 9)))]
    return {name: sorted(rng.choice(names[:i], size=int(rng.integers(
        0, min(i, 3) + 1)), replace=False).tolist()) if i else []
        for i, name in enumerate(names)}


def _dag(wf, dag_mod, edges):
    tasks = {n: wf.TaskSpec(name=n, app_type="chatbot") for n in edges}
    nodes = {n: wf.NodeSpec(name=n, uses=n, depend_on=tuple(deps))
             for n, deps in edges.items()}
    return dag_mod.build_dag(wf.WorkflowSpec(tasks=tasks, nodes=nodes))


@pytest.mark.parametrize("seed", range(6))
def test_scheduler_runs_dags_in_the_originals_order(seed):
    """The same topological order as JAX's scheduler module sees it, and
    the port's DagScheduler runs every node after all its dependencies."""
    edges = _edges(seed)
    tdag_, jdag_ = _dag(tworkflow, tdag, edges), _dag(jworkflow, jdag, edges)
    assert tdag_.topo_order() == jdag_.topo_order()
    seen, lock = [], threading.Lock()

    def runner(node):
        with lock:
            assert node.deps <= set(seen), (node.id, node.deps - set(seen))
        time.sleep(0.001)
        with lock:
            seen.append(node.id)

    outcomes = TScheduler(tdag_, runner, max_workers=4).run()
    assert sorted(outcomes) == sorted(jdag_.nodes)
    assert all(o.ok for o in outcomes.values())
    assert sorted(seen) == sorted(jdag_.nodes)


def test_scheduler_propagates_failure_like_the_original():
    edges = {"a": [], "b": ["a"]}

    def runner(node):
        if node.id == "a:exec":
            raise RuntimeError("boom")

    got = TScheduler(_dag(tworkflow, tdag, edges), runner).run()
    want = JScheduler(_dag(jworkflow, jdag, edges), runner).run()
    assert {k: o.ok for k, o in got.items()} == \
        {k: o.ok for k, o in want.items()}
    assert not got["b:exec"].ok and got["a:setup"].ok


@pytest.mark.parametrize("kv_cache", ["device", "host"])
def test_sharing_pair_matches_the_original(kv_cache):
    """Paper Fig. 6: the shared Chatbot + DeepResearch pair, greedy on 256
    chips: the same app definitions and the same summary; the host-KV
    chatbot misses more SLOs than the device one."""
    n = {"Chatbot": 10, "Chatbot-KVCache-CPU": 10, "DeepResearch": 1}
    tapps = tsharing.shared_chatbot_apps(kv_cache)
    japps = jsharing.shared_chatbot_apps(kv_cache)
    assert [(a.name, a.cfg.name) for a in tapps] == \
        [(a.name, a.cfg.name) for a in japps]
    got = TOrchestrator(total_chips=256, strategy="greedy").run_concurrent(
        tapps, n)
    want = JOrchestrator(total_chips=256, strategy="greedy").run_concurrent(
        japps, n)
    assert got.summary() == want.summary()
    if kv_cache == "host":
        dev = TOrchestrator(total_chips=256, strategy="greedy") \
            .run_concurrent(tsharing.shared_chatbot_apps("device"), n)
        assert (got.reports["Chatbot-KVCache-CPU"].attainment
                < dev.reports["Chatbot"].attainment)


def test_shared_server_registry_counts_like_the_original():
    made = []
    for mod in (tsharing, jsharing):
        reg = mod.SharedServerRegistry()
        reg.configure(mod.SharedServerConfig("s", kv_cache="host"))
        first = reg.acquire("s", engine_factory=lambda cfg: ("engine", cfg))
        again = reg.acquire("s", engine_factory=lambda cfg: 1 / 0)
        counts = [reg.clients("s")]
        reg.release("s")
        reg.release("s")
        counts.append(reg.clients("s"))
        made.append((first[0], first is again,
                     dataclasses.asdict(first[1]), counts,
                     reg.acquire("t").name))
    assert made[0] == made[1]


@pytest.mark.parametrize("strategy", ["greedy", "static", "slo_aware"])
def test_report_renders_like_the_original(strategy):
    """The content-creation workflow (Fig. 7) through each package's
    Orchestrator: the same rendered report and finish times."""
    got = TOrchestrator(total_chips=256, strategy=strategy).run_workflow(
        tworkflow.parse_workflow(tworkflow.CONTENT_CREATION_YAML))
    want = JOrchestrator(total_chips=256, strategy=strategy).run_workflow(
        jworkflow.parse_workflow(jworkflow.CONTENT_CREATION_YAML))
    text = treport.render_report(got.sim, title="content-creation",
                                 extra={"e2e_s": got.e2e_s})
    assert text == jreport.render_report(want.sim, title="content-creation",
                                         extra={"e2e_s": want.e2e_s})
    assert "generate_captions" in text and "SLO%" in text
    assert got.summary() == want.summary()
    for app in got.sim.reports:
        assert treport.summary_row(got.sim, app) == \
            jreport.summary_row(want.sim, app)


@pytest.mark.parametrize("kind", KINDS)
def test_best_hints_match_the_original(kind):
    """Every config's hint set, remat policy and batch size; each hint a
    key the port's hints module knows."""
    from repro_torch.distributed import hints
    for name, cfg in TCONFIGS.items():
        got = tautotune.best_hints(cfg, kind)
        assert got == jautotune.best_hints(CONFIGS[name], kind), name
        with hints.hints(**got[0]):
            pass
        if kind in ("decode", "long_decode"):
            assert tautotune.best_batch_size(cfg, kind) == \
                jautotune.best_batch_size(CONFIGS[name], kind), name


def test_shape_cells_match_the_original():
    assert {k: dataclasses.asdict(v) for k, v in tshapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}
    cells = tshapes.all_cells(TCONFIGS)
    assert cells == jshapes.all_cells(CONFIGS)
    assert len(cells) == 40 and sum(not c[2] for c in cells) > 0
    assert tshapes.cell_is_applicable(TCONFIGS["jamba-v0.1-52b"],
                                      tshapes.get_shape("long_500k"))[0]
