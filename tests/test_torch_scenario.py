"""The engine substrate of a Scenario on the port, against the JAX
package's: ``repro_torch.bench.engine_runner.run_scenario_on_engine`` on
the CPU and ``repro.bench.engine_runner.run_scenario_on_engine``.

Both runners execute on the same weights: the JAX vehicle's
(``repro.bench.engine_runner.engine_model()``, ``key(0)``), carried across
by the weight bridge and substituted for the port runner's
``engine_model``. Each package's tuner reads its own empty cache file. For
every Scenario the ``to_json()`` documents must be equal in every field
(all timing is the runners' virtual clock), and so must every partition's
``EngineStats`` and every engine's token streams.

Scenarios: ``tests/test_engine_scenario.py``'s concurrent workload under
every policy and ``mixed``; exclusive mode; workflow mode on
``CONTENT_CREATION_YAML`` with node and request release; a page budget
that evicts; the prefix cache with a conversation app; 4 replicas routed
``prefix_aware``; a fault storm with ``shed_on_slo``; telemetry.
"""
import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401

import repro.bench as jbench  # noqa: E402
import repro_torch.bench as tbench  # noqa: E402
from repro.bench import engine_runner as jrunner  # noqa: E402
from repro.bench.conversation import \
    ConversationSpec as JConversation  # noqa: E402
from repro.core import workflow as jworkflow  # noqa: E402
from repro.kernels import autotune as jtune  # noqa: E402
from repro.training.checkpoint import _flatten  # noqa: E402
from repro_torch.bench import engine_runner as trunner  # noqa: E402
from repro_torch.bench.conversation import \
    ConversationSpec as TConversation  # noqa: E402
from repro_torch.configs.registry import CONFIGS as TCONFIGS  # noqa: E402
from repro_torch.core import workflow as tworkflow  # noqa: E402
from repro_torch.kernels import autotune as ttune  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.factory import build_model as tbuild  # noqa: E402

#: the port runner's own vehicle builder (the fixture below replaces it)
VEHICLE = trunner.engine_model

torch.set_num_threads(2)

JAX = types.SimpleNamespace(Scenario=jbench.Scenario,
                            ScenarioApp=jbench.ScenarioApp,
                            ConversationSpec=JConversation,
                            workflow=jworkflow, runner=jrunner)
PORT = types.SimpleNamespace(Scenario=tbench.Scenario,
                             ScenarioApp=tbench.ScenarioApp,
                             ConversationSpec=TConversation,
                             workflow=tworkflow, runner=trunner)

ALL_POLICIES = ("greedy", "chunked", "static", "slo_aware", "weighted_fair",
                "preemptive_priority", "mixed")
#: tests/test_resilience.py's storm (it sheds), and a crash that catches
#: a long deep_research prefill in flight (replays, timeouts, retries)
STORM = [
    {"kind": "thermal_throttle", "start_s": 1.0, "duration_s": 20.0,
     "derate": 0.4},
    {"kind": "engine_stall", "start_s": 4.0, "duration_s": 3.0,
     "crash": True},
    {"kind": "memory_spike", "start_s": 2.0, "duration_s": 10.0,
     "steal_fraction": 0.5},
    {"kind": "client_timeout", "timeout_s": 8.0, "max_retries": 1},
]
CRASH = [
    {"kind": "engine_stall", "start_s": 1.0, "duration_s": 2.0,
     "crash": True},
    {"kind": "memory_spike", "start_s": 2.0, "duration_s": 10.0,
     "steal_fraction": 0.5},
    {"kind": "client_timeout", "timeout_s": 8.0, "max_retries": 1},
]


def _concurrent(pkg, policy, **kw):
    """tests/test_engine_scenario.py's ``_concurrent`` workload."""
    return pkg.Scenario(
        name="parity", mode="concurrent", policy=policy, total_chips=256,
        substrate="engine", seed=1,
        apps=[pkg.ScenarioApp("chatbot", num_requests=3),
              pkg.ScenarioApp("imagegen", num_requests=3),
              pkg.ScenarioApp("live_captions", num_requests=8)], **kw)


def _exclusive(pkg):
    return pkg.Scenario(
        name="excl", mode="exclusive", policy="chunked", total_chips=64,
        substrate="engine", seed=2,
        apps=[pkg.ScenarioApp("chatbot", num_requests=2),
              pkg.ScenarioApp("live_captions", num_requests=3)])


def _workflow(release):
    def make(pkg):
        wf = pkg.workflow.parse_workflow(pkg.workflow.CONTENT_CREATION_YAML)
        wf.tasks = {name: dataclasses.replace(
            t, num_requests=min(t.num_requests, 3))
            for name, t in wf.tasks.items()}
        return pkg.Scenario(name="wf", mode="workflow", policy="slo_aware",
                            total_chips=256, substrate="engine",
                            workflow_release=release, workflow=wf)
    return make


def _faults(faults, apps, budget):
    def make(pkg):
        return pkg.Scenario(
            name="faults", mode="concurrent", policy="slo_aware",
            total_chips=16, substrate="engine", seed=7,
            kv_page_budget=budget, page_size=16, faults=faults,
            shed_on_slo={"attainment": 0.9, "window": 4},
            apps=[pkg.ScenarioApp(a, num_requests=n) for a, n in apps])
    return make


def _conversation(pkg, **kw):
    return pkg.Scenario(
        name="conv", mode="concurrent", policy="chunked", total_chips=16,
        substrate="engine", seed=7, prefix_cache=True, page_size=16,
        apps=[pkg.ScenarioApp("conversation", name="chat", num_requests=3,
                              conversation=pkg.ConversationSpec(
                                  turns=3, system_tokens=64, user_tokens=32,
                                  assistant_tokens=32, think_time_s=1.0)),
              pkg.ScenarioApp("live_captions", num_requests=3)], **kw)


SCENARIOS = {
    **{f"concurrent-{p}": (lambda pkg, p=p: _concurrent(pkg, p))
       for p in ALL_POLICIES},
    "exclusive": _exclusive,
    "workflow-node": _workflow("node"),
    "workflow-request": _workflow("request"),
    "page-budget": lambda pkg: _concurrent(pkg, "chunked",
                                           kv_page_budget=54, page_size=16),
    "prefix-cache": lambda pkg: _conversation(pkg, kv_page_budget=256),
    "replicas": lambda pkg: _conversation(pkg, replicas=4,
                                          routing="prefix_aware"),
    "faults-storm": _faults(STORM, [("chatbot", 6), ("live_captions", 6)],
                            64),
    "faults-crash": _faults(CRASH, [("deep_research", 1), ("chatbot", 2)],
                            96),
    "telemetry": lambda pkg: _concurrent(pkg, "slo_aware", telemetry=True),
}


@pytest.fixture(scope="module")
def same_weights(tmp_path_factory):
    """The JAX vehicle's weights in both runners, each package's tuner on
    its own empty cache file, and both runners' engines recorded."""
    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp("tuner")
    for tune, name in ((jtune, "jax.json"), (ttune, "torch.json")):
        mp.setattr(tune, "cache_path", lambda name=name: str(tmp / name))
        tune.reset()
    jmodel, jparams, jcfg = jrunner.engine_model()
    tcfg = dataclasses.replace(TCONFIGS[trunner.ENGINE_ARCH].reduced(),
                               num_layers=trunner.ENGINE_LAYERS)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    tmodel = tbuild(tcfg, "cpu")
    tparams = params_from_jax(_flatten(jparams), "cpu")
    mp.setattr(trunner, "engine_model",
               lambda device="cuda": (tmodel, tparams, tcfg))
    engines = {}
    for pkg, key in ((JAX, "jax"), (PORT, "port")):
        engines[key] = []

        class Recorded(pkg.runner.InferenceEngine):
            def __init__(self, *a, _log=engines[key], **kw):
                super().__init__(*a, **kw)
                _log.append(self)

        mp.setattr(pkg.runner, "InferenceEngine", Recorded)
    yield engines
    mp.undo()
    jtune.reset()
    ttune.reset()


def _streams(engines):
    return [sorted((r.app, r.request_id, list(r.tokens_out), r.t_tokens)
                   for r in e.done) for e in engines]


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_document_stats_and_streams_match_jax(same_weights, name):
    make = SCENARIOS[name]
    for log in same_weights.values():
        log.clear()
    want = jrunner.run_scenario_on_engine(make(JAX))
    got = trunner.run_scenario_on_engine(make(PORT), device="cpu")
    assert got.to_json() == want.to_json()
    assert {k: dataclasses.asdict(v) for k, v in got.engine_stats.items()} \
        == {k: dataclasses.asdict(v) for k, v in want.engine_stats.items()}
    jengines, tengines = same_weights["jax"], same_weights["port"]
    assert len(tengines) == len(jengines) > 0
    assert all(e.device.type == "cpu" for e in tengines)
    assert _streams(tengines) == _streams(jengines)
    # each Scenario exercises what it is named for
    stats = list(got.engine_stats.values())
    results = got.to_json()["results"]
    sim = results[next(iter(results))]
    if name == "page-budget":
        assert sum(s.evictions for s in stats) > 0
        assert sim["memory"]["evictions"] > 0
    if name in ("prefix-cache", "replicas"):
        assert sim["prefix"]["hit_tokens"] > 0
    if name == "replicas":
        assert len(tengines) == 4 and sim["routing"]["routed"] > 0
    if name == "faults-storm":
        assert sim["faults"]["injected"] == 4 and sim["faults"]["sheds"] > 0
    if name == "faults-crash":
        assert sum(s.replays for s in stats) == sim["faults"]["replays"] > 0
        assert sim["faults"]["timeouts"] > 0
    if name == "telemetry":
        assert sim["telemetry"]["events"] and sim["attribution"] is not None
    if name == "concurrent-mixed":
        assert sim["batching"]["enabled"] and sim["batching"]["mixed_steps"]
    if name.startswith("workflow"):
        assert got.e2e_s == want.e2e_s > 0


def test_scenario_run_defaults_to_the_card(monkeypatch):
    """``Scenario.run(substrate="engine")`` reaches the port's runner with
    no device, so it runs on the card: without one it raises rather than
    carrying on on the CPU."""
    monkeypatch.setattr(trunner, "engine_model", VEHICLE)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = VEHICLE.cache_info().currsize
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _concurrent(PORT, "chunked").run()
    # the vehicle was asked for on the card, and nothing was built
    assert VEHICLE.cache_info().currsize == built


@pytest.mark.gpu
def test_vehicle_weights_equal_on_card_and_cpu(monkeypatch):
    """The vehicle on the card is the vehicle on the CPU: the same seed-0
    weights, bit for bit, so a card run and a CPU run execute one model."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(trunner, "engine_model", VEHICLE)
    _, card, _ = VEHICLE("cuda")
    _, cpu, _ = VEHICLE("cpu")
    flat_card = torch.utils._pytree.tree_leaves(card)
    flat_cpu = torch.utils._pytree.tree_leaves(cpu)
    assert len(flat_card) == len(flat_cpu) > 0
    assert all(a.device.type == "cuda" and torch.equal(a.cpu(), b)
               for a, b in zip(flat_card, flat_cpu))
