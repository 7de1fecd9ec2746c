"""The traffic mixes and the tails the end-to-end metrics take."""
import json
import types

import pytest

from portbench.tests.tiny import CLOSED, OPEN, REPO

from portbench import readings, traffic


def _sig(tr):
    flat = tr.plans if tr.kind == "open_poisson" else [
        p for c in tr.plans for p in c]
    return [(p.offset_s, p.max_new_tokens, p.in_window, p.prompt.tolist())
            for p in flat]


@pytest.mark.parametrize("mix", ["chat", "imagegen"])
def test_same_seed_same_traffic_other_seed_same_work(mix):
    spec = json.loads((REPO / "portbench" / "traffic" / f"{mix}.json")
                      .read_text())
    a = traffic.make(spec, 50, 2**31 + 7, 1000)
    b = traffic.make(spec, 50, 2**31 + 7, 1000)
    c = traffic.make(spec, 50, 12345, 1000)
    assert _sig(a) == _sig(b)
    assert _sig(a) != _sig(c)
    # another seed: the same lengths (and gaps), other token ids; the open
    # loop keeps even the order, the closed loop's order is the seed's
    work = lambda t: [(len(x[3]), x[1], x[0]) for x in _sig(t)]
    if mix == "chat":
        assert work(a) == work(c)
    else:
        assert sorted(work(a)) == sorted(work(c)) and work(a) != work(c)
    if mix == "chat":
        win = lambda t: sum(p.in_window for p in t.plans)
        assert win(a) == win(c) == round(spec["rate_per_s"] * 50)
        offs = sorted(p.offset_s for p in a.plans)
        assert offs[0] == 0.0 and offs[-1] < spec["ramp_s"] + 50


def test_open_loop_arrivals_stay_in_ramp_and_window():
    tr = traffic.make(OPEN, 3.0, 5, 256)
    ramp = [p.offset_s for p in tr.plans if not p.in_window]
    win = [p.offset_s for p in tr.plans if p.in_window]
    assert all(0 <= t < OPEN["ramp_s"] for t in ramp)
    assert all(OPEN["ramp_s"] <= t < OPEN["ramp_s"] + 3.0 for t in win)
    assert all(OPEN["prompt"]["min"] <= len(p.prompt) <= OPEN["prompt"]["max"]
               for p in tr.plans)


def test_closed_loop_clients_and_ramp():
    tr = traffic.make(CLOSED, 3.0, 5, 256)
    assert len(tr.plans) == CLOSED["clients"]
    assert tr.ramp_s == CLOSED["clients"] * CLOSED["stagger_s"]
    assert {p.max_new_tokens for c in tr.plans for p in c} == {12}


def test_unknown_kind_is_refused():
    with pytest.raises(ValueError):
        traffic.make({"kind": "nope"}, 1, 1, 10)


def _req(arrival, first, gaps, done=True):
    t = [first + sum(gaps[:i]) for i in range(len(gaps) + 1)]
    return types.SimpleNamespace(
        request_id=id(t), arrival_s=arrival, t_first_token=first,
        t_tokens=t, t_done=t[-1] if done else None,
        ttft=first - arrival, tpot=(t[-1] - t[0]) / max(len(t) - 1, 1))


def _run(reqs, w0=0.0, w1=100.0, t_end=200.0):
    return types.SimpleNamespace(requests=reqs, due=reqs, w0=w0, w1=w1,
                                 t_end=t_end)


def test_tails_cover_every_request_and_every_gap():
    reqs = [_req(i, i + 0.1, [0.05] * 20) for i in range(50)]
    base = readings.percentile(readings.token_gaps_s(_run(reqs)), 95)
    assert len(readings.token_gaps_s(_run(reqs))) == 50 * 20
    assert base == pytest.approx(0.05)
    # a stall inside the window: one request in ten waits 2 s between two
    # tokens; the tail over all gaps sees it
    stalled = [_req(i, i + 0.1, [0.05] * 10 + [2.0] + [0.05] * 9)
               if i % 10 == 0 else r for i, r in enumerate(reqs)]
    assert readings.percentile(readings.token_gaps_s(_run(stalled)),
                               99.9) == pytest.approx(2.0)
    # a stall in many requests moves the 95th percentile itself
    many = [_req(i, i + 0.1, [0.05] * 18 + [2.0, 2.0]) for i in range(50)]
    assert readings.percentile(readings.token_gaps_s(_run(many)), 95) \
        == pytest.approx(2.0)
    # a gap whose later token falls after the window is not counted
    assert len(readings.token_gaps_s(_run(reqs, w1=10.0))) < 1000


def test_ttft_tail_counts_unfinished_requests():
    reqs = [_req(i, i + 0.2, [0.05]) for i in range(9)]
    late = types.SimpleNamespace(request_id=-1, arrival_s=50.0,
                                 t_first_token=None, t_tokens=[],
                                 t_done=None, ttft=None, tpot=None)
    run = _run(reqs + [late], t_end=80.0)
    ttfts = [readings.ttft_s(run, r) for r in run.due]
    assert max(ttfts) == pytest.approx(30.0)
    assert readings.percentile(ttfts, 90) > 0.2
