"""How ``correct`` is decided: the served tokens against the reference.

After the window (and the program's state freed), a sample of the
finished requests due in the window, drawn from the seed with the longest
among them, is run through the configuration's reference module (named
in its file; ``harness.load_reference``) over each request's prompt and
served tokens. Each served token was the
program's argmax; its reading is how far the reference's logit of that
token lies below the reference's best at the same position (0 where the
reference agrees). Read, and compared where ``limits/<cell>.json`` gives a limit:

* ``max_gap``: the widest such gap over the sample;
* ``mean_gap``: the mean gap over the sample's served tokens;
* ``flip_share``: the share of served tokens that are not the
  reference's argmax;
* ``streams`` (always compared, limit 0): finished requests due in the
  window (all, not only the sample) whose tokens fed to the model are not
  the prompt, the last prompt token again (the engine's first decode
  input) and the served tokens but the last.

``control=True`` also reads the control (the reference in TF32 in the
program's place: the token TF32 puts first is its served token) and
holds its numbers to the same limits: ``control_correct``, which has to
come out false.
"""
from __future__ import annotations

import numpy as np
import torch


class Unreplayable(Exception):
    """The dispatches cannot be replayed row for row."""


def build_tokens(ref, disp: list, keep: set):
    """The recorded rows of the requests in ``keep`` as the reference
    module's ``Tokens``, each request's from position 0 on, once each."""
    seq, pos, ids = [], [], []
    for d in disp:
        for s, n, r in d["rows"]:
            req = d["slots"][r]
            if req in keep:
                seq.append(np.full(n, req, np.int64))
                pos.append(np.arange(s, s + n, dtype=np.int64))
                ids.append(d["tokens"][r, :n].astype(np.int64))
    if not seq:
        raise Unreplayable("no rows recorded")
    seq, pos, ids = (np.concatenate(x) for x in (seq, pos, ids))
    srt = np.lexsort((pos, seq))
    seq, pos, ids = seq[srt], pos[srt], ids[srt]
    first = np.concatenate([[True], seq[1:] != seq[:-1]])
    start = np.maximum.accumulate(np.where(first, np.arange(len(seq)), 0))
    if np.any(pos != np.arange(len(seq)) - start):
        raise Unreplayable("a request's positions are not 0, 1, 2, ... once "
                           "each (recomputed or skipped rows)")
    return ref.Tokens(seq, pos, ids)


def sample(done: list, k: int, seed: int) -> list:
    """The longest finished request (most served tokens, lowest id on a
    tie) and ``k - 1`` others drawn from the seed."""
    if not done:
        return []
    done = sorted(done, key=lambda r: r.request_id)
    longest = max(done, key=lambda r: (len(r.tokens_out), -r.request_id))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([seed, 3])
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def _bounds(tok) -> dict:
    """Each request's [lo, hi) rows in ``tok``."""
    cuts = np.flatnonzero(np.diff(tok.seq)) + 1
    return {int(tok.seq[lo]): (int(lo), int(hi)) for lo, hi in
            zip(np.concatenate([[0], cuts]),
                np.concatenate([cuts, [len(tok.seq)]]))}


def streams(tok, done: list) -> int:
    """Finished requests whose recorded inputs are not the prompt, the
    last prompt token again and the served tokens but the last."""
    bounds, bad = _bounds(tok), 0
    for r in done:
        lo, hi = bounds.get(r.request_id, (0, 0))
        p = np.asarray(r.prompt, np.int64)
        fed = np.concatenate([p, p[-1:], np.asarray(r.tokens_out[:-1],
                                                    np.int64)])
        bad += int(hi - lo != len(fed) or np.any(tok.ids[lo:hi] != fed))
    return bad


def judge(ref, params: dict, m: dict, disp: list, due: list, limits: dict,
          opts: dict, seed: int, device, log=print,
          control: bool = False) -> dict:
    """The verdict of the reference module ``ref``: ``correct`` and each
    compared number with its limit (``checks``); with ``control``, the
    control's readings and ``control_correct`` too."""
    done = [r for r in due if r.t_done is not None]
    picked = sample(done, int(opts.get("requests", 4)), seed)
    checks: dict = {}
    try:
        if not picked:
            raise Unreplayable("no request due in the window finished")
        bad = streams(build_tokens(ref, disp, {r.request_id for r in done}),
                      done)
        tok = build_tokens(ref, disp, {r.request_id for r in picked})
        bounds = _bounds(tok)
        want, served = [], []
        for r in picked:
            lo, _ = bounds[r.request_id]
            p = len(r.prompt)
            want.append(np.arange(lo + p, lo + p + len(r.tokens_out)))
            served.append(np.asarray(r.tokens_out, np.int64))
        want, served = np.concatenate(want), np.concatenate(served)
        at = (served,)
        if control:
            _, arg32, _ = ref.read_rows(params, m, tok, want, device,
                                        tf32=True)
            at = (served, arg32)
        best, arg, picked_logits = ref.read_rows(params, m, tok, want,
                                                 device, at=at)
        gap = best - picked_logits[0]
        numbers = {"max_gap": float(gap.max()), "mean_gap": float(gap.mean()),
                   "flip_share": float(np.mean(arg != served)),
                   "streams": bad}
        log(f"portbench: compared {len(served)} served tokens of "
            f"{len(picked)} requests ({len(tok.seq)} rows run); "
            f"argmax agrees at {float(np.mean(arg == served)):.6f}")
        if control:
            cgap = best - picked_logits[1]
            cnum = {"max_gap": float(cgap.max()),
                    "mean_gap": float(cgap.mean()),
                    "flip_share": float(np.mean(arg32 != arg))}
            numbers.update({f"control_{k}": v for k, v in cnum.items()})
            # the look: the float32 reference judged against float64 as the
            # program is judged against float32
            best64, _, p64 = ref.read_rows(params, m, tok, want, device,
                                           at=(arg,), dtype=torch.float64)
            lgap = best64 - p64[0]
            numbers["look_f32_max_gap"] = float(lgap.max())
            numbers["look_f32_mean_gap"] = float(lgap.mean())
            numbers["look_f32_flip_share"] = float(np.mean(lgap > 0))

    except Unreplayable as exc:
        log(f"portbench: not correct: {exc}")
        return {"correct": False, "readings": {},
                "checks": {"replayable": {"value": 0, "limit": 1}}}
    ok = True
    for name, spec in limits.items():
        v = numbers[name]
        checks[name] = {"value": v, "limit": spec["limit"]}
        ok &= v <= spec["limit"]
    checks["streams"] = {"value": bad, "limit": 0}
    ok &= bad == 0
    out = {"correct": bool(ok), "checks": checks, "readings": numbers}
    if control:
        # the control in the program's place, held to the same limits
        out["control_correct"] = all(cnum[name] <= spec["limit"]
                                     for name, spec in limits.items())
        numbers["control_correct"] = out["control_correct"]
    log("portbench: readings " + " ".join(f"{k} {v!r}"
                                          for k, v in numbers.items()))
    return out
