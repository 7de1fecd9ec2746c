"""The paged prefill dispatch on its active rows alone.

``ModelBundle.prefill_chunk_paged`` gathers the rows ``active`` marks into
a batch of their own where ``packs_prefill_rows()`` (the dense and vlm
transformers) and runs every row as before for the other families. Reduced
configs on the CPU, a page pool of 4 slots holding a random bfloat16
history, inactive rows at long cached lengths:

* packed against today's dispatch (``transformer.prefill_chunk_paged`` on
  the whole batch with the mask): the active rows' logits and the pools
  agree within 2e-5, and the attention kernel sees the active rows alone;
* no page is written but the active rows' own and the drop page;
* the input tensors are left as they were;
* moe, hybrid and enc-dec keep today's dispatch, output for output.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import CONFIGS
from repro_torch.kernels import ops
from repro_torch.models import encdec, hybrid, transformer
from repro_torch.models.factory import build_model

torch.set_num_threads(2)

B, PAGE, NB, C = 4, 8, 8, 6
POOL = B * NB
DROP = POOL                  # the pool's extra last page
F32 = 2e-5
#: start lengths: rows 1 and 3 hold long caches
START = [3, 50, 17, 57]
ACTIVE = {"two rows": [True, False, True, False],
          "one row": [False, False, False, True]}
VALID = {"mixed": [C, C, 2, 4], "full": None}
#: family -> the module whose prefill_chunk_paged the bundle dispatches to
PLAIN = {"moonshot-v1-16b-a3b": transformer, "jamba-v0.1-52b": hybrid,
         "seamless-m4t-large-v2": encdec}

_BUNDLES = {}


def bundle(arch):
    """(bundle, params) of the reduced config: two layers, hybrid's two
    periods, enc-dec's two of each."""
    if arch not in _BUNDLES:
        cfg = CONFIGS[arch].reduced()
        if cfg.family != "hybrid":
            cfg = dataclasses.replace(cfg, num_layers=2)
        if cfg.family == "encdec":
            cfg = dataclasses.replace(cfg, num_encoder_layers=2,
                                      num_decoder_layers=2)
        m = build_model(cfg, "cpu")
        _BUNDLES[arch] = m, m.init(torch.Generator().manual_seed(0))
    return _BUNDLES[arch]


def _fill(tree, gen):
    """A random history in every floating leaf (pages and slot-resident
    state), in place."""
    for leaf in tree.values():
        if isinstance(leaf, dict):
            _fill(leaf, gen)
        elif leaf.is_floating_point():
            leaf.copy_(0.3 * torch.randn(leaf.shape, generator=gen))


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def _setup(m, active, valid):
    gen = torch.Generator().manual_seed(1)
    cache = m.init_paged_cache(POOL, PAGE, B, NB * PAGE)
    _fill(cache, gen)
    tables = torch.randperm(POOL, generator=gen).to(torch.int32).reshape(
        B, NB)
    tokens = torch.randint(0, m.cfg.vocab_size, (B, C), generator=gen,
                           dtype=torch.int32)
    args = (tokens, torch.tensor(START, dtype=torch.int32), tables,
            torch.tensor(active),
            None if valid is None else torch.tensor(valid,
                                                    dtype=torch.int32))
    return cache, args


def _kernel_rows(monkeypatch):
    """The batch rows of every paged prefill attention launch."""
    seen = []
    launch = ops.attention_prefill_chunk_paged

    def counted(q, *a, **k):
        seen.append(q.shape[0])
        return launch(q, *a, **k)
    monkeypatch.setattr(ops, "attention_prefill_chunk_paged", counted)
    return seen


@pytest.mark.parametrize("valid", sorted(VALID))
@pytest.mark.parametrize("active", sorted(ACTIVE))
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "chameleon-34b"])
def test_packed_rows_match_the_whole_batch(arch, active, valid,
                                           monkeypatch):
    m, params = bundle(arch)
    assert m.packs_prefill_rows()
    act, val = ACTIVE[active], VALID[valid]
    cache, args = _setup(m, act, val)
    before, kept = _clone(cache), [None if a is None else a.clone()
                                   for a in args]
    want_cache = _clone(cache)
    want, _ = transformer.prefill_chunk_paged(params, want_cache, *args[:3],
                                              m.cfg, *args[3:])
    rows = _kernel_rows(monkeypatch)
    got, out = m.prefill_chunk_paged(params, cache, *args)
    assert out is cache and got.shape == want.shape
    # the kernel ran once a layer on the active rows alone
    assert rows == [sum(act)] * m.cfg.num_layers
    # the input tensors are as they were
    for a, b in zip(args, kept):
        assert (a is None and b is None) or torch.equal(a, b)
    for r in np.flatnonzero(act):
        n = C if val is None else val[r]
        torch.testing.assert_close(got[r, :n], want[r, :n], atol=F32,
                                   rtol=F32)
    # pools: equal to today's dispatch but on the drop page, and written
    # only where an active row's real tokens fall
    for key in m.PAGE_KEYS:
        torch.testing.assert_close(cache[key][:, :DROP].float(),
                                   want_cache[key][:, :DROP].float(),
                                   atol=F32, rtol=F32)
        changed = (cache[key] != before[key]).any(dim=(0, 3, 4))
        want_changed = torch.zeros_like(changed)
        for r in np.flatnonzero(act):
            n = C if val is None else val[r]
            for pos in range(START[r], START[r] + n):
                want_changed[args[2][r, pos // PAGE], pos % PAGE] = True
        assert torch.equal(changed[:DROP], want_changed[:DROP])


@pytest.mark.parametrize("arch", sorted(PLAIN))
def test_other_families_keep_todays_dispatch(arch, monkeypatch):
    m, params = bundle(arch)
    assert not m.packs_prefill_rows()
    cache, args = _setup(m, ACTIVE["two rows"], VALID["mixed"])
    want_cache = _clone(cache)
    want, _ = PLAIN[arch].prefill_chunk_paged(params, want_cache,
                                              *args[:3], m.cfg, *args[3:])
    rows = _kernel_rows(monkeypatch)
    got, _ = m.prefill_chunk_paged(params, cache, *args)
    assert set(rows) <= {B}                      # every row, as before
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    for key in cache:
        torch.testing.assert_close(cache[key], want_cache[key], atol=0,
                                   rtol=0)
