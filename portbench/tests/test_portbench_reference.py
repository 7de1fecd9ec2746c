"""The plain reference against repro_torch at reduced width on the CPU;
the control that the limits must refuse; the faults of the timed path
that ``correct`` must catch; and the frozen copies of the roofline
bounds."""
import pytest
import torch

from portbench.tests.tiny import few_threads, run_tiny, tiny_root  # noqa: F401

from portbench import roofline
from portbench.reference import transformer as ref


@pytest.mark.parametrize("seed", [2**31 + 11, 2**31 + 12, 2**31 + 13])
def test_open_loop_cell_is_correct_and_its_control_is_not(tiny_root,
                                                          few_threads, seed):
    """The port passes; the reference in TF32 in its place, judged by the
    same limits through the same comparison, does not."""
    got = {}
    out = run_tiny(tiny_root, "t.open", seed=seed, control=True,
                   readings=got)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 5
    assert got["control_correct"] is False, got
    assert got["control_max_gap"] > out["checks"]["max_gap"]["limit"]


def test_dense_closed_loop_cell_is_correct(tiny_root, few_threads):
    out = run_tiny(tiny_root, "t.dense", traced=True, seconds=3.0)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 3
    assert "decode_stall_share.image" in out["metrics"]


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11,
                      -(1.0 + 2**-12), 3.0], dtype=torch.float32)
    want = [1.0 + 2**-10, 1.0, 1.0 + 2**-9, -1.0, 3.0]
    assert ref.to_tf32(x).tolist() == want
    a = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
    with ref.matmul_precision(True):
        low = ref.mm(a, a)
    assert not torch.equal(low, a @ a)
    assert torch.allclose(low, a @ a, rtol=0, atol=5e-2)
    assert torch.equal(ref.mm(a, a), a @ a)


def _stale_state(engine, pf, dc):
    """Every decode step leaves the cache as it found it."""
    def dc2(params, cache, tokens, lengths, tables, active=None):
        saved = {k: v.clone() for k, v in cache.items()
                 if torch.is_tensor(v)}
        out = dc(params, cache, tokens, lengths, tables, active)
        for k, v in saved.items():
            cache[k].copy_(v)
        return out
    return pf, dc2


def _half_batch(engine, pf, dc):
    """Every decode step runs half of its rows; the others get the mean of
    the rows that ran."""
    def dc2(params, cache, tokens, lengths, tables, active=None):
        rows = torch.nonzero(active).flatten()
        keep = active.clone()
        left = rows[len(rows) // 2:] if len(rows) > 1 else rows[:0]
        keep[left] = False
        logits, cache = dc(params, cache, tokens, lengths, tables, keep)
        if len(left):
            logits = logits.clone()
            logits[left] = logits[rows[:len(rows) // 2]].mean(dim=0)
        return logits, cache
    return pf, dc2


def _altered_token(engine, pf, dc):
    """Every fourth decode step's tokens come out one id off."""
    n = [0]

    def dc2(params, cache, tokens, lengths, tables, active=None):
        logits, cache = dc(params, cache, tokens, lengths, tables, active)
        n[0] += 1
        if n[0] % 4 == 0:
            logits = torch.roll(logits, 1, dims=-1)
        return logits, cache
    return pf, dc2


@pytest.mark.parametrize("fault", [_stale_state, _half_batch, _altered_token],
                         ids=["state_unchanged", "half_batch", "token_altered"])
@pytest.mark.parametrize("cell", ["t.open", "t.dense"])
def test_a_broken_timed_path_is_not_correct(tiny_root, few_threads, fault,
                                            cell):
    out = run_tiny(tiny_root, cell, fault=fault)
    assert not out["correct"], out["checks"]


def test_bound_copies_reproduce_the_kernel_table():
    """chip_smoke.py's shapes (4 rows, 32 heads over 4 KV heads of 64, 16
    table entries a row): the bound column of PERF.md's kernel table."""
    pk = roofline.peaks("NVIDIA H100 80GB HBM3")
    dec = roofline.decode_bound_s(pk, 4, [37, 256, 1, 0], 32, 4, 64,
                                  4 * 16 * 4)
    pre = roofline.prefill_bound_s(pk, [(s, 16) for s in (0, 7, 200, 240)],
                                   32, 4, 64, 4 * 16 * 4)
    assert f"{dec * 1e3:.6f}" == "0.000110"
    assert f"{pre * 1e3:.6f}" == "0.000469"


def test_step_flops_count_the_layers_visible_pairs_and_used_logits():
    m = {"d_model": 8, "num_heads": 2, "num_kv_heads": 1, "head_dim": 4,
         "num_layers": 3, "d_ff": 6}
    per_tok = 2 * 3 * (8 * 4 * 4 + 8 * 8 + 3 * 8 * 6)
    assert ref.token_flops(m) == per_tok
    # two rows: 3 new tokens after 5 cached, 1 token after 9
    f = ref.dispatch_flops(m, [(5, 3), (9, 1)], False, 100)
    pairs = 3 * 6 + 3 + 10
    assert f == 4 * per_tok + 4 * 3 * 2 * 4 * pairs
    assert ref.dispatch_flops(m, [(9, 1)], True, 100) == \
        per_tok + 4 * 3 * 2 * 4 * 10 + 2 * 8 * 100 * 1
