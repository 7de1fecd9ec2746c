"""The yardstick's arithmetic: the card's peaks and the least time of the
paged attention kernels (a step's model FLOPs are the configuration's
reference module's, ``dispatch_flops``).

The bounds are copies of ``chip_smoke.py``'s ``decode_bound``,
``prefill_bound``, ``bound_entry`` and ``flash_bound_entry``, generalised
from its fixed test shape to any rows: every byte the result needs is
moved once at the HBM rate, every product at the rate of the route the
kernel takes (the decode on the float32 cores; the prefill as two TF32
products a float32 product, a bfloat16 value being exact in TF32), one
exp a visible pair and head; the largest of these.
"""
from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def peaks(kind: str) -> dict | None:
    """The peaks of the card named ``kind`` (``torch.cuda.get_device_name``),
    or None where the table has no such card."""
    return json.loads((HERE / "peaks.json").read_text()).get(kind)


def decode_bound_s(pk: dict, rows: int, kv_lens, h: int, kv: int, d: int,
                   table_bytes: int) -> float:
    """One paged decode launch: ``rows`` queries (float32 in and out), the
    bfloat16 keys and values of ``kv_lens`` positions a row read once, the
    block-table entries and the lengths."""
    n = int(sum(kv_lens))
    byts = rows * h * d * 4 * 2 + n * kv * d * 2 * 2 + table_bytes + rows * 4
    flops = 4 * d * h * n
    return max(byts / pk["hbm_bytes_per_s"], flops / pk["f32_flops_per_s"])


def prefill_pairs(rows) -> int:
    """Visible (query, key) pairs of one head: token j of a row of ``n``
    tokens starting at ``s`` sees ``s + j + 1`` positions."""
    return sum(n * (s + 1) + n * (n - 1) // 2 for s, n in rows)


def prefill_bound_s(pk: dict, rows, h: int, kv: int, d: int,
                    table_bytes: int) -> float:
    """One paged prefill launch over ``rows`` = [(start, tokens)]: q read
    and o written once (float32), the visible keys and values read once
    (bfloat16), table and starts; q·k and p·v at two TF32 products a
    float32 product; an exp a visible pair and head."""
    q_tok = sum(n for _, n in rows)
    visible = sum(s + n for s, n in rows)
    byts = (q_tok * h * d * 4 * 2 + visible * kv * d * 2 * 2 + table_bytes
            + len(rows) * 4)
    pairs = prefill_pairs(rows)
    t_ops = max(4 * d * h * pairs / (pk["tf32_mma_flops_per_s"] / 2),
                h * pairs / pk["exp_per_s"])
    return max(byts / pk["hbm_bytes_per_s"], t_ops)
