"""Serving launcher: run the continuous-batching engine on a trace.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --requests 8 --policy chunked            # on the GPU (default)
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch seamless-m4t-large-v2 --reduced --device cpu

Same CLI as ``repro.launch.serve`` plus ``--device`` and ``--page-size``.
Every config in the registry serves, each family on its own cache: the
transformer families (dense, moe, vlm), hybrid's attention sublayers and
enc-dec's decoder self-KV on the paged KV pool, mamba2 on its
slot-resident recurrent state (``cache_pages()``). Weights are random,
drawn from ``--seed``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.bench.policy import available_policies
from repro_torch.configs.registry import get_config
from repro_torch.models.factory import build_model
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.request import chat_trace


def main(argv=None, *, paged: "bool | None" = None,
         layers: "int | None" = None) -> InferenceEngine:
    """Serve ``--requests`` chat requests to completion; returns the
    engine (its ``done`` requests and ``stats``). ``paged``: the engine's
    cache (None: the family's own; False: the contiguous cache);
    ``layers``: keep only the first ``layers`` layers (hybrid: whole
    periods; enc-dec: of the encoder and of the decoder), the widths
    untouched. Both are keywords for callers, not flags of the CLI."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--policy", default="chunked",
                    choices=available_policies())
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
        if cfg.family == "encdec":
            cfg = dataclasses.replace(cfg, num_encoder_layers=layers,
                                      num_decoder_layers=layers)
    model = build_model(cfg, device=args.device)
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    params = model.init(gen)

    engine = InferenceEngine(model, max_slots=args.slots,
                             max_seq=args.max_seq, policy=args.policy,
                             prefill_chunk=args.prefill_chunk,
                             paged=paged, page_size=args.page_size)
    engine.load_params(params)
    for req in chat_trace(args.requests, cfg.vocab_size,
                          mean_prompt=24, max_new=args.max_new,
                          seed=args.seed):
        engine.submit(req)
    t0 = time.monotonic()
    done = engine.run()
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    wall = time.monotonic() - t0
    ttfts = [r.ttft for r in done if r.ttft is not None]
    tpots = [r.tpot for r in done if r.tpot is not None]
    print(f"[serve] device={model.device} arch={cfg.name} "
          f"cache={'paged' if engine.paged else 'contiguous'} "
          f"policy={args.policy} done={len(done)} "
          f"decode_tokens={engine.stats.decode_tokens} "
          f"prefill_tokens={engine.stats.prefill_tokens}")
    print(f"[serve] ttft mean={np.mean(ttfts):.4f}s "
          f"p95={np.percentile(ttfts, 95):.4f}s | "
          f"tpot mean={np.mean(tpots):.5f}s | "
          f"decode tokens/s={engine.stats.decode_tokens / wall:.1f} | "
          f"wall={wall:.3f}s | "
          f"max decode gap={engine.stats.max_decode_gap_s:.4f}s")
    print(f"[serve] stats {dataclasses.asdict(engine.stats)}")
    return engine


if __name__ == "__main__":
    main()
