#!/usr/bin/env python3
"""A/B of two trees of this repository on one GPU: serving kernels and
paths, and the RMSNorm and SSD chunk-scan kernels with the Mamba2 path.

  python3 chip_ab.py PARENT_DIR [CHANGE_DIR]   # CHANGE_DIR: this tree

PARENT_DIR is an unpacked ``git archive`` of the other commit (in a
directory that .gitignore lists, e.g. chip_check/). Each tree runs in its
own process, in the order parent, change, change, parent, so that drift of
the card or the host shows as a difference between the two runs of one
tree. Each process, with that tree's own code (its chip_smoke.py phase
functions unless said otherwise):

* builds the four serving attention kernels, the flash forward, the SSD
  chunk scan and RMSNorm;
* holds the paged and contiguous serving kernels against their plain
  versions and times them at the serving shapes (phase 3), and the
  contiguous decode at the whole-prompt shape (this tree's
  ``whole_prompt_decode_row`` on that tree's kernel);
* times the SSD chunk scan at Q = 16 and 256 and RMSNorm at 4096 x 2048 in
  float32 and bfloat16, beside F.rms_norm (this tree's ``ssd_rows`` and
  ``rmsnorm_rows`` on that tree's kernels);
* serves the chat trace on paged and contiguous tinyllama-1.1b and on
  mamba2-1.3b with exact launch counts (phase 4: TTFT, TPOT), and profiles a
  paged decode step and prefill chunk and a mamba2 prefill chunk (host
  wall, device busy);
* runs the whole-prompt prefill and its 16 decode steps (this tree's phase
  5 on that tree's code: the decode step's median, the prefill and a
  decode step profiled).

Needs one card; exits nonzero if any process fails.
"""
from __future__ import annotations

import importlib.util
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def one(root: str) -> None:
    import torch
    import torch.nn.functional as F
    sys.path[:0] = [root + "/src", root]
    import chip_smoke as cs
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build, ref
    from repro_torch.launch import serve

    tag = f"[ab {root}]"
    cs.device_phase(torch)
    resolve_device("cuda")
    t0 = time.monotonic()
    build.build(["paged_decode_attention", "paged_prefill_attention",
                 "decode_attention", "prefill_attention", "flash_attention",
                 "ssd_chunk_scan", "rmsnorm"])
    print(f"{tag} built in {time.monotonic() - t0:.1f}s", flush=True)
    K = cs.wrappers()
    dev = torch.device("cuda")
    out = {}
    gen = torch.Generator(device=dev).manual_seed(1234)
    cs.paged_kernel_phase(torch, F, K, ref, gen, dev, out)
    cs.contiguous_kernel_phase(torch, F, K, ref, gen, dev, out)
    here = _this_smoke()
    if here.WHOLE_PROMPT_ROW not in out:      # a tree from before the row
        out[here.WHOLE_PROMPT_ROW] = here.whole_prompt_decode_row(
            torch, F, K["decode_attention"], ref, gen, dev)
    for name, r in out.items():
        print(f"{tag} {name}: kernel {r['ms']:.6f} ms | sdpa "
              f"{r['library_ms']:.6f} ms", flush=True)
    for q, r in here.ssd_rows(torch, K["ssd_chunk_scan"], ref, gen,
                              dev).items():
        print(f"{tag} ssd_chunk_scan M={cs.SSD_M} Q={q}: kernel "
              f"{r['ms']:.6f} ms | max abs err {r['max_abs_err']:.3e} | "
              f"bound {r['bound_ms']:.6f} ms", flush=True)
    for dname, r in here.rmsnorm_rows(torch, F, K["rmsnorm"], ref, gen,
                                      dev).items():
        print(f"{tag} rmsnorm {here.RMS_R}x{here.RMS_D} {dname}: kernel "
              f"{r['ms']:.6f} ms | F.rms_norm {r['library_ms']:.6f} ms | "
              f"max abs err {r['max_abs_err']:.3e} | bound "
              f"{r['bound_ms']:.6f} ms", flush=True)
    engine, _ = cs.serve_phase(torch, serve, K, "paged tinyllama-1.1b")
    model, params = engine.model, engine.params
    cache = model.init_paged_cache(1 + 4 * cs.NB, cs.PAGE, cs.B, cs.S)
    bt = torch.arange(1, 1 + cs.B * cs.NB, dtype=torch.int32,
                      device=dev).reshape(cs.B, cs.NB)
    ln, act, tok1, tokc = cs.dispatch_inputs(torch, engine.cfg.vocab_size,
                                             dev)
    cs.profile_dispatches(torch, tag, {
        "decode step": lambda: model.decode_step_paged(
            params, cache, tok1, ln, bt, act),
        "prefill chunk": lambda: model.prefill_chunk_paged(
            params, cache, tokc, ln, bt, act, None),
    }, n=20)
    del engine, model, params, cache
    cs.serve_phase(torch, serve, K, "contiguous tinyllama-1.1b")
    torch.cuda.empty_cache()
    engine, _ = cs.serve_phase(torch, serve, K, "mamba2-1.3b")
    model, params = engine.model, engine.params
    cache = model.init_cache(cs.B, cs.S)
    ln, act, tok1, tokc = cs.dispatch_inputs(torch, engine.cfg.vocab_size,
                                             dev)
    cs.profile_dispatches(torch, f"{tag} mamba2-1.3b", {
        "prefill chunk": lambda: model.prefill_chunk(params, cache, tokc, ln,
                                                     act, None),
    }, n=20)
    del engine, model, params, cache
    torch.cuda.empty_cache()
    here.prefill_phase(torch, K)


def _this_smoke():
    """This tree's chip_smoke.py, whatever tree the process imports from."""
    spec = importlib.util.spec_from_file_location("chip_smoke_ab",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv: list[str]) -> None:
    if len(argv) == 2 and argv[0] == "--one":
        one(argv[1])
        return
    if len(argv) not in (1, 2):
        sys.exit(__doc__)
    parent = str(Path(argv[0]).resolve())
    change = str(Path(argv[1]).resolve()) if len(argv) == 2 else str(ROOT)
    for root in (parent, change, change, parent):
        rc = subprocess.run([sys.executable, __file__, "--one", root]).returncode
        if rc:
            sys.exit(f"chip_ab: the run of {root} failed (exit {rc})")


if __name__ == "__main__":
    main(sys.argv[1:])
