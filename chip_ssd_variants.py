#!/usr/bin/env python3
"""The SSD chunk scan's two kernels on chunks of up to 64 positions, on one
GPU: ``ssd_resident`` (the chunk staged whole, warp roles, the state from
a task queue), which the wrapper launches there, against ``ssd_streamed``
(the kernel of longer chunks) with its ring sized to the chunk.

  python3 chip_ssd_variants.py

The wrapper has no way to launch the streamed kernel on a short chunk, so
this script copies ``csrc/`` into the gitignored build directory, gives
the copy's C entry a flag that takes the streamed kernel at any Q (a ring
of max(2, tiles) slots below 5 tiles, no C·Bᵀ fragments), and builds it
beside the repo's own library. At mamba2-1.3b's widths (H 64, P 64,
N 128), M 1 and 4, Q 16 and 64, every P slice: each kernel is held
against the plain version (2e-5 + 2e-5·|plain|) and timed (CUDA events,
chip_smoke.timed_ms), in three rounds that alternate the two kernels, so
that drift shows as a spread within one kernel. Prints a table and, as
its last line, a JSON object of every time; exits nonzero on a failed
check.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

#: (old, new) edits of csrc/ssd_chunk_scan.cu: a `streamed` flag through
#: Layout, Args and the C entry
PATCH = [
    ("Layout(int Q, int ps, int N)\n",
     "Layout(int Q, int ps, int N, bool streamed = false)\n"),
    ("cb(nt <= kResidentTiles ?", "cb(nt <= kResidentTiles && !streamed ?"),
    ("stages(nt <= kResidentTiles ? nt\n",
     "stages(nt <= kResidentTiles ? (streamed ? (nt < 2 ? 2 : nt) : nt)\n"),
    ("resident(nt <= kResidentTiles)",
     "resident(nt <= kResidentTiles && !streamed)"),
    ("  int vec;", "  int streamed;\n  int vec;"),
    ("L(args.Q, PS, args.N)", "L(args.Q, PS, args.N, args.streamed != 0)"),
    ("const Layout L(a.Q, PS, a.N);",
     "const Layout L(a.Q, PS, a.N, a.streamed != 0);"),
    ("int ps, void* stream) {", "int ps, int streamed, void* stream) {"),
    ("Q, H, P, N,\n", "Q, H, P, N, streamed,\n"),
]
SHAPES = [(1, 16), (4, 16), (1, 64), (4, 64)]
H, P, N = 64, 64, 128
ROUNDS = 3


def build_variant() -> ctypes.CDLL:
    from repro_torch.kernels import build
    out = build.BUILD_DIR / "variants"
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(build.CSRC, out)
    src = out / "ssd_chunk_scan.cu"
    text = src.read_text()
    for old, new in PATCH:
        if text.count(old) != 1:
            sys.exit(f"chip_ssd_variants: edit not found once: {old!r}")
        text = text.replace(old, new)
    src.write_text(text)
    lib = out / "ssd_variants.so"
    res = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                          str(src)], capture_output=True, text=True)
    if res.returncode != 0:
        sys.exit(f"chip_ssd_variants: nvcc failed:\n{res.stdout}{res.stderr}")
    dll = ctypes.CDLL(str(lib))
    dll.ssd_chunk_scan.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                                   + [ctypes.c_void_p])
    return dll


def main() -> None:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import SLICES, launch
    if not torch.cuda.is_available():
        sys.exit("chip_ssd_variants: needs a CUDA card")
    smi = cs.device_phase(torch)
    dll = build_variant()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)

    def streamed(args, ps):
        x, dt, cum, b_, c_ = args
        m, q, h, p = x.shape
        y = torch.empty_like(x)
        st = torch.empty((m, h, p, N), device=dev)
        rc = dll.ssd_chunk_scan(
            x.data_ptr(), dt.data_ptr(), cum.data_ptr(), b_.data_ptr(),
            c_.data_ptr(), y.data_ptr(), st.data_ptr(), m, q, h, p, N, ps, 1,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            sys.exit(f"chip_ssd_variants: launch failed ({rc})")
        return y, st

    kernels = {"resident": lambda args, ps: launch(*args, ps),
               "streamed": streamed}
    inputs = {}
    for m, q in SHAPES:
        args = cs.ssd_inputs(torch, gen, dev, q, m, H, P, N)
        inputs[m, q] = args
        want_y, want_st = ref.ssd_chunk_ref(*args)
        for name, fn in kernels.items():
            for ps in SLICES:
                y, st = fn(args, ps)
                torch.cuda.synchronize()
                cs.check_close(f"{name} y M={m} Q={q} ps={ps}", y, want_y)
                cs.check_close(f"{name} state M={m} Q={q} ps={ps}", st,
                               want_st)
    print("[variants] both kernels within 2e-5 + 2e-5*|plain| at every "
          "shape and P slice", flush=True)
    times: dict[str, list[float]] = {}
    for rnd in range(ROUNDS):
        order = list(kernels) if rnd % 2 == 0 else list(kernels)[::-1]
        for m, q in SHAPES:
            for name in order:
                for ps in SLICES:
                    key = f"{name} M={m} Q={q} ps={ps}"
                    times.setdefault(key, []).append(cs.timed_ms(
                        torch, lambda: kernels[name](inputs[m, q], ps)))
    print(f"[variants] {smi}")
    for m, q in SHAPES:
        best = {}
        for name in kernels:
            rows = {ps: times[f"{name} M={m} Q={q} ps={ps}"]
                    for ps in SLICES}
            for ps, ts in rows.items():
                print(f"[variants] M={m} Q={q} {name:8s} ps={ps:2d}: "
                      + ", ".join(f"{t:.5f}" for t in ts) + " ms")
            best[name] = min(rows.items(), key=lambda kv: min(kv[1]))
        (rp, rt), (sp, st) = best["resident"], best["streamed"]
        print(f"[variants] M={m} Q={q}: best resident ps={rp} "
              f"{min(rt):.5f}-{max(rt):.5f} ms, best streamed ps={sp} "
              f"{min(st):.5f}-{max(st):.5f} ms, streamed/resident "
              f"{min(st) / min(rt):.2f}")
    print(json.dumps({"ms": times}))


if __name__ == "__main__":
    main()
