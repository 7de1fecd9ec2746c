"""Multi-pod dry run: every (arch x shape x mesh) cell on a simulated mesh,
nothing allocated, and its roofline terms.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
      --shape train_4k [--multi-pod] [--out results.jsonl]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--autotune]

Counterpart of :mod:`repro.launch.dryrun`. PyTorch has no compiler pass
to read, so *lowering* a cell here means running it: the abstract
parameters, optimizer state, batch and cache are placed as DTensors on a
``(16, 16)`` or ``(2, 16, 16)`` mesh of a fake process group (256 or 512
ranks, ``init_process_group("fake")``; this process is rank 0), each
rank's shard an empty tensor of a ``FakeTensorMode``, and the train,
prefill or serve step runs once on them, eagerly, taking the plain
(CPU) path of every op. Nothing is allocated and no value means anything;
what the run shows is what rank 0 would execute:

* FLOPs: ``torch.utils.flop_counter``'s formulas (``FlopCounterMode``'s
  registry) on each op rank 0 runs, at its local shapes;
* bytes accessed: each such op's input and output bytes on the local
  shards (views and collectives excluded);
* collectives: counted with ``CommDebugMode``, and each kind's bytes (the
  output of each collective, ``roofline.analysis.collective_stats``'s
  measure) summed on the local shards; the detail dict has that
  function's keys;
* memory: the argument and output bytes a rank holds, from the shard
  shapes. An eager run has no compiler's buffer plan, so temp and peak
  bytes are the reason string in ``memory_analysis`` (JAX stores its
  exception's there).

The eager run counts every layer, so no depth variants are extrapolated
(JAX lowers 1- and 2-layer variants because XLA counts a loop body once);
the document's ``notes`` says so. Its seconds — ``compute_s``,
``memory_s``, ``collective_s``, ``step_time_s`` — are the analytic ones of
the simulated chip it names (``roofline.hw.DEFAULT_CHIP``, ``tpu-v5e``),
as a Scenario's virtual clock is: they are not times of any device this
process ran on. ``compile_s`` is this process's wall time for the run.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from dataclasses import dataclass, field

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import (FakeTensorMode,
                                          unset_fake_temporarily)
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import _pop_mode, _push_mode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import CONFIGS, get_config
from repro_torch.configs.shapes import SHAPES, cell_is_applicable, get_shape
from repro_torch.distributed import hints, sharding
from repro_torch.launch.mesh import make_production_mesh, mesh_name
from repro_torch.models.factory import build_model
from repro_torch.roofline import analysis
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_step import (make_prefill_step,
                                             make_serve_step,
                                             make_train_step)
from repro_torch.training.tree import tree_map

#: what an eager run cannot give where XLA gives temp and peak bytes
NO_BUFFER_PLAN = ("not measured: an eager run has no buffer plan to read "
                  "temp or peak bytes from")


def _opt_cfg(cfg: ModelConfig) -> OptimizerConfig:
    name = "adafactor" if cfg.name in sharding.ADAFACTOR_ARCHS else "adamw"
    return OptimizerConfig(name=name)


class SkipCell(Exception):
    pass


# ------------------------------------------------------------- counting

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced":
    "all-gather", "all_reduce": "all-reduce", "all_reduce_coalesced":
    "all-reduce", "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "collective-permute",
    "permute_tensor": "collective-permute",
}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


@dataclass
class CellCosts:
    """What rank 0 ran: FLOPs, bytes accessed, collectives (the keys of
    ``analysis.collective_stats``), and the bytes of its argument and
    output shards."""
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collectives: dict = field(default_factory=lambda: {
        k: {"count": 0, "bytes": 0} for k in analysis._COLLECTIVE_OPS})
    argument_bytes: int = 0
    output_bytes: int = 0
    comm_debug_counts: int = 0

    def collective_detail(self) -> dict:
        d = {k: dict(v) for k, v in self.collectives.items()}
        d["total_bytes"] = sum(v["bytes"] for v in self.collectives.values())
        d["total_count"] = sum(v["count"] for v in self.collectives.values())
        return d


class CountingFakeMode(FakeTensorMode):
    """A ``FakeTensorMode`` that counts every op it runs on a local
    shard. DTensor-level ops never reach it (:class:`CommCounter` sends
    them to DTensor with the mode unset, and DTensor runs its local ops
    through it), so each op is counted once, at the shapes rank 0 holds;
    ops the mode decomposes are counted once, at the outer op."""

    def __init__(self):
        super().__init__(allow_non_fake_inputs=True)
        self.costs = CellCosts()
        self._depth = 0

    def dispatch(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self._depth += 1
        try:
            out = super().dispatch(func, types, args, kwargs)
        finally:
            self._depth -= 1
        if out is NotImplemented or self._depth:
            return out
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        ns = func.namespace
        name = func.overloadpacket.__name__
        outs = [t for t in tree_leaves_any(out) if isinstance(t, torch.Tensor)]
        if ns == "_c10d_functional":
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                e = self.costs.collectives[kind]
                e["count"] += 1
                e["bytes"] += sum(_nbytes(t) for t in outs)
            return
        if func.is_view or ns == "prim":
            return
        packet = func.overloadpacket
        if packet in flop_registry:
            self.costs.flops += flop_registry[packet](*args, **kwargs,
                                                      out_val=out)
        ins = [t for t in tree_leaves_any((args, kwargs))
               if isinstance(t, torch.Tensor)]
        self.costs.bytes_accessed += sum(_nbytes(t) for t in ins + outs)


class CommCounter(CommDebugMode):
    """``CommDebugMode`` for a run on fake shards. It counts the
    collectives DTensor issues as the plain mode does, but lets each
    DTensor op dispatch with the fake mode unset: DTensor then plans with
    small real tensors of its own and keeps its caches (under a fake mode
    it assumes a trace and replans every op), and its shape propagation
    runs on a fake mode of its own, which the counting mode never sees."""

    def __init__(self):
        super().__init__()
        self._in_dtensor_op = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not any(issubclass(t, DTensor) for t in types):
            if func.namespace not in ("_c10d_functional", "c10d"):
                return func(*args, **(kwargs or {}))    # no bookkeeping
            return super().__torch_dispatch__(func, types, args, kwargs)
        if self._in_dtensor_op:
            return NotImplemented
        self._in_dtensor_op = True
        _push_mode(self)        # back on the stack to see the op's comms
        try:
            with unset_fake_temporarily():
                return func(*args, **(kwargs or {}))
        finally:
            _pop_mode()
            self._in_dtensor_op = False


def tree_leaves_any(tree) -> list:
    """Leaves of nested tuples, lists and dicts."""
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves_any(v)]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves_any(v)]
    return [tree]


def _local_bytes(tree) -> int:
    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in tree_leaves_any(tree) if isinstance(t, torch.Tensor))


# ---------------------------------------------------------------- cells

def lower_cell(cfg, shape, mesh, *, remat: str = "full", donate: bool = True):
    """Run one cell on ``mesh`` without allocating. Returns (outputs,
    costs, model_flops): the step's outputs (DTensors on the mesh, their
    shards fake tensors), rank 0's :class:`CellCosts`, MODEL_FLOPS.
    ``donate`` is JAX's signature: an eager step frees no input early, so
    it changes nothing here."""
    del donate
    if isinstance(cfg, str):
        cfg = get_config(cfg)
    if isinstance(shape, str):
        shape = get_shape(shape)
    ok, why = cell_is_applicable(cfg, shape)
    if not ok:
        raise SkipCell(why)
    model = build_model(cfg, "cpu")
    specs = model.input_specs(shape)
    batch_ps = sharding.batch_pspecs(cfg, shape, mesh)
    aparams = model.abstract_params(torch.bfloat16)
    params_ps = sharding.param_pspecs(cfg, mesh, aparams)
    model_flops = analysis.model_flops_for(cfg, shape)

    mode = CountingFakeMode()
    with mode, implicit_replication():
        params = sharding.place(aparams, params_ps, mesh)
        if shape.kind == "train":
            _, train_step = make_train_step(model, _opt_cfg(cfg),
                                            remat=remat)
            aopt = _abstract_opt(cfg, aparams)
            opt_ps = _opt_pspecs(cfg, mesh, aparams, aopt)
            args = (params, sharding.place(aopt, opt_ps, mesh),
                    sharding.place(specs, batch_ps, mesh))
            out_ps = (params_ps, opt_ps, None)
            step = train_step
        elif shape.kind == "prefill":
            # the int8-KV hint applies to decode caches only; prefill emits
            # the bf16 cache the (separate) decode engine re-quantizes
            with hints.hints(kv_cache_dtype="bfloat16"):
                acache = model.abstract_cache(shape)
            cache_ps = sharding.cache_pspecs(cfg, shape, mesh, acache)
            logits_ps = sharding.logits_pspec(
                cfg, mesh, decode=False, global_batch=shape.global_batch)
            args = (params, sharding.place(specs, batch_ps, mesh))
            out_ps = (logits_ps, cache_ps)
            step = make_prefill_step(model, max_seq=shape.seq_len)
        else:  # decode / long_decode
            acache = model.abstract_cache(shape)
            cache_ps = sharding.cache_pspecs(cfg, shape, mesh, acache)
            logits_ps = sharding.logits_pspec(
                cfg, mesh, decode=True, global_batch=shape.global_batch)
            batch = sharding.place(specs, batch_ps, mesh)
            args = (params, sharding.place(acache, cache_ps, mesh),
                    batch["tokens"], batch["lengths"])
            out_ps = (logits_ps, cache_ps)
            step = make_serve_step(model)
        argument_bytes = _local_bytes(args)
        mode.costs = CellCosts()
        with CommCounter() as comm:
            outputs = _out_shardings(step(*args), out_ps)
        costs = mode.costs
        costs.comm_debug_counts = comm.get_total_counts()
        costs.argument_bytes = argument_bytes
        costs.output_bytes = _local_bytes(outputs)
    return outputs, costs, model_flops


def _out_shardings(outputs, specs):
    """JAX's ``out_shardings``: each output leaf with a spec redistributed
    to it (a spec of None leaves its subtree as the step left it)."""
    if specs is None:
        return outputs
    if isinstance(outputs, (tuple, list)):
        return type(outputs)(_out_shardings(o, s)
                             for o, s in zip(outputs, specs))
    if isinstance(outputs, dict):
        return {k: _out_shardings(v, specs[k]) for k, v in outputs.items()}
    return sharding.constrain(outputs, specs)


def _abstract_opt(cfg: ModelConfig, params):
    """The optimizer state of ``params`` (meta tensors), as meta tensors."""
    from repro_torch.models.factory import _abstract
    from repro_torch.training.optimizer import adafactor_init, adamw_init
    init = adafactor_init if cfg.name in sharding.ADAFACTOR_ARCHS \
        else adamw_init
    return _abstract(lambda: init(tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype), params)))


def _opt_pspecs(cfg: ModelConfig, mesh, aparams, aopt):
    """Mirror param specs onto optimizer state with ZeRO-1 extra sharding."""
    P = sharding.P
    extra = sharding.optstate_extra_pspecs(cfg, mesh, aparams)

    def assign(subtree_name, subtree):
        if subtree_name in ("m", "v", "master"):
            return extra
        if subtree_name in ("v_row", "v_col"):
            # factored stats: drop the last (or keep compatible) dims
            axes = sharding.mesh_axes(mesh)

            def shrink(spec, pleaf, sleaf):
                entries = list(spec)[:len(sleaf.shape)]
                out = []
                for e, d in zip(entries, sleaf.shape):
                    size = 1
                    if e is not None:
                        names = e if isinstance(e, tuple) else (e,)
                        size = math.prod(axes[a] for a in names)
                    out.append(e if (e is not None and d % size == 0)
                               else None)
                return P(*out)
            return sharding._map(shrink, extra, aparams, subtree)
        return sharding._map(lambda _: P(), subtree)

    return {k: assign(k, v) for k, v in aopt.items()}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             remat: str = "full", full_artifact: bool = True) -> dict:
    """One production cell's roofline document (``RooflineResult``'s keys
    plus ``memory_analysis``, ``compile_s`` and ``cost_compile_s``). The
    default process group must be the fake one of 256 (512 with
    ``multi_pod``) ranks: :func:`main` makes it. ``full_artifact``: read
    the argument and output bytes (they come from the same run here)."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size()
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    model_flops = analysis.model_flops_for(cfg, shape)

    t0 = time.time()
    _, costs, _ = lower_cell(cfg, shape, mesh, remat=remat)
    mem_info: dict | str = {}
    if full_artifact:
        mem_info = {"argument_bytes": costs.argument_bytes,
                    "output_bytes": costs.output_bytes,
                    "temp_bytes": NO_BUFFER_PLAN,
                    "peak_bytes": NO_BUFFER_PLAN}
    full_compile_s = time.time() - t0

    chip = analysis.DEFAULT_CHIP
    flops, byts = costs.flops, costs.bytes_accessed
    detail = costs.collective_detail()
    coll_bytes = detail["total_bytes"]
    res = analysis.RooflineResult(
        arch=arch, shape=shape_name, mesh=mesh_name(mesh), chips=chips,
        hlo_flops=flops * chips, hlo_bytes=byts * chips,
        collective_bytes=coll_bytes * chips, model_flops=model_flops,
        compute_s=flops / chip.peak_flops_bf16,
        memory_s=byts / chip.hbm_bandwidth,
        collective_s=coll_bytes / chip.ici_link_bandwidth,
        collective_detail=detail,
        notes=(f"remat={remat} eager run of every layer on rank 0 of a "
               f"fake process group (no depth extrapolation); not XLA's "
               f"counts: hlo_flops by torch's flop_registry formulas, "
               f"hlo_bytes the unfused eager ops' inputs and outputs, "
               f"collectives as torch {torch.__version__}'s DTensor "
               f"issues them; seconds are the simulated {chip.name}'s"))
    d = res.to_dict()
    d["memory_analysis"] = mem_info
    d["compile_s"] = full_compile_s
    d["cost_compile_s"] = 0.0
    return d


def init_fake_group(world_size: int) -> None:
    """The fake process group of ``world_size`` ranks (this process is
    rank 0), replacing any earlier default group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if (dist.get_backend() == "fake"
                and dist.get_world_size() == world_size):
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--out", default=None)
    ap.add_argument("--hint", action="append", default=[],
                    help="hillclimb knob, e.g. --hint moe_impl=shardmap")
    ap.add_argument("--autotune", action="store_true",
                    help="apply the per-(arch×kind) best-known hints "
                         "(distributed/autotune.py) instead of global flags")
    args = ap.parse_args(argv)

    hint_tag = ""
    for h in args.hint:
        k, _, v = h.partition("=")
        hints.set_hint(k, v)
        hint_tag += f";{k}={v}"

    cells: list[tuple[str, str, bool]] = []
    if args.all:
        for arch in CONFIGS:
            for shape in SHAPES:
                for mp in ((False, True) if args.both_meshes else (args.multi_pod,)):
                    cells.append((arch, shape, mp))
    else:
        assert args.arch and args.shape, "--arch/--shape or --all required"
        for mp in ((False, True) if args.both_meshes else (args.multi_pod,)):
            cells.append((args.arch, args.shape, mp))

    # resume: skip cells already recorded in the JSONL output
    done: set[tuple[str, str, str]] = set()
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    d = json.loads(line)
                    done.add((d["arch"], d["shape"], d["mesh"]))
                except Exception:
                    pass

    failures, n = [], 0
    outf = open(args.out, "a") if args.out else None
    for arch, shape, mp in cells:
        mesh_key = ("2x16x16(pod,data,model)" if mp else "16x16(data,model)")
        if (arch, shape, mesh_key) in done:
            continue
        tag = f"{arch} x {shape} x {'multi-pod' if mp else 'single-pod'}"
        init_fake_group(512 if mp else 256)
        try:
            if args.autotune:
                from repro_torch.distributed import autotune
                at_hints, at_remat = autotune.best_hints(
                    get_config(arch), get_shape(shape).kind)
                with hints.hints(**at_hints):
                    d = run_cell(arch, shape, multi_pod=mp, remat=at_remat)
                d["hints"] = "autotune:" + ";".join(
                    f"{k}={v}" for k, v in at_hints.items()) + f";remat={at_remat}"
            else:
                d = run_cell(arch, shape, multi_pod=mp, remat=args.remat)
                if hint_tag:
                    d["hints"] = hint_tag.strip(";")
            d["status"] = "ok"
            print(f"[dryrun] OK   {tag}: dominant={d['dominant']} "
                  f"step={d['step_time_s']:.4f}s "
                  f"MFU={d['roofline_fraction']:.3f} "
                  f"compile={d['compile_s']:.0f}+{d['cost_compile_s']:.0f}s",
                  flush=True)
        except SkipCell as e:
            d = {"arch": arch, "shape": shape, "mesh": mesh_key,
                 "status": "skipped", "reason": str(e)}
            print(f"[dryrun] SKIP {tag}: {e}", flush=True)
        except Exception as e:
            failures.append(tag)
            d = {"arch": arch, "shape": shape, "mesh": mesh_key,
                 "status": "error", "error": repr(e)}
            print(f"[dryrun] FAIL {tag}: {e}", flush=True)
            traceback.print_exc()
        n += 1
        if outf:
            outf.write(json.dumps(d) + "\n")
            outf.flush()
    if outf:
        outf.close()
    if dist.is_initialized():
        dist.destroy_process_group()
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES: {failures}", flush=True)
        sys.exit(1)
    print(f"[dryrun] all {n} cells done", flush=True)


if __name__ == "__main__":
    main()
