"""The mesh and the sharding rules on the port against the JAX package.

For every config in the registry, full and reduced, on the ``(4, 4)``
mesh of ``tests/test_distributed.py`` and the production ``(16, 16)`` and
``(2, 16, 16)`` meshes, the port's specs equal JAX's ``PartitionSpec``s
leaf by leaf: the parameters, the ZeRO-1 optimizer state (AdamW's, or
Adafactor's for ``sharding.ADAFACTOR_ARCHS``), the batch of every shape,
the caches of the decode shapes under both KV dtypes and the logits; the
DTensor shard of every leaf has ``NamedSharding(mesh, spec)``'s shape, and
for every distinct (shape, spec) the shards of all ranks start at
``devices_indices_map``'s offsets. The abstract model (``abstract_params``,
``input_specs``, ``abstract_cache``) has ``eval_shape``'s leaves: paths,
shapes and dtypes.

Each side runs in a subprocess of its own: JAX on 512 forced host devices
(as ``repro.launch.dryrun`` sets them), the port on a 512-rank fake process
group. Both write one JSON document; the test compares them.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

MESHES = [((4, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]

_COMMON = """
import hashlib, json, sys
MESHES = %r
DECODE = ("decode_32k", "long_500k")

def entries(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]

def digest(offsets):
    return hashlib.sha1(json.dumps(offsets).encode()).hexdigest()
""" % (MESHES,)

JAX_SIDE = _COMMON + """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec
from repro.configs.registry import CONFIGS
from repro.configs.shapes import SHAPES
from repro.distributed import hints, sharding
from repro.launch import dryrun
from repro.models.factory import build_model

out, offsets = {}, {}

def path_of(entries_):
    return "/".join(str(getattr(p, "key", p)) for p in entries_)

def flat(tree):
    return {path_of(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]}

def record(tag, mesh, specs, leaves):
    specs, leaves = flat(specs), flat(leaves)
    assert specs.keys() == leaves.keys(), tag
    for path, spec in specs.items():
        leaf = leaves[path]
        ns = NamedSharding(mesh, spec)
        shape = tuple(leaf.shape)
        out[f"{tag}|{path}"] = [entries(spec), list(shape), str(leaf.dtype),
                                list(ns.shard_shape(shape))]
        key = json.dumps([list(mesh.devices.shape), shape, entries(spec)])
        if key not in offsets:
            idx = ns.devices_indices_map(shape)
            offs = [[s.start or 0 for s in idx[d]]
                    for d in mesh.devices.flat]
            offsets[key] = digest(offs)

for shape_, axes in MESHES:
    n = int(np.prod(shape_))
    mesh = jax.make_mesh(shape_, axes, devices=jax.devices()[:n])
    mname = "x".join(map(str, shape_))
    for name, full in CONFIGS.items():
        for cfg in (full, full.reduced()):
            m = build_model(cfg)
            tag = f"{mname}|{cfg.name}"
            ap = m.abstract_params(jnp.bfloat16)
            record(tag + "|params", mesh,
                   sharding.param_pspecs(cfg, mesh, ap), ap)
            aopt = jax.eval_shape(lambda p: dryrun._abstract_opt(cfg, p), ap)
            record(tag + "|opt", mesh,
                   dryrun._opt_pspecs(cfg, mesh, ap, aopt), aopt)
            for sname, shape in SHAPES.items():
                record(f"{tag}|batch|{sname}", mesh,
                       sharding.batch_pspecs(cfg, shape, mesh),
                       m.input_specs(shape))
                out[f"{tag}|logits|{sname}"] = entries(sharding.logits_pspec(
                    cfg, mesh, decode=shape.is_decode,
                    global_batch=shape.global_batch))
                if sname not in DECODE:
                    continue
                for kv in ("bfloat16", "int8"):
                    with hints.hints(kv_cache_dtype=kv):
                        ac = m.abstract_cache(shape)
                    record(f"{tag}|cache|{sname}|{kv}", mesh,
                           sharding.cache_pspecs(cfg, shape, mesh, ac), ac)
json.dump({"leaves": out, "offsets": offsets}, open(sys.argv[1], "w"))
"""

PORT_SIDE = _COMMON + """
import math
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.tensor._utils import \\
    _compute_local_shape_and_global_offset
from repro_torch.configs.registry import CONFIGS
from repro_torch.configs.shapes import SHAPES
from repro_torch.distributed import hints, sharding
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.factory import build_model

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
out, offsets = {}, {}
DTYPES = {torch.bfloat16: "bfloat16", torch.float32: "float32",
          torch.int32: "int32", torch.int8: "int8"}

def record(tag, mesh, specs, leaves):
    specs, leaves = dict(sharding._walk(specs)), dict(sharding._walk(leaves))
    assert specs.keys() == leaves.keys(), tag
    for path, spec in specs.items():
        leaf = leaves[path]
        shape = tuple(leaf.shape)
        placed = sharding.place_leaf(leaf, spec, mesh)
        out[f"{tag}|{path}"] = [entries(spec), list(shape), DTYPES[leaf.dtype],
                                list(placed.to_local().shape)]
        key = json.dumps([list(mesh.shape), shape, entries(spec)])
        if key not in offsets:
            pl = sharding.placements(spec, mesh)
            coords = [[(i // math.prod(mesh.shape[j + 1:])) % mesh.shape[j]
                       for j in range(mesh.ndim)]
                      for i in range(mesh.size())]
            offs = [list(_compute_local_shape_and_global_offset(
                shape, mesh.shape, c, pl)[1]) for c in coords]
            offsets[key] = digest(offs)

for shape_, axes in MESHES:
    mesh = make_mesh(shape_, axes)
    mname = "x".join(map(str, shape_))
    for name, full in CONFIGS.items():
        for cfg in (full, full.reduced()):
            m = build_model(cfg, "cpu")
            tag = f"{mname}|{cfg.name}"
            ap = m.abstract_params(torch.bfloat16)
            record(tag + "|params", mesh,
                   sharding.param_pspecs(cfg, mesh, ap), ap)
            aopt = dryrun._abstract_opt(cfg, ap)
            record(tag + "|opt", mesh,
                   dryrun._opt_pspecs(cfg, mesh, ap, aopt), aopt)
            for sname, shape in SHAPES.items():
                record(f"{tag}|batch|{sname}", mesh,
                       sharding.batch_pspecs(cfg, shape, mesh),
                       m.input_specs(shape))
                out[f"{tag}|logits|{sname}"] = entries(
                    sharding.logits_pspec(
                        cfg, mesh, decode=shape.is_decode,
                        global_batch=shape.global_batch))
                if sname not in DECODE:
                    continue
                for kv in ("bfloat16", "int8"):
                    with hints.hints(kv_cache_dtype=kv):
                        ac = m.abstract_cache(shape)
                    record(f"{tag}|cache|{sname}|{kv}", mesh,
                           sharding.cache_pspecs(cfg, shape, mesh, ac),
                           ac)
json.dump({"leaves": out, "offsets": offsets}, open(sys.argv[1], "w"))
"""


def _start(code: str, path) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code),
                             str(path)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)


@pytest.fixture(scope="module")
def documents(tmp_path_factory):
    """JAX's document and the port's, made side by side."""
    d = tmp_path_factory.mktemp("specs")
    paths = (d / "jax.json", d / "port.json")
    procs = [_start(code, path) for code, path in zip((JAX_SIDE, PORT_SIDE),
                                                      paths)]
    for p in procs:
        out = p.communicate(timeout=240)[0]
        assert p.returncode == 0, out[-6000:]
    return tuple(json.loads(path.read_text()) for path in paths)


def _part(doc: dict, part: str) -> dict:
    return {k: v for k, v in doc["leaves"].items() if k.split("|")[2] == part}


@pytest.mark.parametrize("part", ["params", "opt", "batch", "cache",
                                  "logits"])
def test_specs_and_shard_shapes_match_jax(documents, part):
    """Spec, global shape, dtype and this rank's shard shape of every leaf
    of ``part`` equal JAX's, for every config and mesh."""
    jx, pt = (_part(doc, part) for doc in documents)
    assert jx, part
    missing = sorted(jx.keys() - pt.keys())[:10]
    extra = sorted(pt.keys() - jx.keys())[:10]
    assert not missing and not extra, (missing, extra)
    bad = [(k, jx[k], pt[k]) for k in jx if jx[k] != pt[k]]
    assert not bad, bad[:10]


def test_every_rank_shard_starts_where_jax_puts_it(documents):
    """For every distinct (mesh, shape, spec), the offsets of all ranks'
    shards (a digest of the lists, in rank order) equal
    ``devices_indices_map``'s — the tuple entries ``("pod", "data")`` and
    ``("data", "model")`` included."""
    jx, pt = (doc["offsets"] for doc in documents)
    assert jx.keys() == pt.keys()
    assert any('["pod", "data"]' in k for k in jx)
    assert any('["data", "model"]' in k for k in jx)
    bad = [k for k in jx if jx[k] != pt[k]]
    assert not bad, bad[:10]


def test_abstract_model_matches_eval_shape(documents):
    """Paths, shapes and dtypes of ``abstract_params``, the optimizer
    state, ``input_specs`` and ``abstract_cache`` (bf16 and int8) equal
    JAX's ``eval_shape`` leaves for every config, full and reduced."""
    jx, pt = documents
    keys = [k for k in jx["leaves"] if k.startswith("4x4|")
            and k.split("|")[2] != "logits"]
    assert len({k.split("|")[1] for k in keys}) == 20
    bad = [k for k in keys if jx["leaves"][k][1:3] != pt["leaves"][k][1:3]]
    assert not bad, bad[:10]


def test_mesh_builders(tmp_path):
    """``make_production_mesh`` and ``make_mesh`` build the JAX shapes and
    axis names, ``mesh_name`` names them as JAX does, a mesh smaller than
    the group takes its first ranks, and no mesh is built without a
    process group."""
    code = """
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch import mesh as M
    try:
        M.make_production_mesh()
        raise SystemExit("built a mesh without a process group")
    except RuntimeError:
        pass
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    one = M.make_production_mesh()
    two = M.make_production_mesh(multi_pod=True)
    print(M.mesh_name(one), M.mesh_name(two), one.device_type)
    small = M.make_mesh((3, 4), ("data", "model"))
    print(M.mesh_name(small), small.mesh.flatten().tolist()[-1])
    print(M.mesh_name(M.make_local_mesh()))
    """
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.split("\n")
    assert lines[0] == ("16x16(data,model) 2x16x16(pod,data,model) cpu")
    assert lines[1] == "3x4(data,model) 11"
    assert lines[2] == "512x1(data,model)"
