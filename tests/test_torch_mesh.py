"""Sharded steps on a real mesh: the port on a 2 x 2 ``("data", "model")``
gloo mesh, four processes on the CPU, against the unsharded port and the
JAX package's unsharded run on the same weights.

For reduced tinyllama-1.1b and reduced moonshot-v1-16b-a3b (two layers;
weights from one JAX ``init``, placed by ``sharding.param_pspecs``):

* a train step (AdamW, ZeRO-1 state by ``_opt_pspecs``, the batch by
  ``batch_pspecs``): loss, gradients and updated parameters;
* whole-prompt prefill, then a decode step on its cache (placed by
  ``cache_pspecs``): logits;
* the forward logits under ``attn_kv_replicated`` and under
  ``residual_replicated`` against no hint on the same mesh;
* moonshot's ``moe_ffn_shardmap`` against the scatter ``moe_ffn`` with a
  capacity no token overflows, and against a per-shard emulation (the
  scatter ``moe_ffn`` on each data shard's tokens at the per-shard
  capacity) where tokens are dropped.

Float32 throughout. Tolerance 1e-5 (absolute + relative): the sharded
sums (row-parallel products reduced over ``model``, gradients over
``data``) add the same terms in another order.
"""
import dataclasses
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import CONFIGS  # noqa: E402
from repro.models.factory import build_model as jbuild  # noqa: E402
from repro.training.checkpoint import _flatten  # noqa: E402
from repro.training.optimizer import OptimizerConfig as JOpt  # noqa: E402
from repro.training.train_step import \
    make_train_step as jmake_train_step  # noqa: E402
from repro_torch.configs.registry import CONFIGS as TCONFIGS  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.factory import build_model as tbuild  # noqa: E402
from repro_torch.training.optimizer import (OptimizerConfig,  # noqa: E402
                                            adamw_init)
from repro_torch.training.train_step import (loss_and_grads,  # noqa: E402
                                             make_train_step)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ["tinyllama-1.1b", "moonshot-v1-16b-a3b"]
B, S, PROMPT = 4, 16, 12
TOL = 1e-5
OPT = dict(lr=1e-3, warmup_steps=10)

torch.set_num_threads(2)

#: a capacity factor at which the reduced moonshot drops tokens, both per
#: shard and globally (4 experts, top 2, 32 tokens a data shard)
DROP_FACTOR = 0.5

WORKER = """
import dataclasses, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, port, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=4, rank=rank)
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import CONFIGS
from repro_torch.distributed import hints, sharding
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe
from repro_torch.models.convert import tree_from_flat
from repro_torch.models.factory import build_model
from repro_torch.training.optimizer import OptimizerConfig, adamw_init
from repro_torch.training.train_step import (loss_and_grads,
                                             make_train_step)

mesh = make_mesh((2, 2), ("data", "model"))
DROP_FACTOR = %(drop)r
out = {}
full = lambda t: t.full_tensor().detach().numpy()

def reduced(name):
    return dataclasses.replace(CONFIGS[name].reduced(), num_layers=2)

# plain tensors the steps make (RoPE tables, masks, step scalars) join
# the DTensor ops as replicated
with implicit_replication():
    for arch in %(archs)r:
        data = np.load(f"{out_dir}/{arch}.npz")
        cfg = reduced(arch)
        model = build_model(cfg, "cpu")
        params = tree_from_flat({k[2:]: data[k] for k in data.files
                                 if k.startswith("p/")}, "cpu")
        tokens = torch.as_tensor(data["tokens"])
        P = sharding.place(params, sharding.param_pspecs(cfg, mesh, params),
                           mesh)
        shape = ShapeConfig("t", %(S)d, %(B)d, "train")
        batch = sharding.place({"tokens": tokens},
                               sharding.batch_pspecs(cfg, shape, mesh), mesh)
        # ---- train step
        loss, grads = loss_and_grads(model, P, batch, remat="none")
        opt = adamw_init(params)
        O = sharding.place(opt, dryrun._opt_pspecs(cfg, mesh, params, opt),
                           mesh)
        _, step = make_train_step(model, OptimizerConfig(**%(opt)r),
                                  remat="none")
        new_p, _, metrics = step(P, O, batch)
        out[f"{arch}/loss"] = full(metrics["loss"])
        for k, v in sharding._walk(grads):
            out[f"{arch}/g/{k}"] = full(v)
        for k, v in sharding._walk(new_p):
            out[f"{arch}/p/{k}"] = full(v)
        # ---- whole-prompt prefill, then a decode step on its cache
        prompt = sharding.place({"tokens": tokens[:, :%(prompt)d]},
                                sharding.batch_pspecs(cfg, shape, mesh), mesh)
        with torch.no_grad():
            _, cache = model.prefill(P, prompt, %(S)d)
            dshape = ShapeConfig("d", %(S)d, %(B)d, "decode")
            cache = sharding._map(sharding.constrain, cache,
                                  sharding.cache_pspecs(cfg, dshape, mesh,
                                                        cache))
            nxt = sharding.place({"t": tokens[:, %(prompt)d:%(prompt)d + 1]},
                                 {"t": sharding.P("data", None)}, mesh)["t"]
            lengths = sharding.place(
                {"l": torch.full((%(B)d,), %(prompt)d, dtype=torch.int32)},
                {"l": sharding.P("data")}, mesh)["l"]
            logits, _ = model.decode_step(P, cache, nxt, lengths)
            out[f"{arch}/decode"] = full(logits)
            # ---- the mesh hints: forward logits against no hint
            for hint in ("none", "attn_kv_replicated", "residual_replicated"):
                kw = {} if hint == "none" else {hint: True}
                with hints.hints(**kw):
                    lg, _ = model.forward(P, batch, remat="none")
                out[f"{arch}/hint/{hint}"] = full(lg)
        # ---- moe_ffn_shardmap
        if cfg.is_moe:
            ffn = {k: v[0] for k, v in P["layers"]["ffn"].items()
                   if not isinstance(v, dict)}
            if "shared" in P["layers"]["ffn"]:
                ffn["shared"] = {k: v[0] for k, v in
                                 P["layers"]["ffn"]["shared"].items()}
            x = sharding.place({"x": torch.as_tensor(data["x"])},
                               {"x": sharding.P("data", None, None)},
                               mesh)["x"]
            with torch.no_grad():
                for tag, cf in (("nodrop", 64.0), ("drop", DROP_FACTOR)):
                    c = dataclasses.replace(cfg, capacity_factor=cf)
                    y, aux = moe.moe_ffn_shardmap(ffn, x, c)
                    out[f"{arch}/moe/{tag}/y"] = full(y)
                    out[f"{arch}/moe/{tag}/aux"] = full(aux)
if rank == 0:
    np.savez(f"{out_dir}/mesh.npz", **out)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _reduced(name, cfgs):
    return dataclasses.replace(cfgs[name].reduced(), num_layers=2)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Weights, tokens and activations for both archs; the workers' results
    on the 2 x 2 mesh; the unsharded port's and JAX's."""
    d = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(0)
    ref = {}
    for arch in ARCHS:
        jcfg, tcfg = _reduced(arch, CONFIGS), _reduced(arch, TCONFIGS)
        jm, tm = jbuild(jcfg), tbuild(tcfg, "cpu")
        jparams = jm.init(jax.random.key(0))
        flat = _flatten(jparams)
        tokens = rng.integers(0, tcfg.vocab_size, (B, S), dtype=np.int32)
        x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
        np.savez(d / f"{arch}.npz", tokens=tokens, x=x,
                 **{f"p/{k}": v for k, v in flat.items()})
        ref[arch] = (jm, tm, jcfg, tcfg, jparams,
                     params_from_jax(flat, "cpu"), tokens, x)
    port = _free_port()
    code = textwrap.dedent(WORKER % dict(archs=ARCHS, S=S, B=B, opt=OPT,
                                         prompt=PROMPT, drop=DROP_FACTOR))
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r),
                               str(port), str(d)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-6000:]
    got = dict(np.load(d / "mesh.npz"))
    return ref, got


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL, err_msg=what)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_unsharded_port_and_jax(run, arch):
    ref, got = run
    jm, tm, jcfg, tcfg, jparams, tparams, tokens, _ = ref[arch]
    batch = {"tokens": tokens}
    loss, grads = loss_and_grads(tm, tparams, batch, remat="none")
    _, step = make_train_step(tm, OptimizerConfig(**OPT), remat="none")
    new_p, _, metrics = step(tparams, adamw_init(tparams), batch)
    _, jstep = jmake_train_step(jm, JOpt(**OPT), remat="none")
    from repro.training.optimizer import adamw_init as jadamw_init
    jp, _, jmetrics = jax.jit(jstep)(jparams, jadamw_init(jparams),
                                     {"tokens": jnp.asarray(tokens)})
    _close(got[f"{arch}/loss"], float(metrics["loss"]), "loss vs port")
    _close(got[f"{arch}/loss"], float(jmetrics["loss"]), "loss vs JAX")
    jflat = {k: np.asarray(v, np.float32) for k, v in _flatten(jp).items()}
    for k, v in _flat(grads).items():
        _close(got[f"{arch}/g/{k}"], v.numpy(), f"gradient {k}")
    for k, v in _flat(new_p).items():
        _close(got[f"{arch}/p/{k}"], v.numpy(), f"updated {k} vs port")
        _close(got[f"{arch}/p/{k}"], jflat[k], f"updated {k} vs JAX")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_unsharded_port_and_jax(run, arch):
    ref, got = run
    jm, tm, jcfg, tcfg, jparams, tparams, tokens, _ = ref[arch]
    prompt, nxt = tokens[:, :PROMPT], tokens[:, PROMPT:PROMPT + 1]
    lengths = np.full((B,), PROMPT, np.int32)
    with torch.no_grad():
        _, cache = tm.prefill(tparams, {"tokens": torch.as_tensor(prompt)},
                              S)
        want, _ = tm.decode_step(tparams, cache, torch.as_tensor(nxt),
                                 torch.as_tensor(lengths))
    _, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(prompt)}, S)
    jwant, _ = jm.decode_step(jparams, jcache, jnp.asarray(nxt),
                              jnp.asarray(lengths))
    _close(got[f"{arch}/decode"], want.numpy(), "decode logits vs port")
    _close(got[f"{arch}/decode"], np.asarray(jwant), "decode logits vs JAX")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("hint", ["attn_kv_replicated",
                                  "residual_replicated"])
def test_mesh_hints_leave_the_logits_as_no_hint(run, arch, hint):
    """Both constraints move data, not values: the forward logits on the
    mesh equal no hint's on the same mesh, and the unsharded port's."""
    ref, got = run
    _, tm, _, _, _, tparams, tokens, _ = ref[arch]
    with torch.no_grad():
        want, _ = tm.forward(tparams, {"tokens": torch.as_tensor(tokens)},
                             remat="none")
    _close(got[f"{arch}/hint/{hint}"], got[f"{arch}/hint/none"],
           f"{hint} vs no hint")
    _close(got[f"{arch}/hint/{hint}"], want.numpy(), f"{hint} vs unsharded")


def _ffn0(tparams):
    ffn = tparams["layers"]["ffn"]
    out = {k: v[0] for k, v in ffn.items() if not isinstance(v, dict)}
    if "shared" in ffn:
        out["shared"] = {k: v[0] for k, v in ffn["shared"].items()}
    return out


def test_moe_shardmap_matches_scatter_without_drops(run):
    """With a capacity no token overflows, expert parallelism computes the
    global scatter ``moe_ffn``'s outputs; the aux is each data shard's
    averaged over ``data`` (JAX's pmean), so it is held against that."""
    ref, got = run
    _, _, _, tcfg, _, tparams, _, x = ref["moonshot-v1-16b-a3b"]
    cfg = dataclasses.replace(tcfg, capacity_factor=64.0)
    ffn, xt = _ffn0(tparams), torch.as_tensor(x)
    with torch.no_grad():
        y, _ = tmoe.moe_ffn(ffn, xt, cfg)
        aux = np.mean([float(tmoe.moe_ffn(ffn, xd, cfg)[1])
                       for xd in xt.chunk(2)])
    _close(got["moonshot-v1-16b-a3b/moe/nodrop/y"], y.numpy(), "y")
    _close(got["moonshot-v1-16b-a3b/moe/nodrop/aux"], aux, "aux")


def test_moe_shardmap_matches_a_per_shard_emulation_with_drops(
        run, monkeypatch):
    """At capacity factor ``DROP_FACTOR`` tokens overflow; each (data, model)
    shard keeps the tokens of its data shard routed to its experts up to
    the per-shard capacity, JAX's ``capacity(T_l * mp) // mp`` rounded up
    to 8. The scatter ``moe_ffn`` on each data shard's tokens at that
    capacity gives the same outputs; the global ``moe_ffn`` does not."""
    ref, got = run
    _, _, _, cfg, _, tparams, _, x = ref["moonshot-v1-16b-a3b"]
    cfg = dataclasses.replace(cfg, capacity_factor=DROP_FACTOR)
    ffn, xt = _ffn0(tparams), torch.as_tensor(x)
    t_l, mp = (B // 2) * S, 2
    c_l = max(8, ((tmoe.capacity(cfg, t_l * mp) // mp + 7) // 8) * 8)
    with torch.no_grad():
        glob, _ = tmoe.moe_ffn(ffn, xt, cfg)
        monkeypatch.setattr(tmoe, "capacity", lambda c, n: c_l)
        parts = [tmoe.moe_ffn(ffn, xd, cfg) for xd in xt.chunk(2)]
    y = torch.cat([p[0] for p in parts]).numpy()
    aux = np.mean([float(p[1]) for p in parts])
    sharded = got["moonshot-v1-16b-a3b/moe/drop/y"]
    assert not np.allclose(sharded, glob.numpy(), atol=TOL), \
        "no token was dropped: the case shows nothing"
    _close(sharded, y, "y")
    _close(got["moonshot-v1-16b-a3b/moe/drop/aux"], aux, "aux")


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built with nvcc and "
                    "run only there")
    return torch.device("cuda")


GPU_UNWRAP = """
import sys
import torch
import torch.distributed as dist
dist.init_process_group("nccl", init_method=f"tcp://localhost:{sys.argv[1]}",
                        world_size=1, rank=0)
from torch.distributed.tensor import DTensor, Shard, distribute_tensor
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_decode_attention import paged_decode_attention
from repro_torch.kernels.prefill_attention import prefill_attention
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.ssd_scan import ssd_chunk_scan
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention

def plain(*a, **k):
    raise AssertionError("the plain version was called")

for name in ("naive_attention", "flash_attention_jnp", "decode_attention"):
    setattr(attention, name, plain)
dev = resolve_device("cuda")
mesh = make_mesh((1, 1), ("data", "model"))
assert mesh.device_type == "cuda"
g = torch.Generator(device=dev).manual_seed(0)
q = torch.randn((2, 256, 8, 64), generator=g, device=dev)
k = torch.randn((2, 256, 4, 64), generator=g, device=dev)
v = torch.randn((2, 256, 4, 64), generator=g, device=dev)
want = ops.attention_prefill(q, k, v)
place = lambda t: distribute_tensor(t, mesh, [Shard(0), Shard(2)])
n = flash_attention.launches
got = ops.attention_prefill(place(q), place(k), place(v))
assert isinstance(got, DTensor) and tuple(got.placements) == (Shard(0),
                                                               Shard(2))
assert flash_attention.launches == n + 1, flash_attention.launches - n
assert torch.equal(got.to_local(), want)
cache = torch.randn((2, 300, 4, 64), generator=g, device=dev)
lengths = torch.tensor([17, 300], dtype=torch.int32, device=dev)
want = ops.attention_decode(q[:, :1], cache, cache, lengths, 10000.0)
n = decode_attention.launches
got = ops.attention_decode(place(q[:, :1]), place(cache), place(cache),
                           distribute_tensor(lengths, mesh, [Shard(0)] * 2),
                           10000.0)
assert decode_attention.launches == n + 1
assert torch.equal(got.to_local(), want)
# the paged decode through the block table, the chunked prefill on the
# contiguous cache, RMSNorm and the SSD chunk
pool = torch.randn((9, 16, 4, 64), generator=g, device=dev)
table = torch.tensor([[0, 3, 5], [7, 1, 2]], dtype=torch.int32, device=dev)
plens = torch.tensor([5, 40], dtype=torch.int32, device=dev)
rep = lambda t: distribute_tensor(t, mesh, [Shard(0), Shard(0)])
checks = [
    (paged_decode_attention, lambda f: ops.attention_decode_paged(
        f(q[:, :1]), f(pool, 2), f(pool, 2), f(table), f(plens), 10000.0)),
    (prefill_attention, lambda f: ops.attention_prefill_chunk(
        f(q[:, :16]), f(cache), f(cache), f(lengths - 16), 10000.0)),
    (rmsnorm, lambda f: ops.fused_rmsnorm(f(q.reshape(2, 256, 512)),
                                          torch.ones(512, device=dev))),
]
for kernel, call in checks:
    want = call(lambda t, d=0: t)
    n = kernel.launches
    got = call(lambda t, d=0: distribute_tensor(
        t, mesh, [Shard(0) if d == 0 else Shard(d), Shard(d)]))
    assert kernel.launches == n + 1, kernel
    assert torch.equal(got.to_local(), want), kernel
x = torch.randn((4, 16, 2, 16), generator=g, device=dev)
dt = torch.rand((4, 16, 2), generator=g, device=dev)
cum = torch.cumsum(-dt, dim=1)
bc = torch.randn((4, 16, 16), generator=g, device=dev)
want = ops.ssd_intra_chunk(x, dt, cum, bc, bc)
n = ssd_chunk_scan.launches
with torch.no_grad():
    got = ops.ssd_intra_chunk(*(rep(t) for t in (x, dt, cum, bc, bc)))
assert ssd_chunk_scan.launches == n + 1
assert all(torch.equal(a.to_local(), b) for a, b in zip(got, want))
dist.destroy_process_group()
print("GPU-UNWRAP-OK")
"""


@pytest.mark.gpu
def test_kernel_wrappers_unwrap_dtensors_on_the_card(cuda_device):
    """On a 1 x 1 CUDA mesh (NCCL, one rank), the entries of
    ``kernels/ops.py`` given DTensors — full-sequence, decode, paged
    decode and chunked-prefill attention, RMSNorm, the SSD chunk — launch
    their kernel once each on the shards (the plain attention versions
    are made to raise) and return DTensors bitwise equal to the same call
    on plain tensors."""
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(GPU_UNWRAP),
                          str(_free_port())], capture_output=True,
                         text=True, timeout=600, env=env)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "GPU-UNWRAP-OK" in res.stdout
