"""The GPipe schedule on a stage mesh: the port's ``pipelined_forward`` on
four gloo processes on the CPU, against the sequential stack and against
the JAX package's ``pipelined_forward`` on four forced host devices, run
on the same weights and inputs (numpy, from a seed).

* ``tanh(h @ w)`` layers at ``test_pipeline_parallel_matches_sequential``'s
  shapes (4 stages, L 8, D 16, B 8, 4 microbatches);
* fewer microbatches than stages (S 4, M 2): the emission index and the
  bubble;
* a ``(2, 2)`` ``("stage", "data")`` mesh: two stages, each found by its
  stage coordinate (rank // 2), not by its global rank modulo S;
* reduced tinyllama-1.1b cut to 4 layers, one a stage, with the dense
  block (RMSNorm, attention, residual, MLP, residual) as ``layer_fn`` in
  both packages;
* ``y`` bitwise equal on every rank; a mesh without a ``stage`` axis
  and a batch the microbatches do not divide raise; ``bubble_fraction``
  equals JAX's.

Float32 throughout. Tolerance 1e-5 (absolute + relative), the bound of
tests/test_distributed.py.
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

from repro.configs.registry import CONFIGS  # noqa: E402
from repro.distributed.pipeline import \
    bubble_fraction as jbubble  # noqa: E402
from repro.models.factory import build_model as jbuild  # noqa: E402
from repro.training.checkpoint import _flatten  # noqa: E402
from repro_torch.configs.registry import CONFIGS as TCONFIGS  # noqa: E402
from repro_torch.distributed.pipeline import bubble_fraction  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TOL = 1e-5
L, D, B = 8, 16, 8
#: (name, mesh shape, mesh axes, microbatches) of the tanh stacks
CASES = [("s4m4", (4,), ("stage",), 4),
         ("s4m2", (4,), ("stage",), 2),
         ("s2dp2", (2, 2), ("stage", "data"), 4)]
#: reduced tinyllama cut to 4 layers: the batch, its sequence and the
#: microbatches of the 4-stage run
TL_LAYERS, TL_B, TL_S, TL_M = 4, 4, 16, 4

torch.set_num_threads(2)

#: the dense block of both packages' ``forward``, as a layer_fn
BLOCK = """
def block(lp, h):
    x = layers.rmsnorm(h, lp["ln1"], cfg.norm_eps)
    out, _ = tf.attention_block(lp["attn"], x, cfg, positions, True)
    h = h + out
    x = layers.rmsnorm(h, lp["ln2"], cfg.norm_eps)
    return h + tf._ffn(lp["ffn"], x, cfg)[0]
"""

WORKER = """
import dataclasses, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, port, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=4, rank=rank)
from repro_torch.configs.registry import CONFIGS
from repro_torch.distributed.pipeline import pipelined_forward
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers
from repro_torch.models import transformer as tf
from repro_torch.models.convert import tree_from_flat

data = np.load(f"{out_dir}/inputs.npz")
out = {}
tanh = lambda lp, h: torch.tanh(h @ lp["w"])
w, x = torch.as_tensor(data["w"]), torch.as_tensor(data["x"])
for name, shape, axes, m in %(cases)r:
    mesh = make_mesh(shape, axes)
    out[name] = pipelined_forward(tanh, {"w": w}, x, mesh,
                                  num_microbatches=m).numpy()
cfg = dataclasses.replace(CONFIGS["tinyllama-1.1b"].reduced(),
                          num_layers=%(tl_layers)d)
params = tree_from_flat({k[2:]: data[k] for k in data.files
                         if k.startswith("p/")}, "cpu")
positions = torch.arange(%(tl_s)d)[None, :]
%(block)s
out["tinyllama"] = pipelined_forward(
    block, params["layers"], torch.as_tensor(data["h"]),
    make_mesh((4,), ("stage",)), num_microbatches=%(tl_m)d).numpy()
for name, mesh, m in (("no_stage_axis", make_mesh((4,), ("data",)), 4),
                      ("indivisible", make_mesh((4,), ("stage",)), 3)):
    try:
        pipelined_forward(tanh, {"w": w}, x, mesh, num_microbatches=m)
    except ValueError as e:
        out[name] = np.array(str(e))
np.savez(f"{out_dir}/rank{rank}.npz", **out)
dist.destroy_process_group()
"""

JAX_SIDE = """
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from repro.configs.registry import CONFIGS
from repro.distributed.pipeline import pipelined_forward
from repro.models import layers
from repro.models import transformer as tf
out_dir = sys.argv[1]
data = np.load(f"{out_dir}/inputs.npz")
out = {}
tanh = lambda lp, h: jnp.tanh(h @ lp["w"])
w, x = jnp.asarray(data["w"]), jnp.asarray(data["x"])
for name, shape, axes, m in %(cases)r:
    mesh = jax.make_mesh(shape, axes)
    out[name] = np.asarray(pipelined_forward(tanh, {"w": w}, x, mesh,
                                             num_microbatches=m))
cfg = dataclasses.replace(CONFIGS["tinyllama-1.1b"].reduced(),
                          num_layers=%(tl_layers)d)
stacked = {}
for k in data.files:
    if k.startswith("p/layers/"):
        node = stacked
        *path, leaf = k[len("p/layers/"):].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(data[k])
positions = jnp.arange(%(tl_s)d)[None, :]
%(block)s
out["tinyllama"] = np.asarray(pipelined_forward(
    block, stacked, jnp.asarray(data["h"]), jax.make_mesh((4,), ("stage",)),
    num_microbatches=%(tl_m)d))
np.savez(f"{out_dir}/jax.npz", **out)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _tl_cfg(cfgs):
    return dataclasses.replace(cfgs["tinyllama-1.1b"].reduced(),
                               num_layers=TL_LAYERS)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The inputs; each rank's outputs on the gloo meshes and JAX's on the
    forced host devices, both sides started together."""
    d = tmp_path_factory.mktemp("pipeline")
    rng = np.random.default_rng(0)
    w = (0.3 * rng.standard_normal((L, D, D))).astype(np.float32)
    x = rng.standard_normal((B, D)).astype(np.float32)
    jparams = jbuild(_tl_cfg(CONFIGS)).init(jax.random.key(0))
    flat = _flatten(jparams)
    tokens = rng.integers(0, _tl_cfg(TCONFIGS).vocab_size, (TL_B, TL_S))
    h = flat["embedding"][tokens]
    np.savez(d / "inputs.npz", w=w, x=x, h=h,
             **{f"p/{k}": v for k, v in flat.items()})
    fill = dict(cases=CASES, tl_layers=TL_LAYERS, tl_s=TL_S, tl_m=TL_M,
                block=BLOCK)
    env = dict(os.environ, PYTHONPATH=SRC)
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_SIDE % fill), str(d)],
        env=dict(env, JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    port = _free_port()
    code = textwrap.dedent(WORKER % fill)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r),
                               str(port), str(d)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    logs = [p.communicate(timeout=240)[0] for p in procs + [jax_proc]]
    assert all(p.returncode == 0 for p in procs + [jax_proc]), \
        "\n".join(logs)[-6000:]
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(4)]
    inputs = dict(np.load(d / "inputs.npz"))
    return inputs, ranks, dict(np.load(d / "jax.npz")), flat


def _close(got, want, what):
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL, err_msg=what)


def _sequential(inputs):
    h = torch.as_tensor(inputs["x"])
    w = torch.as_tensor(inputs["w"])
    for i in range(L):
        h = torch.tanh(h @ w[i])
    return h.numpy()


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_tanh_stack_matches_sequential_and_jax(run, name):
    inputs, ranks, jout, _ = run
    got = ranks[0][name]
    assert got.shape == inputs["x"].shape
    _close(got, _sequential(inputs), f"{name} vs the sequential stack")
    _close(got, jout[name], f"{name} vs JAX's pipelined_forward")


@pytest.mark.parametrize("name", [c[0] for c in CASES] + ["tinyllama"])
def test_every_rank_holds_the_same_bits(run, name):
    _, ranks, _, _ = run
    for r in range(1, 4):
        np.testing.assert_array_equal(ranks[r][name], ranks[0][name],
                                      err_msg=f"rank {r}")


def test_dense_blocks_match_sequential_and_jax(run):
    """Reduced tinyllama, 4 layers over 4 stages: the port's dense block
    as ``layer_fn`` against the same block applied layer by layer, and
    against JAX's pipeline of JAX's block on the same weights."""
    inputs, ranks, jout, flat = run
    cfg = _tl_cfg(TCONFIGS)
    params = params_from_jax(flat, "cpu")
    positions = torch.arange(TL_S)[None, :]
    h = torch.as_tensor(inputs["h"])
    with torch.no_grad():
        for lp in ttf.unstack_layers(params["layers"], TL_LAYERS):
            x = tlayers.rmsnorm(h, lp["ln1"], cfg.norm_eps)
            h = h + ttf.attention_block(lp["attn"], x, cfg, positions,
                                        True)[0]
            x = tlayers.rmsnorm(h, lp["ln2"], cfg.norm_eps)
            h = h + ttf._ffn(lp["ffn"], x, cfg)[0]
    got = ranks[0]["tinyllama"]
    assert got.shape == (TL_B, TL_S, cfg.d_model)
    _close(got, h.numpy(), "tinyllama vs the sequential stack")
    _close(got, jout["tinyllama"], "tinyllama vs JAX's pipelined_forward")


@pytest.mark.parametrize("case,says", [("no_stage_axis", "no 'stage' axis"),
                                       ("indivisible", "must divide")])
def test_bad_meshes_and_batches_raise(run, case, says):
    """A mesh without a ``stage`` axis; a batch of 8 in 3 microbatches."""
    _, ranks, _, _ = run
    for r in range(4):
        assert says in str(ranks[r][case])


@pytest.mark.parametrize("s", [1, 2, 4, 8])
@pytest.mark.parametrize("m", [1, 2, 4, 7, 56])
def test_bubble_fraction_matches_jax(s, m):
    assert bubble_fraction(s, m) == jbubble(s, m)
