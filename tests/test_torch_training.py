"""The port's training substrate against the JAX package, case by case
with tests/test_training.py, plus parity on the same weights.

Reduced tinyllama (4 layers, d_model 64); weights made by the JAX
initialiser and carried across by ``params_from_jax``; batches from
``SyntheticTokens``, which both packages compute identically. Tolerances:

* ``forward`` logits 1e-4 absolute (float32 through four layers), the loss
  1e-5, every gradient leaf 1e-6 absolute + 1e-4 relative (the gradients
  are ~1e-3; both sides sum in float32 in another order);
* 10 optimizer steps: losses 1e-5; every leaf of the parameters and of
  the optimizer state within 1e-3 of that leaf's largest magnitude
  (AdamW divides each moment by its own square root, so where a gradient
  is near zero a rounding difference tips its parameter's step: 1.2e-5
  on an embedding whose largest entry is 8.5e-2, at lr 2e-3);
* checkpoints, data, remat policies and the restart replay: exact.
"""
import dataclasses

import numpy as np
import pytest
from _hypo import given, settings, st

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import CONFIGS  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.factory import build_model as jbuild  # noqa: E402
from repro.training import grad_compression as jgc  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training.checkpoint import CheckpointManager as JCkpt  # noqa: E402
from repro.training.checkpoint import _flatten  # noqa: E402
from repro.training.data import DataConfig as JDataConfig  # noqa: E402
from repro.training.data import SyntheticTokens as JTokens  # noqa: E402
from repro.training.train_step import \
    make_train_step as jmake_train_step  # noqa: E402
from repro_torch.configs.registry import CONFIGS as TCONFIGS  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.convert import (flat_from_tree,  # noqa: E402
                                        params_from_jax, tree_from_flat)
from repro_torch.models.factory import build_model as tbuild  # noqa: E402
from repro_torch.training import grad_compression as gc  # noqa: E402
from repro_torch.training.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.training.data import DataConfig, SyntheticTokens  # noqa: E402
from repro_torch.training.fault_tolerance import (  # noqa: E402
    ElasticPlan, FailureInjector, InjectedFault, ResilientTrainer,
    StragglerMitigator)
from repro_torch.training.optimizer import (  # noqa: E402
    OptimizerConfig, adafactor_init, adamw_init, make_optimizer)
from repro_torch.training.train_step import (  # noqa: E402
    make_prefill_step, make_serve_step, make_train_step)
from repro_torch.training.tree import (tree_leaves,  # noqa: E402
                                       tree_unflatten)

torch.set_num_threads(2)


def _opt(name="adamw", module=None):
    """The optimizer config of the tests, the port's or ``module``'s."""
    cls = module.OptimizerConfig if module else OptimizerConfig
    return cls(name=name, lr=2e-3, warmup_steps=5)


def _grad_leaves(params):
    """A copy of ``params`` whose leaves need gradients, and the leaves."""
    tree = tree_from_flat(flat_from_tree(params), "cpu")
    return tree, [p.requires_grad_(True) for p in tree_leaves(tree)]


@pytest.fixture(scope="module")
def setup():
    cfg = TCONFIGS["tinyllama-1.1b"].reduced()
    model = tbuild(cfg, "cpu")
    init_state, train_step = make_train_step(model, _opt(), remat="none")
    params, opt = init_state(torch.Generator().manual_seed(0), torch.float32)
    data = SyntheticTokens(DataConfig(cfg.vocab_size, 64, 4, seed=7))
    return cfg, model, train_step, (params, opt), data


@pytest.fixture(scope="module")
def pair():
    """The same weights in both packages."""
    jcfg = CONFIGS["tinyllama-1.1b"].reduced()
    tcfg = TCONFIGS["tinyllama-1.1b"].reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    tparams = params_from_jax(_flatten(jparams), "cpu")
    return jmodel, jparams, tbuild(tcfg, "cpu"), tparams


def _run(step, state, data, steps, start=0):
    params, opt = state
    losses = []
    for s in range(start, start + steps):
        params, opt, m = step(params, opt, data.batch(s))
        losses.append(float(m["loss"]))
    return (params, opt), losses


def _jrun(jstep, state, data, steps):
    params, opt = state
    losses = []
    for s in range(steps):
        b = {k: jnp.asarray(v) for k, v in data.batch(s).items()}
        params, opt, m = jstep(params, opt, b)
        losses.append(float(m["loss"]))
    return (params, opt), losses


def _leaves_equal(a, b):
    fa, fb = flat_from_tree(a), flat_from_tree(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _close_to_jax(ttree, jtree, atol=0.0, rtol=0.0, of_max=0.0):
    """Every leaf of a port tree against the JAX tree at the same path;
    ``of_max`` adds that fraction of the leaf's largest magnitude to
    ``atol``."""
    tflat, jflat = flat_from_tree(ttree), _flatten(jtree)
    assert sorted(tflat) == sorted(jflat)
    for k, want in jflat.items():
        want = np.asarray(want)
        tol = atol + of_max * float(np.abs(want).max(initial=0.0))
        np.testing.assert_allclose(tflat[k], want, atol=tol, rtol=rtol,
                                   err_msg=k)


def test_loss_decreases(setup):
    cfg, model, step, state, data = setup
    _, losses = _run(step, state, data, 30)
    assert losses[-1] < losses[0] - 0.02


def test_adafactor_converges(setup):
    cfg, model, *_ = setup
    init_state, train_step = make_train_step(model, _opt("adafactor"),
                                             remat="none")
    state = init_state(torch.Generator().manual_seed(0), torch.float32)
    data = SyntheticTokens(DataConfig(cfg.vocab_size, 64, 4, seed=7))
    _, losses = _run(train_step, state, data, 30)
    assert losses[-1] < losses[0] - 0.02


def test_adafactor_memory_is_factored():
    """The FULL kimi config's leaf shapes (JAX ``eval_shape``, no
    allocation) as meta tensors: the port's factored moments are under 2%
    of AdamW's."""
    aparams = jbuild(CONFIGS["kimi-k2-1t-a32b"]).abstract_params()
    meta = {k: torch.empty(s, device="meta")
            for k, s in _flat_shapes(aparams).items()}
    ad = adafactor_init(meta)
    adam = adamw_init(meta)
    n_ad = sum(x.numel() for x in tree_leaves(ad["v_row"])
               + tree_leaves(ad["v_col"]))
    n_adam = sum(x.numel() for x in tree_leaves(adam["v"]))
    assert n_ad < 0.02 * n_adam


def _flat_shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_shapes(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tuple(tree.shape)}


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_matches_no_remat(setup, policy):
    cfg, model, _, (params, _), data = setup
    batch = {k: torch.as_tensor(v) for k, v in data.batch(0).items()}

    def grads(remat):
        tree, ls = _grad_leaves(params)
        return torch.autograd.grad(model.loss_fn(tree, batch, remat=remat),
                                   ls)

    for a, b in zip(grads("none"), grads(policy)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4,
                                   rtol=1e-3)


def test_remat_dots_saves_the_matmuls_and_recomputes_attention(setup):
    """Under ``dots`` the backward recomputes the layer but not its
    projection / MLP products (JAX's checkpoint_dots_with_no_batch_dims):
    fewer matmuls run than under ``full``."""
    cfg, model, _, (params, _), data = setup
    batch = {k: torch.as_tensor(v) for k, v in data.batch(0).items()}
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.mm = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
                self.mm += 1
            return func(*args, **(kwargs or {}))

    counts = {}
    for remat in ("none", "full", "dots"):
        tree, ls = _grad_leaves(params)
        with Count() as c:
            loss = model.loss_fn(tree, batch, remat=remat)
            torch.autograd.grad(loss, ls)
        counts[remat] = c.mm
    assert counts["none"] == counts["dots"] < counts["full"]


# ------------------------------------------------------- parity with JAX
def test_forward_loss_and_gradients_match_jax(pair):
    jmodel, jparams, tmodel, tparams = pair
    tokens = SyntheticTokens(DataConfig(256, 48, 2, seed=3)).batch(0)
    jbatch = {k: jnp.asarray(v) for k, v in tokens.items()}
    tbatch = {k: torch.as_tensor(v) for k, v in tokens.items()}
    jlogits, _ = jmodel.forward(jparams, jbatch, remat="none")
    tlogits, aux = tmodel.forward(tparams, tbatch, remat="none")
    assert float(aux) == 0.0
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=0)
    mask = (np.arange(47)[None, :] % 3 != 0).astype(np.float32).repeat(2, 0)
    for m in (None, mask):
        jb = dict(jbatch, **({} if m is None else {"mask": jnp.asarray(m)}))
        tb = dict(tbatch, **({} if m is None else {"mask": torch.as_tensor(m)}))
        jloss, jgrads = jax.value_and_grad(
            lambda p: jmodel.loss_fn(p, jb, remat="none"))(jparams)
        tree, ls = _grad_leaves(tparams)
        tloss = tmodel.loss_fn(tree, tb, remat="full")
        tgrads = torch.autograd.grad(tloss, ls)
        np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                                   atol=1e-5,
                                   rtol=0)
        _close_to_jax(tree_unflatten(tree, list(tgrads)), jgrads, 1e-6, 1e-4)


def test_cross_entropy_matches_jax():
    from repro.models import layers as jlayers
    from repro_torch.models import layers as tlayers
    rng = np.random.default_rng(0)
    logits = (5 * rng.standard_normal((3, 7, 40))).astype(np.float32)
    labels = rng.integers(0, 40, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.4).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        want = jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                     None if m is None else jnp.asarray(m))
        got = tlayers.cross_entropy(torch.from_numpy(logits),
                                    torch.from_numpy(labels),
                                    None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), atol=1e-6,
                                   rtol=1e-6)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_ten_steps_match_jax(pair, name):
    jmodel, jparams, tmodel, tparams = pair
    jinit, jstep = jmake_train_step(jmodel, _opt(name, jopt), remat="none")
    opt_init = jopt.adamw_init if name == "adamw" else jopt.adafactor_init
    jstate = (jparams, opt_init(jparams))
    _, tstep = make_train_step(tmodel, _opt(name), remat="full")
    tinit, _ = make_optimizer(_opt(name))
    tstate = (tparams, tinit(tparams))
    jdata = JTokens(JDataConfig(256, 64, 4, seed=7))
    tdata = SyntheticTokens(DataConfig(256, 64, 4, seed=7))
    (jp, jo), jl = _jrun(jax.jit(jstep), jstate, jdata, 10)
    (tp, to), tl = _run(tstep, tstate, tdata, 10)
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    _close_to_jax((tp, to), (jp, jo), of_max=1e-3)


def test_lr_schedule_and_step_scalars_are_float32():
    from repro_torch.training.optimizer import lr_schedule
    cfg = _opt()
    for step in (1, 3, 5, 9):
        got = lr_schedule(cfg, torch.tensor(step, dtype=torch.int32))
        want = jopt.lr_schedule(_opt(module=jopt), jnp.int32(step))
        assert got.dtype == torch.float32
        assert float(got) == float(want)


def test_adamw_master_never_aliases_params(setup):
    _, _, _, (params, _), _ = setup
    state = adamw_init(params)
    for p, m in zip(tree_leaves(params), tree_leaves(state["master"])):
        assert p.data_ptr() != m.data_ptr()


# ---------------------------------------------------------------- data
def test_data_deterministic():
    d1 = SyntheticTokens(DataConfig(256, 32, 2, seed=1))
    d2 = SyntheticTokens(DataConfig(256, 32, 2, seed=1))
    np.testing.assert_array_equal(d1.batch(5)["tokens"], d2.batch(5)["tokens"])
    assert not np.array_equal(d1.batch(5)["tokens"], d1.batch(6)["tokens"])


def test_data_identical_to_jax():
    t = SyntheticTokens(DataConfig(32000, 128, 4, seed=3))
    j = JTokens(JDataConfig(32000, 128, 4, seed=3))
    for step in (0, 1, 17):
        np.testing.assert_array_equal(t.batch(step)["tokens"],
                                      j.batch(step)["tokens"])


# ----------------------------------------------------------- checkpoint
def test_checkpoint_roundtrip(tmp_path, setup):
    _, _, step, state, data = setup
    state, _ = _run(step, state, data, 3)
    ck = CheckpointManager(str(tmp_path), device="cpu")
    ck.save(3, state, extra={"losses": [1.0, 2.0]})
    s, restored, extra = ck.restore()
    assert s == 3 and extra["losses"] == [1.0, 2.0]
    assert isinstance(restored, tuple)
    _leaves_equal(state, restored)
    assert restored[1]["step"].dtype == torch.int32
    assert restored[1]["step"].shape == ()


def test_checkpoint_gc_and_journal(tmp_path):
    ck = CheckpointManager(str(tmp_path), keep=2, device="cpu")
    for s in (1, 2, 3, 4):
        ck.save(s, {"w": np.full((2,), s)})
    assert ck.all_steps() == [3, 4]
    assert ck.latest_step() == 4


def test_async_checkpoint(tmp_path):
    ck = CheckpointManager(str(tmp_path), async_save=True, device="cpu")
    ck.save(1, {"w": torch.arange(4)})
    ck.wait()
    assert ck.latest_step() == 1


def test_checkpoints_cross_packages_both_ways(tmp_path, pair):
    """A JAX (params, AdamW state) checkpoint restores in the port, and
    the port's in JAX, leaf for leaf; one more step from either restore
    agrees with the other package's step."""
    jmodel, jparams, tmodel, tparams = pair
    jinit, jstep = jmake_train_step(jmodel, _opt(module=jopt), remat="none")
    jdata = JTokens(JDataConfig(256, 64, 4, seed=7))
    jstate, _ = _jrun(jax.jit(jstep), (jparams, jopt.adamw_init(jparams)),
                      jdata, 2)
    JCkpt(str(tmp_path / "j")).save(2, jstate, extra={"losses": [1.5]})
    step, tstate, extra = CheckpointManager(str(tmp_path / "j"),
                                            device="cpu").restore()
    assert step == 2 and extra == {"losses": [1.5]}
    jflat = _flatten(jstate)
    tflat = flat_from_tree(tstate)
    assert sorted(jflat) == sorted(tflat)
    for k, v in jflat.items():
        np.testing.assert_array_equal(tflat[k], np.asarray(v), err_msg=k)
        assert tflat[k].dtype == np.asarray(v).dtype, k

    CheckpointManager(str(tmp_path / "t"), device="cpu").save(2, tstate)
    _, back, _ = JCkpt(str(tmp_path / "t")).restore()
    for k, v in _flatten(back).items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(jflat[k]))

    _, tstep = make_train_step(tmodel, _opt(), remat="none")
    batch = jdata.batch(2)
    jp, jo, jm = jax.jit(jstep)(*back, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    tp, to, tm = tstep(*tstate, batch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               atol=1e-5, rtol=0)
    _close_to_jax((tp, to), (jp, jo), of_max=1e-3)


def test_bfloat16_leaves_are_refused_not_widened():
    with pytest.raises(TypeError, match="bfloat16"):
        flat_from_tree({"w": torch.zeros(2, dtype=torch.bfloat16)})


# ------------------------------------------------------- fault tolerance
def test_restart_reproduces_uninterrupted_run(tmp_path, setup):
    """Failure + restore must give EXACTLY the uninterrupted trajectory."""
    cfg, model, step, state0, data = setup

    def step_fn(state, batch):
        p, o = state
        p, o, m = step(p, o, batch)
        return (p, o), m

    ck1 = CheckpointManager(str(tmp_path / "a"), keep=5, device="cpu")
    t1 = ResilientTrainer(step_fn, data.batch, ck1, ckpt_every=4)
    sA, rA = t1.run(state0, 12)

    ck2 = CheckpointManager(str(tmp_path / "b"), keep=5, device="cpu")
    inj = FailureInjector(fail_at_steps=(6, 9))
    t2 = ResilientTrainer(step_fn, data.batch, ck2, ckpt_every=4,
                          injector=inj)
    sB, rB = t2.run(state0, 12)

    assert rB.restarts == 2 and rA.restarts == 0
    assert rA.losses == rB.losses
    _leaves_equal(sA, sB)


def test_injector_exceeds_max_restarts(tmp_path, setup):
    _, _, _, state0, data = setup

    def step_fn(state, batch):
        raise InjectedFault("always")

    ck = CheckpointManager(str(tmp_path), device="cpu")
    t = ResilientTrainer(step_fn, data.batch, ck, max_restarts=2)
    with pytest.raises(InjectedFault):
        t.run(state0, 5)


def test_elastic_shrink_plan():
    p = ElasticPlan.shrink(global_batch=256, data_shards=16, lost_shards=4)
    assert p.data_shards == 12
    assert p.per_shard_batch * p.data_shards <= 256
    with pytest.raises(ValueError):
        ElasticPlan.shrink(256, 4, 4)


def test_straggler_detection():
    s = StragglerMitigator(window=16, threshold=2.0)
    flagged = [s.observe(i, 1.0) for i in range(20)]
    assert not any(flagged)
    assert s.observe(20, 5.0) is True
    assert 20 in s.flagged


# ----------------------------------------------------- grad compression
@given(st.integers(0, 2 ** 31 - 1))
@settings(max_examples=20, deadline=None)
def test_quantize_roundtrip_error_bound(seed):
    g = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (64, 32)).astype(np.float32))
    q, s = gc.quantize_leaf(g)
    err = torch.abs(gc.dequantize_leaf(q, s) - g)
    assert float(torch.max(err)) <= float(s) / 2 + 1e-7


def test_compression_equals_jax():
    rng = np.random.default_rng(0)
    grads = {"w": rng.standard_normal((16, 8)).astype(np.float32),
             "b": {"c": (0.5 * rng.standard_normal(5)).astype(np.float32)}}
    jerr = terr = None
    for _ in range(3):
        (jq, js), jerr = jgc.compress(jax.tree.map(jnp.asarray, grads), jerr)
        (tq, ts), terr = gc.compress(
            {"w": torch.from_numpy(grads["w"]),
             "b": {"c": torch.from_numpy(grads["b"]["c"])}}, terr)
        for k in ("w", "b/c"):
            np.testing.assert_array_equal(flat_from_tree(tq)[k],
                                          np.asarray(_flatten(jq)[k]))
            np.testing.assert_allclose(flat_from_tree(ts)[k],
                                       np.asarray(_flatten(js)[k]),
                                       rtol=1e-7)
            np.testing.assert_allclose(flat_from_tree(terr)[k],
                                       np.asarray(_flatten(jerr)[k]),
                                       atol=1e-7)
    assert gc.compression_ratio(tq) == jgc.compression_ratio(jq)


def test_error_feedback_reduces_bias():
    """With EF, the sum of compressed grads tracks the true sum."""
    rng = np.random.default_rng(0)
    true_sum = torch.zeros((32,))
    ef_sum = torch.zeros((32,))
    err = None
    for _ in range(50):
        g = {"w": torch.from_numpy(rng.standard_normal(32).astype(
            np.float32)) * 0.01}
        comp, err = gc.compress(g, err)
        deq = gc.decompress(comp)
        true_sum = true_sum + g["w"]
        ef_sum = ef_sum + deq["w"]
    # residual bounded by one quantization step, not accumulating
    assert float(torch.max(torch.abs(true_sum - ef_sum))) < 5e-4


def test_compression_ratio():
    g = {"a": torch.zeros((1024, 1024)), "b": torch.zeros((512,))}
    assert gc.compression_ratio(g) > 3.9


# --------------------------------------------------- prefill and serving
def test_prefill_matches_jax_and_feeds_decode(pair):
    """Whole-prompt prefill: logits and the cache's first max_seq positions
    agree with JAX (bfloat16: 2e-2), the drop position stays zero, and a
    decode step on the returned cache agrees with JAX's on its cache."""
    jmodel, jparams, tmodel, tparams = pair
    cfg, max_seq = tmodel.cfg, 24
    tokens = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 16),
                                               dtype=np.int32)
    jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                                     max_seq)
    tlogits, tcache = make_prefill_step(tmodel, max_seq)(
        tparams, {"tokens": tokens})
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=0)
    assert tcache["k"].shape == (cfg.num_layers, 2, max_seq + 1,
                                 cfg.num_kv_heads, cfg.resolved_head_dim)
    for key in ("k", "v"):
        assert tcache[key].dtype == torch.bfloat16
        np.testing.assert_allclose(
            tcache[key][:, :, :max_seq].float().numpy(),
            np.asarray(jcache[key].astype(jnp.float32)), atol=2e-2, rtol=2e-2)
        assert torch.all(tcache[key][:, :, 16:] == 0)
    nxt = np.argmax(np.asarray(jlogits)[:, -1], -1).astype(np.int32)[:, None]
    lengths = np.full((2,), 16, np.int32)
    jl, _ = jtf.decode_step(jparams, jcache, jnp.asarray(nxt),
                            jnp.asarray(lengths), jmodel.cfg)
    tl, _ = make_serve_step(tmodel)(tparams, tcache, torch.from_numpy(nxt),
                                    torch.from_numpy(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-3, rtol=0)
    with pytest.raises(ValueError, match="max_seq"):
        ttf.prefill(tparams, torch.from_numpy(tokens), cfg, 8)


def test_forward_is_refused_for_the_ssm_family():
    """Off the CPU the ssm family's forward runs the SSD kernel, which has
    no backward yet: a forward that needs gradients raises there (shown
    on the meta device, which takes the kernel's route), while the same
    forward without gradients goes on to the kernel's wrapper (which
    takes only the CPU or a card). On the CPU it trains."""
    model = tbuild(TCONFIGS["mamba2-1.3b"].reduced(), "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    meta = _tree_map(params, lambda t: t.to("meta").requires_grad_(True))
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32,
                                   device="meta")}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.forward(meta, batch, remat="none")
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA device"):
        model.forward(meta, batch, remat="none")
    cpu = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    model.loss_fn(_tree_map(params, lambda t: t.requires_grad_(True)),
                  cpu).backward()
    assert params["layers"]["ssm"]["w_x"].grad.abs().sum() > 0


def _tree_map(node, fn):
    return {k: _tree_map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in node.items()}


# ----------------------------------------------------------------- CLI
def test_train_cli_plain_loop_on_cpu(capsys):
    run = ttrain.main(["--reduced", "--device", "cpu", "--steps", "12",
                       "--batch", "4", "--seq", "32", "--remat", "full"])
    assert len(run.losses) == len(run.step_seconds) == 12
    assert run.losses[-1] < run.losses[0]
    assert "OK" in capsys.readouterr().out


@pytest.mark.parametrize("extra", [[], ["--compress-grads"]])
def test_train_cli_restarts_from_checkpoints(tmp_path, extra):
    result = ttrain.main(["--reduced", "--device", "cpu", "--steps", "8",
                          "--batch", "2", "--seq", "32", "--ckpt-dir",
                          str(tmp_path), "--ckpt-every", "3", "--fail-at",
                          "5"] + extra)
    assert result.final_step == 8 and result.restarts == 1
    assert len(result.losses) == 8
    assert CheckpointManager(str(tmp_path), device="cpu").latest_step() == 8


# -------------------------------------------------------------------- card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built with nvcc and "
                    "run only there")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_loss_gradients_match_cpu_under_every_remat(cuda_device, setup):
    """On the card the loss goes through the flash kernel and its gradient
    through the backward kernel, under every remat policy (``dots`` runs
    the kernels under selective checkpointing); each policy's gradients
    agree with the CPU path's within 1e-3 of each leaf's largest."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    cfg, model, _, (params, _), data = setup
    batch = {k: torch.as_tensor(v) for k, v in data.batch(0).items()}
    tree, ls = _grad_leaves(params)
    want = torch.autograd.grad(model.loss_fn(tree, batch, remat="none"), ls)
    card = tbuild(cfg, cuda_device)
    cparams = tree_from_flat(flat_from_tree(params), cuda_device)
    cbatch = {k: v.to(cuda_device) for k, v in batch.items()}
    for remat, fwd_per_layer in (("none", 1), ("full", 2), ("dots", 2)):
        flash_attention.launches = flash_attention_bwd.launches = 0
        tree = tree_from_flat(flat_from_tree(cparams), cuda_device)
        ls = [p.requires_grad_(True) for p in tree_leaves(tree)]
        got = torch.autograd.grad(card.loss_fn(tree, cbatch, remat=remat), ls)
        torch.cuda.synchronize()
        assert flash_attention.launches == fwd_per_layer * cfg.num_layers
        assert flash_attention_bwd.launches == cfg.num_layers
        for g, w in zip(got, want):
            scale = float(w.abs().max()) or 1.0
            assert float((g.cpu() - w).abs().max()) <= 1e-3 * scale
