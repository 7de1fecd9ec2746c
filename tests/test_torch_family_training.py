"""Training of every family but dense against the JAX package, and
training under the hints, on the same weights.

chameleon-34b (vlm), moonshot-v1-16b-a3b and kimi-k2-1t-a32b (moe),
jamba-v0.1-52b (hybrid), seamless-m4t-large-v2 (encdec) and mamba2-1.3b
(ssm) at the reduced widths and weights of
``test_torch_families.pair`` (2 layers, or jamba's two periods), batches
of 2 x 24 tokens (with 2 x 10 frames for enc-dec):

* ``loss_fn`` and its gradients, the port's ``loss_and_grads`` against
  ``jax.value_and_grad``, ``remat="none"``: the loss within
  1e-5·max(1, |loss|), every gradient leaf within 1e-5 of that leaf's
  largest JAX magnitude + 1e-8 (both sides sum in float32 in other
  orders; the largest share measured was 3.0e-6, jamba's);
* three AdamW steps: the losses within 1e-5, every leaf of the
  parameters and of the optimizer state within 1e-3 of its largest
  magnitude (the bounds of ``test_ten_steps_match_jax``), and a weight
  whose first moment is within rounding of 0 within 2·lr more for each
  such step (AdamW may step it either way);
* the gradients under ``best_hints(cfg, "train")``'s hints and remat, set
  in both packages (``moe_impl="shardmap"`` is inert off a mesh in both):
  the same float32 bounds (at 24 tokens attention takes the naive path,
  where ``attn_logits_bf16`` does not act, in both packages).

Reduced tinyllama-1.1b (``pair``'s 2 layers) on one row of 2048 tokens
(the flash path), ``remat="dots"``: under ``attn_impl="repeat_kv"``
every leaf within 1e-5 of its largest; with ``attn_logits_bf16`` added,
within 1e-2, a little over one bfloat16 unit (2^-7) of a leaf's largest
value. The hint alone moves JAX's own gradients by 2.6e-3 of a leaf's
largest and the port's by 6.2e-3; the port's hinted gradients are 5.9e-3
from JAX's. The hinted gradients must differ from the port's unhinted
ones.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.distributed import hints as jhints  # noqa: E402
from repro.distributed.autotune import \
    best_hints as jbest_hints  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training.checkpoint import _flatten  # noqa: E402
from repro.training.train_step import \
    make_train_step as jmake_train_step  # noqa: E402
from repro_torch.distributed import hints as thints  # noqa: E402
from repro_torch.distributed.autotune import best_hints  # noqa: E402
from repro_torch.models.convert import flat_from_tree  # noqa: E402
from repro_torch.training.optimizer import (OptimizerConfig,  # noqa: E402
                                            adamw_init)
from repro_torch.training.train_step import (loss_and_grads,  # noqa: E402
                                             make_train_step)
from test_torch_families import _batch, _both, pair  # noqa: E402

torch.set_num_threads(2)

ARCHS = ["chameleon-34b", "moonshot-v1-16b-a3b", "kimi-k2-1t-a32b",
         "jamba-v0.1-52b", "seamless-m4t-large-v2", "mamba2-1.3b"]
GRAD_OF_MAX = 1e-5        # float32 gradients, a fraction of a leaf's max
BF16_OF_MAX = 1e-2        # under attn_logits_bf16
STEPS = 3
#: reduced tinyllama on the flash path: one row of LONG_S tokens
LONG_S = 2048


def _opt(module=None):
    """``test_ten_steps_match_jax``'s AdamW, the port's or ``module``'s."""
    cls = module.OptimizerConfig if module else OptimizerConfig
    return cls(name="adamw", lr=2e-3, warmup_steps=5)


@pytest.fixture(autouse=True)
def _reset_hints():
    yield
    jhints.reset()
    thints.reset()


@contextlib.contextmanager
def both(**kw):
    """The same hints in both packages' tables."""
    with jhints.hints(**kw), thints.hints(**kw):
        yield


def _grads(arch, batch, remat):
    """(JAX loss, JAX gradients, port loss, port gradients) of loss_fn."""
    jm, tm, jparams, tparams = pair(arch)
    jb, tb = _both(batch)
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, jb, remat=remat)))(jparams)
    tloss, tg = loss_and_grads(tm, tparams, tb, remat=remat)
    return float(jloss), _flatten(jg), float(tloss), flat_from_tree(tg)


def _leaves_of_max(tflat, jflat, of_max, atol=0.0):
    """Every port leaf within ``of_max`` of the JAX leaf's largest
    magnitude (+ ``atol``)."""
    assert sorted(tflat) == sorted(jflat)
    for k, want in jflat.items():
        want = np.asarray(want, np.float32)
        top = float(np.abs(want).max(initial=0.0))
        err = float(np.abs(tflat[k] - want).max(initial=0.0))
        assert err <= of_max * top + atol, (k, err, top)


def _loss_close(tloss, jloss):
    assert abs(tloss - jloss) <= 1e-5 * max(1.0, abs(jloss)), (tloss, jloss)


# --------------------------------------------------------------- families
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch):
    cfg = pair(arch)[1].cfg
    batch = _batch(cfg, np.random.default_rng(3))
    jloss, jg, tloss, tg = _grads(arch, batch, "none")
    _loss_close(tloss, jloss)
    _leaves_of_max(tg, jg, GRAD_OF_MAX, atol=1e-8)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_adamw_steps_match_jax(arch):
    """Losses within 1e-5; every leaf of the parameters and of the
    optimizer state within 1e-3 of its largest magnitude. AdamW steps a
    weight by about lr whatever its gradient's size, so a weight whose
    first moment is within float32 rounding of 0 (GRAD_OF_MAX of the
    leaf's largest) may step either way on the two sides: such a weight,
    and its master copy, may differ by up to 2·lr more for each step
    taken so (jamba's embedding: one entry of 16,384, whose gradient is
    -4.5e-7 in JAX and 1.3e-7 here beside entries of 7e-2)."""
    jm, tm, jparams, tparams = pair(arch)
    _, jstep = jmake_train_step(jm, _opt(jopt), remat="none")
    _, tstep = make_train_step(tm, _opt(), remat="none")
    jstate = (jparams, jopt.adamw_init(jparams))
    tstate = (tparams, adamw_init(tparams))
    jstep = jax.jit(jstep)
    rng = np.random.default_rng(7)
    tipped = {}
    for i in range(STEPS):
        jb, tb = _both(_batch(tm.cfg, rng))
        *jstate, jm_ = jstep(*jstate, jb)
        *tstate, tm_ = tstep(*tstate, tb)
        np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]),
                                   atol=1e-5, rtol=0, err_msg=f"step {i}")
        for k, m in _flatten(jstate[1]["m"]).items():
            m = np.abs(np.asarray(m))
            tipped[k] = tipped.get(k, 0.0) + 2 * float(jm_["lr"]) * (
                m <= GRAD_OF_MAX * m.max(initial=0.0))
    tflat, jflat = flat_from_tree(tuple(tstate)), _flatten(tuple(jstate))
    assert sorted(tflat) == sorted(jflat)
    for k, want in jflat.items():
        want = np.asarray(want)
        tol = 1e-3 * float(np.abs(want).max(initial=0.0))
        for side in ("__T0/", "__T1/master/"):
            if k.startswith(side):
                tol = tol + tipped[k[len(side):]]
        np.testing.assert_array_less(np.abs(tflat[k] - want),
                                     tol + np.finfo(np.float32).tiny,
                                     err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_under_best_hints_match_jax(arch):
    """At 24 tokens attention takes the naive path in both packages, where
    ``attn_logits_bf16`` does not act, so the float32 bounds hold."""
    jm, tm, _, _ = pair(arch)
    hint, remat = best_hints(tm.cfg, "train")
    assert (hint, remat) == jbest_hints(jm.cfg, "train")
    batch = _batch(tm.cfg, np.random.default_rng(5))
    with both(**hint):
        jloss, jg, tloss, tg = _grads(arch, batch, remat)
    _loss_close(tloss, jloss)
    _leaves_of_max(tg, jg, GRAD_OF_MAX, atol=1e-8)


# ------------------------------------------------- hinted dense training
_LONG = {}


def _long_grads(hint, remat="dots"):
    """``_grads`` of reduced tinyllama on one row of LONG_S tokens under
    ``hint`` (the flash path in both packages), computed once a hint."""
    key = tuple(sorted(hint.items()))
    if key not in _LONG:
        cfg = pair("tinyllama-1.1b")[1].cfg
        toks = np.random.default_rng(11).integers(
            0, cfg.vocab_size, (1, LONG_S)).astype(np.int32)
        with both(**hint):
            _LONG[key] = _grads("tinyllama-1.1b", {"tokens": toks}, remat)
    return _LONG[key]


def test_repeat_kv_gradients_match_jax_on_the_flash_path():
    jloss, jg, tloss, tg = _long_grads({"attn_impl": "repeat_kv"})
    _loss_close(tloss, jloss)
    _leaves_of_max(tg, jg, GRAD_OF_MAX)


def test_bf16_logits_gradients_match_jax_and_differ_from_no_hint():
    jloss, jg, tloss, tg = _long_grads({"attn_impl": "repeat_kv",
                                        "attn_logits_bf16": True})
    assert abs(tloss - jloss) <= BF16_OF_MAX * max(1.0, abs(jloss))
    _leaves_of_max(tg, jg, BF16_OF_MAX)
    *_, plain = _long_grads({"attn_impl": "repeat_kv"})
    moved = max(float(np.abs(tg[k] - plain[k]).max()) /
                float(np.abs(plain[k]).max()) for k in plain)
    assert moved > GRAD_OF_MAX, f"the hint moved no gradient ({moved:.1e})"
