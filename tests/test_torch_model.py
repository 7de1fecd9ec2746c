"""The port's dense transformer against the JAX package on the same weights.

Reduced tinyllama with 2 layers; weights made by the JAX initialiser and
carried across by ``params_from_jax``; pools seeded with the same random
bfloat16 history. One batched ``prefill_chunk_paged`` (an inactive row, a
tail-padded ``valid`` row, a chunk crossing pages) and one
``decode_step_paged`` (an inactive row, a row whose block index is clamped
to ``nb - 1``). Logits agree within 1e-4 (float32), pools within 2e-2
(bfloat16: one rounding step of a value near a tie).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import CONFIGS  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.factory import build_model as jbuild  # noqa: E402
from repro.training.checkpoint import _flatten  # noqa: E402
from repro_torch.configs.registry import CONFIGS as TCONFIGS  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.factory import build_model as tbuild  # noqa: E402

torch.set_num_threads(2)

PAGE, NB, POOL = 4, 4, 14


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(CONFIGS["tinyllama-1.1b"].reduced(),
                               num_layers=2)
    tcfg = dataclasses.replace(TCONFIGS["tinyllama-1.1b"].reduced(),
                               num_layers=2)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = jbuild(jcfg).init(jax.random.key(0))
    tparams = params_from_jax(_flatten(jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _pools(cfg, rng):
    """The same random history in both; the port's pools carry one more
    page at the end, the drop page (``transformer.init_paged_cache``)."""
    shape = (cfg.num_layers, POOL, PAGE, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    k = rng.standard_normal(shape).astype(np.float32) * 0.3
    v = rng.standard_normal(shape).astype(np.float32) * 0.3
    jc = {"k_pages": jnp.asarray(k).astype(jnp.bfloat16),
          "v_pages": jnp.asarray(v).astype(jnp.bfloat16)}
    tc = ttf.init_paged_cache(cfg, POOL, PAGE, torch.device("cpu"))
    tc["k_pages"][:, :POOL] = torch.from_numpy(k).to(torch.bfloat16)
    tc["v_pages"][:, :POOL] = torch.from_numpy(v).to(torch.bfloat16)
    return jc, tc


def _pools_close(jc, tc):
    """Every page JAX has; the port's extra drop page takes the writes that
    JAX drops (``transformer.paged_write_index``)."""
    for key in ("k_pages", "v_pages"):
        np.testing.assert_allclose(
            np.asarray(jc[key].astype(jnp.float32)),
            tc[key].float().numpy()[:, :POOL], atol=2e-2, rtol=2e-2)


def test_params_carry_over_with_same_leaves(pair):
    jcfg, tcfg, jparams, tparams = pair
    jflat = _flatten(jparams)
    tflat = {}

    def walk(node, prefix):
        for k, v in node.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, path)
            else:
                tflat[path] = v
    walk(tparams, "")
    assert sorted(jflat) == sorted(tflat)
    for path, arr in jflat.items():
        assert tuple(arr.shape) == tuple(tflat[path].shape), path
        np.testing.assert_array_equal(arr, tflat[path].numpy())
    # the port's own initialiser makes the same leaves and shapes
    own = tbuild(tcfg, "cpu").init(torch.Generator().manual_seed(0))
    assert {k: v.shape for k, v in own["layers"]["attn"].items()} == \
        {k: v.shape for k, v in tparams["layers"]["attn"].items()}


def test_paged_prefill_and_decode_match_jax(pair):
    jcfg, tcfg, jparams, tparams = pair
    rng = np.random.default_rng(0)
    jc, tc = _pools(jcfg, rng)
    b, c = 3, 6
    bt = np.array([[1, 2, 3, 4], [5, 6, 7, 0], [8, 9, 0, 0]], np.int32)
    start = np.array([2, 5, 1], np.int32)
    active = np.array([True, True, False])
    valid = np.array([6, 3, 6], np.int32)           # row 1 tail-padded
    tokens = rng.integers(0, jcfg.vocab_size, (b, c)).astype(np.int32)

    jl, jc = jtf.prefill_chunk_paged(
        jparams, jc, jnp.asarray(tokens), jnp.asarray(start),
        jnp.asarray(bt), jcfg, jnp.asarray(active), jnp.asarray(valid))
    tl, tc2 = ttf.prefill_chunk_paged(
        tparams, tc, torch.from_numpy(tokens), torch.from_numpy(start),
        torch.from_numpy(bt), tcfg, torch.from_numpy(active),
        torch.from_numpy(valid))
    assert tc2 is tc                                # pools written in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    _pools_close(jc, tc)

    # decode: row 0 at the end of its table (block index clamped to nb-1),
    # row 1 after its valid tokens, row 2 inactive
    lengths = np.array([NB * PAGE, 8, 3], np.int32)
    active = np.array([True, True, False])
    tok1 = rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
    jl, jc = jtf.decode_step_paged(
        jparams, jc, jnp.asarray(tok1), jnp.asarray(lengths),
        jnp.asarray(bt), jcfg, jnp.asarray(active))
    tl, _ = ttf.decode_step_paged(
        tparams, tc, torch.from_numpy(tok1), torch.from_numpy(lengths),
        torch.from_numpy(bt), tcfg, torch.from_numpy(active))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    _pools_close(jc, tc)


def test_inactive_rows_and_pads_write_nothing(pair):
    """The drop-page writes that replace JAX's out-of-range
    ``mode="drop"``: pages of inactive rows and tail pads stay
    bit-identical; only the drop page past the JAX pool's end takes the
    dropped tokens."""
    _, tcfg, _, tparams = pair
    rng = np.random.default_rng(1)
    _, tc = _pools(tcfg, rng)
    before = {k: v.clone() for k, v in tc.items()}
    bt = torch.tensor([[1, 2, 0, 0], [3, 4, 0, 0]], dtype=torch.int32)
    tokens = torch.from_numpy(rng.integers(0, 256, (2, 4)).astype(np.int32))
    ttf.prefill_chunk_paged(tparams, tc, tokens,
                            torch.tensor([0, 0], dtype=torch.int32), bt,
                            tcfg, torch.tensor([True, False]),
                            torch.tensor([2, 4], dtype=torch.int32))
    changed = (tc["k_pages"] != before["k_pages"]).any(dim=(0, 3, 4))
    # row 0 wrote positions 0 and 1 of page 1; row 1 (inactive) and row 0's
    # two pads went to the drop page; nothing else moved
    want = torch.zeros_like(changed)
    want[1, :2] = True
    want[POOL, :] = True
    assert torch.equal(changed, want)
