"""The port's tuner, roofline model and configs against the JAX package's.

* ``best_config`` gives JAX's pick for every kernel in ``_KERNELS`` on a
  grid of shapes, on each simulated chip the Scenarios name (``tpu-v5e``,
  ``tpu-v5p``, ``host-cpu``);
* ``engine_prefill_chunk`` gives JAX's pick for all ten configs;
* the ``measure`` hook, the persisted entries and the cache hit behave as
  in ``tests/test_autotune.py``, and the two packages' cache files are
  distinct;
* ``ModelBundle.kv_bytes_per_token`` (dense, ssm) and
  ``analysis.model_flops_for`` (seamless-m4t's encoder-decoder split)
  equal JAX's.
"""
import dataclasses
import itertools
import json
import types

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401

from repro.configs.registry import CONFIGS  # noqa: E402
from repro.kernels import autotune as jtune  # noqa: E402
from repro.models.factory import build_model as jbuild  # noqa: E402
from repro.roofline import analysis as janalysis  # noqa: E402
from repro.roofline.hw import CHIPS as JCHIPS  # noqa: E402
from repro_torch.configs.registry import CONFIGS as TCONFIGS  # noqa: E402
from repro_torch.kernels import autotune as ttune  # noqa: E402
from repro_torch.models.factory import build_model as tbuild  # noqa: E402
from repro_torch.roofline import analysis as tanalysis  # noqa: E402
from repro_torch.roofline.hw import CHIPS as TCHIPS  # noqa: E402

CHIP_NAMES = ("tpu-v5e", "tpu-v5p", "host-cpu")

#: a grid of shapes a kernel: odd and power-of-two sizes, tiny and large
SHAPES = {
    "decode_attention": [dict(b=b, kv=kv, g=g, s=s, d=d) for b, kv, g, s, d
                         in itertools.product((1, 4, 7), (1, 4), (1, 8),
                                              (48, 2048, 1 << 16),
                                              (16, 128))],
    "paged_decode_attention": [
        dict(b=b, kv=kv, g=g, s=s, d=d) for b, kv, g, s, d
        in itertools.product((1, 4), (2, 4), (2, 8), (8, 64, 128, 256, 896,
                                                      1088, 4096),
                             (16, 64))],
    "prefill_attention": [dict(b=b, kv=kv, g=g, c=c, s=s, d=d)
                          for b, kv, g, c, s, d in itertools.product(
                              (1, 4), (4,), (1, 8), (8, 16, 512),
                              (256, 8192), (64, 128))],
    "engine_prefill_chunk": [dict(mtotal=m, mactive=a, seq=s)
                             for m, a, s in itertools.product(
                                 (1, 1100, 52000), (1, 1100, 32000),
                                 (4, 64, 4096))],
    "flash_attention": [dict(b=b, h=h, kv=kv, sq=sq, skv=skv, d=d,
                             causal=c) for b, h, kv, sq, skv, d, c
                        in itertools.product((1, 4), (8, 32), (4,),
                                             (100, 2048), (1000, 16384),
                                             (64, 128), (True, False))],
    "ssd_chunk_scan": [dict(m=m, q=q, h=h, p=p, n=n) for m, q, h, p, n
                       in itertools.product((1, 4), (16, 256), (3, 64),
                                            (64,), (16, 128))],
}


@pytest.fixture()
def tuners(tmp_path, monkeypatch):
    """Each package's tuner on its own fresh cache file."""
    for tune, name in ((jtune, "jax.json"), (ttune, "torch.json")):
        monkeypatch.setattr(tune, "cache_path",
                            lambda name=name: str(tmp_path / name))
        tune.reset()
    yield tmp_path / "jax.json", tmp_path / "torch.json"
    jtune.reset()
    ttune.reset()


def test_kernel_table_and_chips_are_the_same():
    assert sorted(ttune._KERNELS) == sorted(jtune._KERNELS) == sorted(SHAPES)
    assert sorted(TCHIPS) == sorted(JCHIPS)
    for name in JCHIPS:
        assert dataclasses.asdict(TCHIPS[name]) == \
            dataclasses.asdict(JCHIPS[name])


@pytest.mark.parametrize("chip", CHIP_NAMES)
@pytest.mark.parametrize("kernel", sorted(SHAPES))
def test_best_config_matches_jax(tuners, kernel, chip):
    """Every candidate list, every estimate, every pick equal JAX's."""
    for shape in SHAPES[kernel]:
        assert ttune.candidates(kernel, shape) == \
            jtune.candidates(kernel, shape), shape
        for cand in jtune.candidates(kernel, shape):
            assert ttune.roofline_estimate(kernel, shape, cand,
                                           TCHIPS[chip]) == \
                jtune.roofline_estimate(kernel, shape, cand, JCHIPS[chip])
        assert ttune.best_config(kernel, shape, chip=TCHIPS[chip]) == \
            jtune.best_config(kernel, shape, chip=JCHIPS[chip]), shape


@pytest.mark.parametrize("chip", CHIP_NAMES)
def test_engine_prefill_chunk_matches_jax_for_every_config(tuners, chip):
    assert sorted(TCONFIGS) == sorted(CONFIGS)
    for name, cfg in CONFIGS.items():
        for max_seq in (64, 896, 4096):
            got = ttune.engine_prefill_chunk(TCONFIGS[name],
                                             chip=TCHIPS[chip],
                                             max_seq=max_seq)
            assert got == jtune.engine_prefill_chunk(
                cfg, chip=JCHIPS[chip], max_seq=max_seq), (name, max_seq)
        assert ttune.roofline_batch_size(TCONFIGS[name],
                                         chip=TCHIPS[chip]) == \
            jtune.roofline_batch_size(cfg, chip=JCHIPS[chip])


def test_measure_hook_persistence_and_cache_hit_match_jax(tuners):
    """With ``measure`` the measured winner is taken and persisted as
    ``source: measured``; a second call hits the cache without measuring;
    the two packages write the same entries, each into its own file."""
    jpath, tpath = tuners
    shape = {"m": 4, "q": 64, "h": 16, "p": 32, "n": 64}
    cands = ttune.candidates("ssd_chunk_scan", shape)
    picks = [tune.best_config("ssd_chunk_scan", shape,
                              measure=lambda b: float(b["head_block"]),
                              top_k=len(cands))
             for tune in (jtune, ttune)]
    assert picks[0] == picks[1] == {"head_block": min(
        c["head_block"] for c in cands)}
    calls = []
    assert ttune.best_config("ssd_chunk_scan", shape,
                             measure=lambda b: calls.append(b) or 1.0) == \
        picks[1] and not calls
    jdoc, tdoc = (json.loads(p.read_text()) for p in (jpath, tpath))
    assert jdoc == tdoc               # both device kinds read "cpu" here
    (entry,) = tdoc["configs"].values()
    assert entry["source"] == "measured"


def test_cache_files_are_distinct(monkeypatch):
    """By default the port keeps its picks in ~/.cache/repro_torch, never
    in the JAX package's ~/.cache/repro; REPRO_AUTOTUNE_CACHE overrides
    both."""
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE", raising=False)
    assert ttune.cache_path() != jtune.cache_path()
    assert ttune.cache_path().endswith("/.cache/repro_torch/autotune.json")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", "/x/at.json")
    assert ttune.cache_path() == jtune.cache_path() == "/x/at.json"


def test_device_kind_is_jaxs_on_the_cpu(monkeypatch):
    """Without a card the port's device kind is the string JAX gives on
    the CPU; with one, the card's name normalised the same way."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ttune.device_kind() == jtune.device_kind() == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    assert ttune.device_kind() == "nvidia-h100-80gb-hbm3"


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-1.3b"])
def test_kv_bytes_per_token_matches_jax(arch):
    for cfg, tcfg in ((CONFIGS[arch], TCONFIGS[arch]),
                      (CONFIGS[arch].reduced(), TCONFIGS[arch].reduced())):
        jm, tm = jbuild(cfg), tbuild(tcfg, "cpu")
        for nbytes in (1, 2, 4):
            assert tm.kv_bytes_per_token(nbytes) == \
                jm.kv_bytes_per_token(nbytes)
    assert (tm.kv_bytes_per_token() == 0) == (arch == "mamba2-1.3b")


def test_model_flops_for_matches_jax_on_every_config():
    """The encoder-decoder split (seamless-m4t: frames_len of the encoder
    input) and every other family, for each kind of shape."""
    for name, cfg in CONFIGS.items():
        for kind, batch, seq in (("train", 4, 1024), ("prefill", 2, 333),
                                 ("decode", 8, 4096)):
            shape = types.SimpleNamespace(kind=kind, global_batch=batch,
                                          seq_len=seq)
            assert tanalysis.model_flops_for(TCONFIGS[name], shape) == \
                janalysis.model_flops_for(cfg, shape), (name, kind)
    # the encoder sees a quarter of the tokens: fewer FLOPs than 6·N·D
    shape = types.SimpleNamespace(kind="train", global_batch=1,
                                  seq_len=1024)
    seamless = TCONFIGS["seamless-m4t-large-v2"]
    assert seamless.family == "encdec"
    assert tanalysis.model_flops_for(seamless, shape) < \
        6.0 * seamless.param_counts()[1] * 1024
