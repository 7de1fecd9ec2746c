"""The model step's projection entry (``ops.project``) and the skinny GEMM
kernel behind it (``kernels/skinny_gemm.py``, ``csrc/skinny_gemm.cu``).

On the CPU: the route sends plain CPU tensors to the einsums and matmuls
the step always ran, bit for bit, so the JAX parity tests hold as they
are; a tiny dense and vlm ``decode_step_paged`` gives the same bits as
with the step's products written out as before; the plain version is
today's product for every weight layout the step has; the kernel's shape
and layout rules (``fits``) and its plan. On the card (``gpu``, skipped
here): the kernel against the plain version at M of 1, 3, 8 and 16 rows,
chameleon-34b's widths and ragged small ones, fused qkv and gate/up, the
same bits from two launches, the route's choices, and the launches of a
paged decode step.
"""
import dataclasses

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs.registry import CONFIGS
from repro_torch.distributed import mesh_ops
from repro_torch.kernels import ops
from repro_torch.kernels import skinny_gemm as sg
from repro_torch.models.factory import build_model

torch.set_num_threads(2)

B, S, D, H, KV, E, FF, V = 3, 1, 64, 4, 2, 16, 96, 200
#: each weight layout of the step: (einsum or None for ``x @ w``, x's
#: shape, the stacked leaf's shape; layer 1 is taken, a view)
LAYOUTS = {
    "wq": ("bsd,dhe->bshe", (B, S, D), (3, D, H, E)),
    "wk": ("bsd,dke->bske", (B, S, D), (3, D, KV, E)),
    "wo": ("bshe,hed->bsd", (B, S, H, E), (3, H, E, D)),
    "w_gate": (None, (B, S, D), (3, D, FF)),
    "w_down": (None, (B, 4, FF), (3, FF, D)),
    "lm_head": (None, (B, S, D), (D, V)),
    "tied": (None, (B, S, D), (V, D)),
}


def _operands(name, gen):
    eq, xs, ws = LAYOUTS[name]
    x = torch.randn(xs, generator=gen)
    leaf = 0.05 * torch.randn(ws, generator=gen)
    w = leaf[1] if len(ws) > 2 else leaf
    return eq, x, (w.T if name == "tied" else w)


def _today(eq, x, w):
    return torch.einsum(eq, x, w) if eq is not None else x @ w


@pytest.fixture
def routes():
    """``ops.project``'s counts from 0, restored after."""
    saved = dict(ops.project.routes)
    ops.project.routes.update(plain=0, kernel=0, matmul=0)
    yield ops.project.routes
    ops.project.routes.update(saved)


# ------------------------------------------------------------------- CPU
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_cpu_projection_is_todays_product_bit_for_bit(name, routes):
    gen = torch.Generator().manual_seed(0)
    eq, x, w = _operands(name, gen)
    assert torch.equal(ops.project(eq, x, w), _today(eq, x, w))
    assert routes == {"plain": 1, "kernel": 0, "matmul": 0}


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_plain_version_is_todays_product(name):
    """The plain version on the flattened operands, as the kernel sees
    them (rows of x against the weight's (K, N) view, no copy of it):
    bit for bit today's product where that contracts one dim; for wo's
    two-dim contraction the CPU's einsum sums in another order (it lays
    wo out anew first, which is why the CPU route keeps the einsum), and
    the two agree to float32 rounding."""
    gen = torch.Generator().manual_seed(1)
    eq, x, w = _operands(name, gen)
    nk = ops._contracted(eq)
    k = w.shape[:nk].numel()
    w2 = w.reshape(k, -1)
    if name != "tied":
        assert w2.data_ptr() == w.data_ptr() and w2._base is not None
    (got,) = sg.skinny_gemm_ref(x.reshape(-1, k), [w2])
    want = _today(eq, x, w)
    got = got.reshape(want.shape)
    if nk == 1:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)


def test_plain_version_of_the_fused_launches():
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((8, D), generator=gen)
    wq, wk, wv = (0.05 * torch.randn((D, n), generator=gen)
                  for n in (H * E, KV * E, KV * E))
    got = sg.skinny_gemm_ref(x, [wq, wk, wv])
    assert all(torch.equal(g, x @ w) for g, w in zip(got, (wq, wk, wv)))
    wg, wu = (0.05 * torch.randn((D, FF), generator=gen) for _ in range(2))
    assert torch.equal(sg.skinny_gemm_ref(x, [wg, wu], gated=True),
                       F.silu(x @ wg) * (x @ wu))
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(sg.skinny_gemm(x, [wg, wu], gated=True),
                       F.silu(x @ wg) * (x @ wu))


def test_cpu_gated_projection_is_the_mlp_as_it_ran(routes):
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((B, S, D), generator=gen)
    wg, wu = (0.05 * torch.randn((D, FF), generator=gen) for _ in range(2))
    want = F.silu(x @ wg) * (x @ wu)
    assert torch.equal(ops.project(None, x, wg, wu, gated=True), want)
    q, k, v = ops.project("bsd,dhe->bshe", x, *(
        0.05 * torch.randn((D, n, E), generator=gen) for n in (H, KV, KV)))
    assert q.shape == (B, S, H, E) and k.shape == v.shape == (B, S, KV, E)
    assert routes == {"plain": 2, "kernel": 0, "matmul": 0}


def _fits_case(case):
    """(x, ws, gated) of a named case; all CPU tensors: ``fits`` reads
    shapes and layout alone."""
    big = torch.zeros(17 * 64 + 1)
    x8 = torch.zeros((8, 64))
    w = torch.zeros((64, 128))
    return {
        "m1": (torch.zeros((1, 64)), [w], False),
        "m16": (torch.zeros((16, 64)), [w], False),
        "m17": (torch.zeros((17, 64)), [w], False),
        "three weights": (x8, [w, torch.zeros((64, 12)),
                               torch.zeros((64, 260))], False),
        "four weights": (x8, [w] * 4, False),
        "gated": (x8, [w, w.clone()], True),
        "gated widths differ": (x8, [w, torch.zeros((64, 132))], True),
        "n not a multiple of 4": (x8, [torch.zeros((64, 130))], False),
        "k not a multiple of 4": (torch.zeros((8, 66)),
                                  [torch.zeros((66, 128))], False),
        "x 4 bytes off 16": (big[1:1 + 8 * 64].view(8, 64), [w], False),
        "tied table's transpose": (x8, [torch.zeros((128, 64)).T], False),
        "a stacked leaf's view": (x8, [torch.zeros((3, 64, 4, 32))[1]
                                       .reshape(64, 128)], False),
        "a column slice": (x8, [torch.zeros((64, 256))[:, :128]], False),
        "bfloat16": (x8.bfloat16(), [w.bfloat16()], False),
        "k mismatch": (x8, [torch.zeros((60, 128))], False),
    }[case]


FITS = {"m1": True, "m16": True, "m17": False, "three weights": True,
        "four weights": False, "gated": True, "gated widths differ": False,
        "n not a multiple of 4": False, "k not a multiple of 4": False,
        "x 4 bytes off 16": False, "tied table's transpose": False,
        "a stacked leaf's view": True, "a column slice": True,
        "bfloat16": False, "k mismatch": False}


@pytest.mark.parametrize("case", sorted(FITS))
def test_kernel_shape_and_layout_rules(case):
    x, ws, gated = _fits_case(case)
    assert sg.fits(x, ws, gated) == FITS[case]
    assert not sg.takes(x, ws, gated)             # CPU tensors: never


def test_plan_balances_the_sms():
    """chameleon-34b's decode products on 132 SMs: the split whose CTAs
    spread most evenly over the SMs, less a cost for each CTA the busiest
    SM holds, the smaller on a tie; every CTA of a split keeps at least
    MIN_SLICE rows of K."""
    assert sg.plan(8192, sg.tiles([8192, 1024, 1024], False), 132) == 8
    assert sg.plan(8192, sg.tiles([22016, 22016], True), 132) == 8
    assert sg.plan(22016, sg.tiles([8192], False), 132) == 2
    assert sg.plan(8192, sg.tiles([8192], False), 132) == 2
    assert sg.plan(8192, sg.tiles([65536], False), 132) == 1
    for k in (4, 64, 255, 256, 511, 512, 1024, 4096):
        for n_tiles in (1, 7, 64, 300):
            split = sg.plan(k, n_tiles, 132)
            assert split in sg.SPLITS
            assert split == 1 or k >= split * sg.MIN_SLICE


ARCHS = ["tinyllama-1.1b", "chameleon-34b"]      # the dense and vlm family


def _paged_step_inputs(m, gen):
    b, page, nb = 4, 8, 4
    cache = m.init_paged_cache(b * nb, page, b, nb * page)
    for key, leaf in cache.items():
        if leaf.is_floating_point():
            leaf.copy_(0.3 * torch.randn(leaf.shape, generator=gen))
    tables = torch.randperm(b * nb, generator=gen).to(torch.int32).reshape(
        b, nb)
    tokens = torch.randint(0, m.cfg.vocab_size, (b, 1), generator=gen,
                           dtype=torch.int32)
    lengths = torch.tensor([3, 17, 0, 30], dtype=torch.int32)
    active = torch.tensor([True, True, False, True])
    return cache, (tokens, lengths, tables, active)


def _parent_project(eq, x, *ws, gated=False):
    """The step's products as they were written before the entry."""
    if gated:
        gate = mesh_ops.matmul(x, ws[0])
        up = mesh_ops.matmul(x, ws[1])
        return F.silu(gate) * up
    outs = tuple(mesh_ops.einsum(eq, x, w) if eq is not None
                 else mesh_ops.matmul(x, w) for w in ws)
    return outs[0] if len(outs) == 1 else outs


@pytest.mark.parametrize("arch", ARCHS)
def test_cpu_paged_decode_step_is_the_parents(arch, routes, monkeypatch):
    cfg = dataclasses.replace(CONFIGS[arch].reduced(), num_layers=2)
    m = build_model(cfg, "cpu")
    params = m.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(5)
    cache, args = _paged_step_inputs(m, gen)
    want_cache = {k: v.clone() for k, v in cache.items()}
    got, _ = m.decode_step_paged(params, cache, *args)
    assert routes == {"plain": 4 * cfg.num_layers + 1, "kernel": 0,
                      "matmul": 0}
    monkeypatch.setattr(ops, "project", _parent_project)
    want, _ = m.decode_step_paged(params, want_cache, *args)
    assert torch.equal(got, want)
    for key in cache:
        assert torch.equal(cache[key], want_cache[key])


def test_grad_requiring_operands_keep_todays_product(routes):
    """Training on the CPU: the einsum autograd records, as it ran."""
    gen = torch.Generator().manual_seed(6)
    eq, x, w = _operands("wo", gen)
    w = w.clone().requires_grad_(True)
    out = ops.project(eq, x, w)
    out.sum().backward()
    assert w.grad is not None and torch.equal(out, _today(eq, x, w))
    assert routes["plain"] == 1


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built with nvcc and "
                    "run only there")
    return torch.device("cuda")


def _card_close(got, want, tol=2e-5):
    """|got - want| <= tol + tol·|want| (chip_smoke.py's check): float32
    on both sides, summed in another order."""
    err = (got - want).abs()
    assert torch.isfinite(got).all()
    assert bool((err <= tol + tol * want.abs()).all()), \
        f"max abs err {err.max().item():.3e} (tol {tol})"


#: (K, widths, gated): chameleon-34b's decode products (fused qkv, gate
#: and up, down, wo, the head), then ragged small ones: K of one 16-byte
#: copy, widths below a tile, one past it, odd splits of K
CARD_SHAPES = [
    (8192, (8192, 1024, 1024), False),
    (8192, (22016,), True),
    (22016, (8192,), False),
    (8192, (8192,), False),
    (8192, (65536,), False),
    (4, (4,), False),
    (36, (12, 260, 4), False),
    (100, (132,), False),
    (68, (36,), True),
    (1028, (516,), False),
]
_WEIGHTS = {}


def _card_weights(k, ns, gated, dev):
    key = (k, ns, gated)
    if key not in _WEIGHTS:
        _WEIGHTS.clear()
        gen = torch.Generator(device=dev).manual_seed(k + sum(ns))
        _WEIGHTS[key] = [0.02 * torch.randn((k, n), generator=gen,
                                            device=dev)
                         for n in (ns * 2 if gated else ns)]
    return _WEIGHTS[key]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", CARD_SHAPES,
                         ids=lambda s: f"{s[0]}x{'+'.join(map(str, s[1]))}"
                         f"{'-gated' if s[2] else ''}")
@pytest.mark.parametrize("m", [1, 3, 8, 16])
def test_cuda_kernel_matches_plain_version(cuda_device, m, shape):
    """The kernel and the plain version (cuBLAS, TF32 off) each against
    the float64 product, within the float32 summation bound; the plain
    version and the kernel within their two bounds of each other; fused
    outputs each against its own product; the same bits from two
    launches."""
    k, ns, gated = shape
    dev = cuda_device
    ws = _card_weights(k, ns, gated, dev)
    gen = torch.Generator(device=dev).manual_seed(m)
    x = torch.randn((m, k), generator=gen, device=dev)
    n0 = sg.skinny_gemm.launches
    got = sg.skinny_gemm(x, ws, gated)
    again = sg.skinny_gemm(x, ws, gated)
    assert sg.skinny_gemm.launches == n0 + 2
    assert not torch.backends.cuda.matmul.allow_tf32   # the default
    want = sg.skinny_gemm_ref(x, ws, gated)
    truth, tol = _float64_product(x, ws, gated)
    torch.cuda.synchronize()
    if gated:
        got, again, want = (got,), (again,), (want,)
    assert len(got) == len(want) == len(truth)
    for g, a, w, t, b in zip(got, again, want, truth, tol):
        assert g.shape == w.shape == t.shape
        assert torch.isfinite(g).all()
        for side in (g, w):
            err = (side.double() - t).abs()
            assert bool((err <= b).all()), \
                f"max err {err.max().item():.3e}, {(err / b).max():.2f} bounds"
        assert torch.equal(g, a)


def _float64_product(x, ws, gated):
    """The product in float64, and a bound on a float32 result's error an
    element: 4·sqrt(K)·u·(|x|·|w|) for a sum of K products in float32 (u =
    2^-24; the probabilistic bound, 4 for its tail), and for silu(g)·u its
    propagation, |silu'(g)·u|·δg + |silu(g)|·δu, plus the epilogue's own
    roundings, 4u·|out|."""
    x64 = x.double()
    unit = 4 * x.shape[1] ** 0.5 * 2.0 ** -24
    prods = [x64 @ w.double() for w in ws]
    bounds = [unit * (x64.abs() @ w.double().abs()) for w in ws]
    if not gated:
        return prods, bounds
    (g, u), (dg, du) = prods, bounds
    sig = torch.sigmoid(g)
    out = g * sig * u
    dsilu = sig * (1 + g * (1 - sig))
    return [out], [(dsilu * u).abs() * dg + (g * sig).abs() * du
                   + 4 * 2.0 ** -24 * out.abs()]


@pytest.mark.gpu
def test_cuda_route_by_shape(cuda_device, routes):
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(9)
    leaf = 0.05 * torch.randn((3, H, E, 256), generator=gen, device=dev)
    wo = leaf[1]
    o = torch.randn((8, 1, H, E), generator=gen, device=dev)
    n0 = sg.skinny_gemm.launches
    got = ops.project("bshe,hed->bsd", o, wo)
    assert routes["kernel"] == 1 and sg.skinny_gemm.launches == n0 + 1
    _card_close(got, torch.einsum("bshe,hed->bsd", o, wo))
    wide = torch.randn((17, 1, H, E), generator=gen, device=dev)
    got = ops.project("bshe,hed->bsd", wide, wo)      # M > 16
    assert routes["matmul"] == 1 and sg.skinny_gemm.launches == n0 + 1
    _card_close(got, torch.einsum("bshe,hed->bsd", wide, wo))
    table = torch.randn((256, H * E), generator=gen, device=dev)
    x = torch.randn((8, 1, H * E), generator=gen, device=dev)
    ops.project(None, x, table.T)                       # tied: transposed
    assert routes["matmul"] == 2
    # training: the kernel has no backward, so the views' matmul
    wg = wo.clone().requires_grad_(True)
    got = ops.project("bshe,hed->bsd", o, wg)
    assert routes["matmul"] == 3 and sg.skinny_gemm.launches == n0 + 1
    got.sum().backward()
    _card_close(got.detach(), torch.einsum("bshe,hed->bsd", o, wo))
    _card_close(wg.grad, torch.einsum("bshe->he", o)[..., None].expand_as(wo))
    assert routes["plain"] == 0
    with torch.no_grad():                    # nothing recorded: the kernel
        ops.project("bshe,hed->bsd", o, wg)
    assert routes["kernel"] == 2 and sg.skinny_gemm.launches == n0 + 2


@pytest.mark.gpu
def test_cuda_kernel_on_a_second_card(cuda_device):
    """The kernel raises its shared-memory limit on each card it launches
    on: a launch on card 1 after card 0's (skipped on one card)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA card")
    k, ns = 8192, (8192,)
    for dev in (torch.device("cuda", 0), torch.device("cuda", 1)):
        gen = torch.Generator(device=dev).manual_seed(4)
        w = 0.02 * torch.randn((k, ns[0]), generator=gen, device=dev)
        x = torch.randn((8, k), generator=gen, device=dev)
        (got,) = sg.skinny_gemm(x, [w])
        torch.cuda.synchronize(dev)
        truth, tol = _float64_product(x, [w], False)
        assert bool(((got.double() - truth[0]).abs() <= tol[0]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_paged_decode_step_launches_the_kernel(cuda_device, arch,
                                                    routes):
    """A reduced config's paged decode step on the card: one launch a
    layer for qkv, wo, gate and up, and down, and one for the head; its
    logits beside the CPU's."""
    cfg = dataclasses.replace(CONFIGS[arch].reduced(), num_layers=2)
    cpu = build_model(cfg, "cpu")
    card = build_model(cfg, "cuda")
    params = cpu.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(5)
    cache, args = _paged_step_inputs(cpu, gen)
    to = {k: v.to(cuda_device) for k, v in cache.items()}

    def tree(t):
        return {k: tree(v) if isinstance(v, dict) else v.to(cuda_device)
                for k, v in t.items()}
    n0 = sg.skinny_gemm.launches
    got, _ = card.decode_step_paged(tree(params), to,
                                    *(a.to(cuda_device) for a in args))
    torch.cuda.synchronize()
    assert sg.skinny_gemm.launches - n0 == 4 * cfg.num_layers + 1
    assert routes["kernel"] == 4 * cfg.num_layers + 1
    want, _ = cpu.decode_step_paged(params, cache, *args)
    active = args[3]
    _card_close(got.cpu()[active], want[active], tol=1e-4)
