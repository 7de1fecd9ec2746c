"""Mamba2 SSD (state-space duality) layer: the chunked prefill form and the
O(1) recurrent decode step.

Counterpart of :mod:`repro.models.ssm`, with the same parameter leaves,
layouts and float32 numerics. Within a chunk of length Q the output is a
masked quadratic form; across chunks a linear recurrence carries the
(H, P, N) state. The intra-chunk piece is the SSD kernel
(``ops.ssd_intra_chunk`` → ``csrc/ssd_chunk_scan.cu``) on a CUDA tensor;
on the CPU it is the JAX package's jnp lowering, inline, so that the two
packages' engines agree token for token. The inter-chunk scan stays
PyTorch on both, as it stays jnp in JAX.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import mesh_ops
from repro_torch.kernels import ops
from repro_torch.models import layers


def largest_divisor(n: int, cap: int) -> int:
    """The largest divisor of ``n`` that is at most ``cap`` (a copy of
    ``repro.kernels.autotune.largest_divisor``)."""
    for d in range(min(cap, n), 0, -1):
        if n % d == 0:
            return d
    return 1


def init_ssm(gen: torch.Generator, cfg: ModelConfig, lead: tuple = (),
             dtype=torch.float32) -> dict:
    """Random SSD weights from ``gen`` (the JAX initialiser's shapes and
    scales); ``lead`` prepends stacking axes (the layers)."""
    d, d_in, n = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state
    h, w = cfg.ssm_num_heads, cfg.ssm_conv_width
    dev = gen.device

    def dense(shape, scale=0.02):
        return layers.dense_init(gen, (*lead, *shape), scale=scale,
                                 dtype=dtype)

    return {
        "w_z": dense((d, d_in)),
        "w_x": dense((d, d_in)),
        "w_B": dense((d, n)),
        "w_C": dense((d, n)),
        "w_dt": dense((d, h)),
        "conv_x": dense((w, d_in), scale=0.5),
        "conv_B": dense((w, n), scale=0.5),
        "conv_C": dense((w, n), scale=0.5),
        "w_out": dense((d_in, d)),
        "A_log": torch.zeros((*lead, h), device=dev),
        "dt_bias": torch.zeros((*lead, h), device=dev),
        "D_skip": torch.ones((*lead, h), device=dev),
        "gate_norm": torch.ones((*lead, d_in), device=dev),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: torch.Tensor | None = None,
                 valid: torch.Tensor | None = None):
    """Depthwise causal conv. x: (B,S,C), w: (W,C). Returns (y, new_state)
    where state is the trailing (B, W-1, C) inputs for streaming decode.

    ``valid``: optional (B,) count of real tokens per row (pads at the
    tail); the streaming state is then gathered at each row's last valid
    input, so pads never leak into it."""
    width = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[2]),
                          dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                         # (B, S+W-1, C)
    y = sum(xp[:, i:i + x.shape[1]] * w[i][None, None] for i in range(width))
    if width == 1:
        new_state = torch.zeros_like(pad)
    elif valid is None:
        new_state = xp[:, -(width - 1):]
    else:
        # row i's last W-1 inputs ending at its final valid token: xp
        # positions valid_i .. valid_i + W-2
        idx = valid[:, None].long() + torch.arange(width - 1,
                                                   device=x.device)[None, :]
        new_state = torch.gather(
            xp, 1, idx[:, :, None].expand(-1, -1, xp.shape[2]))
    return y, new_state


def _project(params: dict, x: torch.Tensor):
    z = mesh_ops.einsum("bsd,de->bse", x, params["w_z"])
    xc = mesh_ops.einsum("bsd,de->bse", x, params["w_x"])
    b_ = mesh_ops.einsum("bsd,dn->bsn", x, params["w_B"])
    c_ = mesh_ops.einsum("bsd,dn->bsn", x, params["w_C"])
    dt = mesh_ops.einsum("bsd,dh->bsh", x, params["w_dt"])
    return z, xc, b_, c_, dt


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _gate_out(params: dict, y: torch.Tensor, z: torch.Tensor,
              cfg: ModelConfig, dtype) -> torch.Tensor:
    """Gated RMSNorm then the output projection. y: (B, S, d_in)."""
    y = y.to(dtype) * F.silu(z)
    y = layers.rmsnorm(y, params["gate_norm"], cfg.norm_eps)
    return mesh_ops.einsum("bse,ed->bsd", y, params["w_out"])


def _intra_chunk(xh: torch.Tensor, dtc: torch.Tensor, cum: torch.Tensor,
                 bc: torch.Tensor, cc: torch.Tensor):
    """Each chunk's quadratic output and end-of-chunk state, as the JAX
    package's jnp lowering computes them. xh: (B,nc,Q,H,P); dtc/cum:
    (B,nc,Q,H); bc/cc: (B,nc,Q,N) -> (y_intra (B,nc,Q,H,P), states
    (B,nc,H,P,N))."""
    q = xh.shape[2]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]              # (B,nc,Q,Q,H)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xh.device))
    decay = torch.where(tri[None, None, :, :, None], torch.exp(seg),
                        torch.zeros((), device=xh.device))
    cb = mesh_ops.einsum("bcqn,bckn->bcqk", cc, bc)                     # (B,nc,Q,Q)
    scores = cb[..., None] * decay * dtc[:, :, None, :, :]
    y_intra = mesh_ops.einsum("bcqkh,bckhp->bcqhp", scores, xh)
    wgt = torch.exp(cum[:, :, -1:, :] - cum) * dtc                   # (B,nc,Q,H)
    states = mesh_ops.einsum("bcqn,bcqh,bcqhp->bchpn", bc, wgt, xh)
    return y_intra, states


def _intra_chunk_kernel(xh: torch.Tensor, dtc: torch.Tensor,
                        cum: torch.Tensor, bc: torch.Tensor,
                        cc: torch.Tensor):
    """:func:`_intra_chunk` through ``ops.ssd_intra_chunk``, the chunks
    flattened to the kernel's M = B * nc."""
    b, nc, q, h, p = xh.shape
    n = bc.shape[-1]
    y, states = ops.ssd_intra_chunk(
        xh.reshape(b * nc, q, h, p), dtc.reshape(b * nc, q, h),
        cum.reshape(b * nc, q, h), bc.reshape(b * nc, q, n),
        cc.reshape(b * nc, q, n))
    return y.reshape(b, nc, q, h, p), states.reshape(b, nc, h, p, n)


def ssd_forward(params: dict, x: torch.Tensor, cfg: ModelConfig,
                init_state: dict | None = None,
                token_valid: torch.Tensor | None = None):
    """Chunked SSD over S tokens. x: (B, S, D) -> (y, final_state).

    ``init_state``: {"ssm": (B,H,P,N), "conv_x": (B,W-1,d_in), ...} or
    None. ``token_valid``: optional (B,) count of real tokens per row
    (pads at the tail): pad positions get dt=0, so they neither decay nor
    feed the state, and the conv state is gathered at the last valid
    input; outputs at pad positions are garbage the caller ignores.
    """
    b, s, _ = x.shape
    q = largest_divisor(s, min(cfg.ssm_chunk, s))
    nc = s // q
    h, p, n = cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state

    z, xc, b_, c_, dt = _project(params, x)
    st = init_state or {}
    xc, conv_x = _causal_conv(xc, params["conv_x"], st.get("conv_x"),
                              valid=token_valid)
    b_, conv_b = _causal_conv(b_, params["conv_B"], st.get("conv_B"),
                              valid=token_valid)
    c_, conv_c = _causal_conv(c_, params["conv_C"], st.get("conv_C"),
                              valid=token_valid)
    xc, b_, c_ = F.silu(xc), F.silu(b_), F.silu(c_)
    # on a mesh: the layouts of the projections' specs, before the chunk
    # reshapes (DTensor would carry the conv's sequence split into them)
    xc = mesh_ops.fit_split(mesh_ops.anchor(xc, "batch", None, "model"), 2, h)
    b_ = mesh_ops.anchor(b_, "batch", None, None)
    c_ = mesh_ops.anchor(c_, "batch", None, None)
    dt = mesh_ops.anchor(dt, "batch", None, "model")

    a = -torch.exp(params["A_log"])                                  # (H,)
    dt = _softplus(dt.float() + params["dt_bias"])                   # (B,S,H)
    if token_valid is not None:
        tok_ok = (torch.arange(s, device=x.device)[None, :]
                  < token_valid[:, None])                            # (B,S)
        dt = torch.where(tok_ok[:, :, None], dt,
                         torch.zeros((), device=x.device))

    xh = xc.reshape(b, nc, q, h, p).float()
    bc = b_.reshape(b, nc, q, n).float()
    cc = c_.reshape(b, nc, q, n).float()
    dtc = dt.reshape(b, nc, q, h)
    cum = mesh_ops.along(lambda t: torch.cumsum(t, dim=2),
                         dtc * a[None, None, None], 2)               # (B,nc,Q,H)

    # ---- intra-chunk quadratic and chunk states: the SSD kernel on the card
    intra = _intra_chunk if xh.device.type == "cpu" else _intra_chunk_kernel
    y_intra, states = intra(xh, dtc, cum, bc, cc)

    # ---- inter-chunk recurrence
    chunk_decay = torch.exp(cum[:, :, -1])                           # (B,nc,H)
    s0 = st.get("ssm")
    carry = (torch.zeros((b, h, p, n), device=x.device) if s0 is None
             else s0.float())
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = chunk_decay[:, c, :, None, None] * carry + states[:, c]
    prev_states = torch.stack(prev, dim=1)                           # (B,nc,H,P,N)

    y_inter = mesh_ops.einsum("bcqn,bchpn,bcqh->bcqhp", cc, prev_states,
                           torch.exp(cum))
    y = mesh_ops.anchor((y_intra + y_inter).reshape(b, s, h, p),
                        "batch", None, "model", None)
    y = y + params["D_skip"][None, None, :, None] * mesh_ops.anchor(
        xh.reshape(b, s, h, p), "batch", None, "model", None)
    out = _gate_out(params, y.reshape(b, s, h * p), z, cfg, x.dtype)
    state = {"ssm": carry.float(), "conv_x": conv_x, "conv_B": conv_b,
             "conv_C": conv_c}
    return out, state


def mask_state(new: dict, old: dict, active: torch.Tensor) -> dict:
    """Keep ``new`` state only for rows where ``active``; else ``old``.
    Leaves are batch-major (B, ...)."""
    return {k: torch.where(active.reshape((-1,) + (1,) * (n.dim() - 1)), n,
                           old[k].to(n.dtype))
            for k, n in new.items()}


def ssm_decode_step(params: dict, x: torch.Tensor, state: dict,
                    cfg: ModelConfig, active: torch.Tensor | None = None):
    """Single-token recurrent step. x: (B, 1, D) -> (y, new_state).

    ``active``: optional (B,) bool mask — inactive rows keep their state."""
    b = x.shape[0]
    h, p = cfg.ssm_num_heads, cfg.ssm_head_dim

    z, xc, b_, c_, dt = _project(params, x)
    xc, conv_x = _causal_conv(xc, params["conv_x"], state["conv_x"])
    b_, conv_b = _causal_conv(b_, params["conv_B"], state["conv_B"])
    c_, conv_c = _causal_conv(c_, params["conv_C"], state["conv_C"])
    xc = F.silu(xc)[:, 0]                                            # (B,d_in)
    b_ = F.silu(b_)[:, 0].float()                                    # (B,N)
    c_ = F.silu(c_)[:, 0].float()

    a = -torch.exp(params["A_log"])
    dt1 = _softplus(dt[:, 0].float() + params["dt_bias"])            # (B,H)
    dec = torch.exp(dt1 * a[None])                                   # (B,H)
    xh = xc.reshape(b, h, p).float()
    s_prev = state["ssm"].float()                                    # (B,H,P,N)
    s_new = dec[:, :, None, None] * s_prev + mesh_ops.einsum(
        "bh,bhp,bn->bhpn", dt1, xh, b_)
    y = mesh_ops.einsum("bhpn,bn->bhp", s_new, c_)
    y = y + params["D_skip"][None, :, None] * xh
    out = _gate_out(params, y.reshape(b, 1, h * p), z, cfg, x.dtype)
    new_state = {"ssm": s_new, "conv_x": conv_x, "conv_B": conv_b,
                 "conv_C": conv_c}
    if active is not None:
        new_state = mask_state(new_state, state, active)
    return out, new_state


def init_ssm_state(cfg: ModelConfig, batch: int, device: torch.device,
                   dtype=torch.float32, lead: tuple = ()) -> dict:
    """Zero recurrent state for ``batch`` rows: the SSM state in float32,
    the conv states in ``dtype``; ``lead`` prepends stacking axes."""
    h, p, n = cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state
    w = cfg.ssm_conv_width
    return {
        "ssm": torch.zeros((*lead, batch, h, p, n), device=device),
        "conv_x": torch.zeros((*lead, batch, w - 1, cfg.ssm_d_inner),
                              dtype=dtype, device=device),
        "conv_B": torch.zeros((*lead, batch, w - 1, n), dtype=dtype,
                              device=device),
        "conv_C": torch.zeros((*lead, batch, w - 1, n), dtype=dtype,
                              device=device),
    }
