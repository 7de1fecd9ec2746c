"""Plain float32 reference of the dense decoder transformer the cells serve.

Pre-norm blocks of RMSNorm, attention with rotary positions (split
halves) and grouped KV heads, optional per-head qk RMSNorm (Chameleon),
and a SwiGLU feed-forward; a final RMSNorm, then the LM head. It also
counts a step's model FLOPs (``dispatch_flops``), which the whole step's
share of the peak reads. A configuration names its reference module in
its file (``"reference": "transformer"``), so another architecture brings
a module of its own beside this one.

It is written from the configuration file's sizes alone, imports nothing
of the program, and takes only the weights the benchmark drew. The
program serves through a cache whose keys and values are bfloat16 (the
configuration states it), so the reference rounds its keys (after the
rotation) and values to bfloat16 before attending; everything else is
float32, and matrix products run without TF32 unless ``tf32`` asks for
them (the control: operands rounded to TF32 in :func:`mm`, on the card
and on the CPU alike).

:func:`read_rows` runs every token of the requests it is given, layer by
layer, each request's rows attending to its own.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F


def padded_vocab(m: dict) -> int:
    mult = m.get("vocab_pad_multiple", 256)
    return ((m["vocab_size"] + mult - 1) // mult) * mult


def param_shapes(m: dict) -> dict:
    """The weights' names and shapes: every per-layer leaf stacked on a
    leading layer axis; attention in the einsum layouts wq (d, h, hd),
    wk/wv (d, kv, hd), wo (h, hd, d). Leaves named ``ln*``/``*_norm`` are
    norm scales (ones); the rest are drawn."""
    d, n, h, kv = m["d_model"], m["num_layers"], m["num_heads"], m["num_kv_heads"]
    hd, v = m["head_dim"], padded_vocab(m)
    attn = {"wq": (n, d, h, hd), "wk": (n, d, kv, hd), "wv": (n, d, kv, hd),
            "wo": (n, h, hd, d)}
    if m.get("use_qk_norm"):
        attn.update(q_norm=(n, hd), k_norm=(n, hd))
    f = m["d_ff"]
    ffn = {"w_gate": (n, d, f), "w_up": (n, d, f), "w_down": (n, f, d)}
    shapes = {"embedding": (v, d),
              "layers": {"ln1": (n, d), "ln2": (n, d), "attn": attn,
                         "ffn": ffn},
              "ln_f": (d,)}
    if not m.get("tie_embeddings"):
        shapes["lm_head"] = (d, v)
    return shapes


def is_norm(name: str) -> bool:
    return name.startswith("ln") or name.endswith("_norm")


def rmsnorm(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def rope(x, pos, theta):
    """x (N, heads, d) at positions pos (N,): the first d/2 features
    rotate against the second d/2."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=x.dtype,
                                        device=x.device) / d))
    ang = pos.to(x.dtype)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def swiglu(x, wg, wu, wd):
    return mm(F.silu(mm(x, wg)) * mm(x, wu), wd)


@dataclass
class Tokens:
    """Every token of the requests read, one row each: ``seq``/``pos``,
    the request and position of each row, sorted by request, then
    position (each request's rows contiguous, from 0); ``ids``, the token
    fed there."""
    seq: np.ndarray
    pos: np.ndarray
    ids: np.ndarray


_TF32 = [False]


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10 mantissa bits (to nearest, ties
    to even): what a TF32 matrix product reads of its operands."""
    b = x.contiguous().view(torch.int32)
    b = (b + (0xFFF + ((b >> 13) & 1))) & ~0x1FFF
    return b.view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b``; under :func:`matmul_precision` (True) in TF32: operands
    rounded as above, products summed in float32, on any device."""
    if _TF32[0] and a.dtype == torch.float32:
        return to_tf32(a) @ to_tf32(b)
    return a @ b


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    old = torch.backends.cuda.matmul.allow_tf32, _TF32[0]
    torch.backends.cuda.matmul.allow_tf32 = _TF32[0] = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, _TF32[0] = old


def _attention(q, k, v, bounds, scale):
    """Causal attention of each request's rows over its own rows:
    q (N, H, hd), k/v (N, KV, hd); ``bounds``: each request's [lo, hi)."""
    h, kv = q.shape[1], k.shape[1]
    out = torch.empty_like(q)
    for lo, hi in bounds:
        qr = q[lo:hi].transpose(0, 1)                         # (H, L, hd)
        kr = k[lo:hi].transpose(0, 1).repeat_interleave(h // kv, dim=0)
        vr = v[lo:hi].transpose(0, 1).repeat_interleave(h // kv, dim=0)
        s = mm(qr, kr.transpose(1, 2)) * scale
        n = hi - lo
        mask = torch.ones(n, n, dtype=torch.bool, device=q.device).triu(1)
        s.masked_fill_(mask, float("-inf"))
        out[lo:hi] = mm(torch.softmax(s, dim=-1), vr).transpose(0, 1)
    return out


def hidden(params: dict, m: dict, tok: Tokens, device,
           dtype=torch.float32) -> torch.Tensor:
    """The final normed hidden state of every row (N, d), in ``dtype``
    (float32; float64 for the look at float32's own rounding, each
    layer's weights cast as it runs)."""
    dev = torch.device(device)
    h, kv, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    eps, theta = m["norm_eps"], m["rope_theta"]
    ids = torch.as_tensor(tok.ids, dtype=torch.long, device=dev)
    pos = torch.as_tensor(tok.pos, dtype=torch.long, device=dev)
    cuts = np.flatnonzero(np.diff(tok.seq)) + 1
    edges = np.concatenate([[0], cuts, [len(tok.seq)]])
    bounds = list(zip(edges[:-1].tolist(), edges[1:].tolist()))
    x = params["embedding"][ids].to(dtype)
    lay = params["layers"]
    for i in range(m["num_layers"]):
        a = {n: t[i].to(dtype) for n, t in lay["attn"].items()}
        hn = rmsnorm(x, lay["ln1"][i].to(dtype), eps)
        d = hn.shape[1]
        q = mm(hn, a["wq"].reshape(d, h * hd)).view(-1, h, hd)
        kk = mm(hn, a["wk"].reshape(d, kv * hd)).view(-1, kv, hd)
        vv = mm(hn, a["wv"].reshape(d, kv * hd)).view(-1, kv, hd)
        if m.get("use_qk_norm"):
            q = rmsnorm(q, a["q_norm"], eps)
            kk = rmsnorm(kk, a["k_norm"], eps)
        q, kk = rope(q, pos, theta), rope(kk, pos, theta)
        kk = kk.to(torch.bfloat16).to(dtype)
        vv = vv.to(torch.bfloat16).to(dtype)
        o = _attention(q, kk, vv, bounds, 1.0 / math.sqrt(hd))
        x = x + mm(o.reshape(-1, h * hd), a["wo"].reshape(h * hd, d))
        del q, kk, vv, o
        f = {n: t[i].to(dtype) for n, t in lay["ffn"].items()}
        hn = rmsnorm(x, lay["ln2"][i].to(dtype), eps)
        x = x + swiglu(hn, f["w_gate"], f["w_up"], f["w_down"])
        del hn
    return rmsnorm(x, params["ln_f"].to(dtype), eps)


def logits(params: dict, m: dict, hid: torch.Tensor) -> torch.Tensor:
    head = (params["embedding"].T if m.get("tie_embeddings")
            else params["lm_head"])
    return mm(hid, head.to(hid.dtype))


def read_rows(params: dict, m: dict, tok: Tokens, want: np.ndarray, device,
              *, tf32: bool = False, at: tuple = (), block: int = 256,
              dtype=torch.float32):
    """Run every row of ``tok`` and read the logits of the rows ``want``
    (indices into ``tok``): each row's largest logit, its argmax, and its
    logits at the token ids of each array in ``at`` (each (W,)). The LM
    head runs ``block`` rows at a time."""
    dev = torch.device(device)
    with torch.no_grad(), matmul_precision(tf32):
        hid = hidden(params, m, tok, dev, dtype)
        hid = hid[torch.as_tensor(want, dtype=torch.long, device=dev)]
        best, arg, picked = [], [], [[] for _ in at]
        for lo in range(0, hid.shape[0], block):
            lg = logits(params, m, hid[lo:lo + block])
            mx, am = lg.max(dim=-1)
            best.append(mx.cpu())
            arg.append(am.cpu())
            for j, ids in enumerate(at):
                t = torch.as_tensor(ids[lo:lo + block], dtype=torch.long,
                                    device=dev)
                picked[j].append(lg.gather(1, t[:, None])[:, 0].cpu())
        cat = (lambda xs: torch.cat(xs).double().numpy() if xs
               else np.zeros(0))
        return (cat(best), torch.cat(arg).numpy() if arg else np.zeros(0, np.int64),
                [cat(p) for p in picked])


def token_flops(m: dict) -> float:
    """Matrix FLOPs a token needs in the layers, the LM head left out:
    the projections and the MLP."""
    d, h, kv, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], m["head_dim"]
    attn = d * (h + 2 * kv) * hd + h * hd * d
    return 2.0 * m["num_layers"] * (attn + 3 * d * m["d_ff"])


def prefill_pairs(rows) -> int:
    """Visible (query, key) pairs of one head: token j of a row of ``n``
    tokens starting at ``s`` sees ``s + j + 1`` positions."""
    return sum(n * (s + 1) + n * (n - 1) // 2 for s, n in rows)


def dispatch_flops(m: dict, rows, decode: bool, vocab: int) -> float:
    """Model FLOPs of one dispatch's useful rows ``rows`` = [(start,
    tokens)]: every token through the layers, attention over the visible
    pairs (q·k and p·v), and the LM head where the logits are used (a
    decode row; a prefill's logits are thrown away)."""
    toks = sum(n for _, n in rows)
    attn = 4.0 * m["num_layers"] * m["num_heads"] * m["head_dim"] \
        * prefill_pairs(rows)
    head = 2.0 * m["d_model"] * vocab * len(rows) if decode else 0.0
    return toks * token_flops(m) + attn + head
