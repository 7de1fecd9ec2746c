"""The ops a step runs on a device mesh, on each rank's shards.

The port's models run the same code on plain tensors and on DTensors. On
plain tensors every function here is the plain PyTorch op it names, so
the path off a mesh is unchanged bit for bit. On DTensors they replace
DTensor's op-by-op sharding choices where those wander from the layouts
XLA's propagation settles on (sequence sharding, strided shards from a
flattened contraction), where a release has no rule or a wrong one, or
where a rule cannot run on the dry run's fake shards: the einsums and
matmuls take XLA's dot rule on the shards (:func:`einsum`), embedding
rows, gathers and cache writes run on the shards that hold them, and
:func:`anchor` pins a layout, gradients included, as
``with_sharding_constraint`` does. The plain tensors a step makes (RoPE
tables, masks, zero buffers, the optimizer's step scalars) join DTensor
ops as replicated, as constants do under JAX's jit, only under torch's
``implicit_replication()``: the caller that placed the DTensors enters it
once around its step.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard
from torch.distributed.tensor._utils import \
    _compute_local_shape_and_global_offset

from repro_torch.distributed.sharding import (P, _contiguous_stride, _maybe,
                                              constrain, dp_entry, dp_size,
                                              mesh_axes)


def fit_split(x: torch.Tensor, dim: int, first: int) -> torch.Tensor:
    """``x`` ready for a reshape that splits ``dim`` into ``(first,
    rest)``: a DTensor sharded on ``dim`` over mesh dims whose extent does
    not divide ``first`` is gathered on those mesh dims first (what XLA
    inserts for the same reshape); anything else as it is."""
    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    mesh, pl, n = x.device_mesh, list(x.placements), first
    for i, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim == dim:
            if n % mesh.size(i):
                pl[i] = Replicate()
            else:
                n //= mesh.size(i)
    if pl == list(x.placements):
        return x
    return x.redistribute(mesh, pl)


def anchor(x: torch.Tensor, *entries) -> torch.Tensor:
    """Pin an activation's layout where XLA's propagation would settle
    and DTensor's op-by-op choice would wander off (into sequence
    sharding, say): ``entries`` per dim, ``"batch"`` for the dp axes and
    ``"model"`` for the model axis where the dim divides them (as
    ``batch_pspecs`` and ``_maybe`` decide), else None.
    A DTensor is redistributed to that spec on its mesh (a no-op where it
    already has it); a plain tensor is returned as it is."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    axes = mesh_axes(mesh)
    spec = []
    for e, d in zip(entries, x.shape):
        if e == "batch":
            e = dp_entry(mesh) if d % dp_size(mesh) == 0 else None
        elif e == "model":
            e = _maybe(d, "model", axes)
        spec.append(e)
    x = constrain(x, P(*spec))
    return _GradLayout.apply(x) if x.requires_grad else x


class _GradLayout(torch.autograd.Function):
    """Identity whose gradient takes the forward's layout: the transpose
    of a sharding constraint is the same constraint."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != tuple(
                ctx.placements):
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g


def einsum(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum``; on DTensors, the same einsum on each rank's
    shards with XLA's dot rule instead of DTensor's op-by-op choice.

    Per mesh dim: a label sharded over it stays sharded (an operand that
    holds the label replicated is sliced to match, which moves no data);
    the output is sharded on it where the label survives, a partial sum
    where it is contracted. Where operands shard different labels over one
    mesh dim, all but one (one the output keeps, else the largest
    operand's) are gathered first. A partial operand is reduced first
    unless it is the only one the mesh dim touches (einsum is linear in
    it). DTensor's own rule would flatten dims sharded inside a
    contraction into strided shards, or shard the sequence; this keeps the
    layouts the specs chose. Plain tensors take ``torch.einsum`` as they
    are, so the path off a mesh is unchanged bit for bit."""
    dts = [t for t in operands if isinstance(t, DTensor)]
    if not dts:
        return torch.einsum(eq, *operands)
    mesh = dts[0].device_mesh
    lhs, rhs = eq.replace(" ", "").split("->")
    terms = lhs.split(",")
    if "." in eq or len(terms) != len(operands):
        raise ValueError(f"einsum: unsupported equation {eq!r}")
    ops = [t if isinstance(t, DTensor) else
           DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False) for t in operands]
    sizes = {}
    for term, t in zip(terms, ops):
        sizes.update(zip(term, t.shape))
    want = [list(t.placements) for t in ops]
    out_pl: list[Placement] = []
    for i in range(mesh.ndim):
        partial = [k for k, t in enumerate(ops) if t.placements[i].is_partial()]
        touched = [k for k, t in enumerate(ops)
                   if not t.placements[i].is_replicate()]
        if partial and len(touched) > 1:
            for k in partial:
                want[k][i] = Replicate()
        if partial and len(touched) == 1:
            out_pl.append(ops[partial[0]].placements[i])
            continue
        labels = {}
        for k, t in enumerate(ops):
            p = want[k][i]
            if isinstance(p, Shard):
                labels.setdefault(terms[k][p.dim], []).append(k)
        if not labels:
            out_pl.append(Replicate())
            continue
        keep = [l for l in labels if l in rhs] or sorted(
            labels, key=lambda l: -max(ops[k].numel() for k in labels[l]))
        label = keep[0]
        for l, ks in labels.items():
            if l != label:
                for k in ks:
                    want[k][i] = Replicate()
        for k, term in enumerate(terms):
            if label in term:
                want[k][i] = Shard(term.index(label))
        out_pl.append(Shard(rhs.index(label)) if label in rhs
                      else partial_sum())
    # the gradient of an operand replicated over a mesh dim that shards
    # the computation is each rank's share: a partial sum
    active = [not all(isinstance(w[i], Replicate) for w in want)
              or out_pl[i].is_partial() for i in range(mesh.ndim)]
    locals_ = []
    for t, w in zip(ops, want):
        if w != list(t.placements):
            t = t.redistribute(mesh, w)
        grad_pl = [p if not p.is_replicate() or not active[i]
                   else partial_sum() for i, p in enumerate(w)]
        locals_.append(t.to_local(grad_placements=grad_pl))
    out = torch.einsum(eq, *locals_)
    shape = tuple(sizes[c] for c in rhs)
    return DTensor.from_local(out, mesh, out_pl, run_check=False,
                              shape=shape, stride=stride_like(out, shape))


def stride_like(local: torch.Tensor, shape) -> tuple[int, ...]:
    """Strides of a dense ``shape`` tensor whose dims are laid out in the
    order ``local``'s are (einsum returns permuted views)."""
    order = sorted(range(local.ndim), key=lambda d: (-local.stride(d), d))
    stride, acc = [0] * len(shape), 1
    for d in reversed(order):
        stride[d] = acc
        acc *= shape[d]
    return tuple(stride)


def partial_sum() -> Placement:
    from torch.distributed.tensor import Partial
    return Partial("sum")


def _offsets(x: DTensor) -> tuple[int, ...]:
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily():
        return tuple(_compute_local_shape_and_global_offset(
            tuple(x.shape), x.device_mesh.shape,
            x.device_mesh.get_coordinate(), x.placements)[1])


def _on_mesh(t: torch.Tensor, mesh, pl) -> torch.Tensor:
    """``t`` (a DTensor, or a plain tensor every rank holds whole) as this
    rank's shard under ``pl``."""
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return t.redistribute(mesh, pl).to_local()


def index_put(dst: torch.Tensor, index: tuple, values: torch.Tensor):
    """``dst[rows, positions] = values`` in place: ``dst`` (R, S, ...),
    ``index`` two (N,) tensors over the R x C entries in row-major order
    (C = N / R a row), ``values`` (N, ...). A plain tensor takes the
    plain ``index_put_``.

    On a DTensor each rank writes its own shard: the entries go to the
    ranks of their rows (rows are sharded as the batch is, so they are all
    local), the values split as ``dst``'s trailing dims are, and a rank
    that holds only part of the sequence keeps the entries inside it.
    An entry outside it is pointed at another entry of its row that is
    inside, with that entry's value, or, where the row has none, at the
    row's first local position with the value already there: no two
    entries write different values to one place, so the write is exact
    whatever order ``index_put_`` takes."""
    if not isinstance(dst, DTensor):
        dst[index] = values
        return dst
    if index[0].shape[0] % dst.shape[0]:
        raise ValueError("index_put: the entries are not whole "
                         "rows of the destination")
    mesh = dst.device_mesh
    vpl, ipl = [], []
    for p in dst.placements:
        if isinstance(p, Shard) and p.dim == 0:
            vpl.append(Shard(0))
            ipl.append(Shard(0))
        elif isinstance(p, Shard) and p.dim >= 2:
            vpl.append(Shard(p.dim - 1))
            ipl.append(Replicate())
        else:
            vpl.append(Replicate())
            ipl.append(Replicate())
    rows, pos = (_on_mesh(t, mesh, ipl) for t in index)
    vals = _on_mesh(values, mesh, vpl)
    local = dst.to_local()
    off = _offsets(dst)
    r_l = local.shape[0]
    c = rows.shape[0] // max(r_l, 1)
    lr = (rows - off[0]).reshape(r_l, c)
    lp = (pos - off[1]).reshape(r_l, c)
    vals = vals.reshape(r_l, c, *vals.shape[1:])
    ok = (lp >= 0) & (lp < local.shape[1])
    has = ok.any(dim=1, keepdim=True)
    anchor = ok.int().argmax(dim=1, keepdim=True)                 # (R, 1)
    a_lp = torch.gather(lp, 1, anchor)
    tgt = torch.where(ok, lp, torch.where(has, a_lp, torch.zeros_like(lp)))
    expand = (r_l, 1, *vals.shape[2:])
    a_val = torch.gather(vals, 1, anchor.reshape(r_l, 1, *[1] * (
        vals.ndim - 2)).expand(expand))
    here = local[:, :1]                                    # (R, 1, ...)
    fill = torch.where(has.reshape(r_l, 1, *[1] * (vals.ndim - 2)),
                       a_val, here.to(vals.dtype))
    okx = ok.reshape(r_l, c, *[1] * (vals.ndim - 2))
    vals = torch.where(okx, vals, fill)
    local.index_put_((lr.reshape(-1), tgt.reshape(-1)),
                     vals.reshape(-1, *vals.shape[2:]).to(local.dtype))
    return dst


def prefix(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """The first ``n`` entries of ``dim`` (a view), or the whole of a
    DTensor sharded on ``dim``, whose slice DTensor would gather first.
    The callers read a cache's first ``max_seq`` positions past which
    only the masked drop position lies, so the masked read of the whole
    is the same attention."""
    if isinstance(x, DTensor) and any(
            isinstance(p, Shard) and p.dim == dim % x.ndim
            for p in x.placements):
        return x
    return x.narrow(dim, 0, n)


def zeros(shape, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """``torch.zeros`` on ``like``'s device; replicated on ``like``'s mesh
    where ``like`` is a DTensor."""
    dtype = dtype or like.dtype
    if not isinstance(like, DTensor):
        return torch.zeros(shape, dtype=dtype, device=like.device)
    mesh = like.device_mesh
    local = torch.zeros(shape, dtype=dtype, device=like.to_local().device)
    return DTensor.from_local(local, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def index_add(dst: torch.Tensor, index: tuple, values: torch.Tensor):
    """``dst[index] += values`` (``index_put_`` with accumulate): in place
    on a plain tensor; on a replicated DTensor (from :func:`zeros`) every
    rank applies the whole update to its copy — the index and values
    gathered, so the sum runs in the unsharded order — and a new DTensor
    is returned (out of place, so autograd sees it)."""
    if not isinstance(dst, DTensor):
        return dst.index_put_(index, values, accumulate=True)
    mesh = dst.device_mesh
    rep = [Replicate()] * mesh.ndim
    dst = dst.redistribute(mesh, rep)
    idx = tuple(_on_mesh(t, mesh, rep) for t in index)
    vals = values if isinstance(values, DTensor) else DTensor.from_local(
        values, mesh, rep, run_check=False)
    vals = vals.redistribute(mesh, rep).to_local(grad_placements=rep)
    out = dst.to_local(grad_placements=rep).index_put(idx, vals,
                                                      accumulate=True)
    return DTensor.from_local(out, mesh, rep, run_check=False)


def gather_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``torch.gather(x, -1, idx)``. On a DTensor each rank gathers from
    its shard, ``idx`` sharded as ``x`` is on the leading dims; where the
    last dim is sharded (vocab-sharded logits) a rank takes the entries
    its shard holds and zeros elsewhere, and the result is their partial
    sum, which one small all-reduce settles — XLA's masked gather
    (DTensor's own masked-partial rule cannot be replayed on a fake
    tensor)."""
    if not isinstance(x, DTensor):
        return torch.gather(x, -1, idx)
    mesh, last = x.device_mesh, x.ndim - 1
    vocab = [i for i, p in enumerate(x.placements)
             if isinstance(p, Shard) and p.dim == last]
    x_pl = [Replicate() if p.is_partial() else p for p in x.placements]
    idx_pl = [Replicate() if i in vocab else p for i, p in enumerate(x_pl)]
    out_pl = [partial_sum() if i in vocab else p
              for i, p in enumerate(idx_pl)]
    x = x.redistribute(mesh, x_pl)
    off = _offsets(x)[last]
    loc = x.to_local()
    i = _on_mesh(idx, mesh, idx_pl) - off
    inside = (i >= 0) & (i < loc.shape[-1])
    got = torch.gather(loc, -1, torch.clamp(i, 0, loc.shape[-1] - 1))
    got = torch.where(inside, got, torch.zeros((), dtype=got.dtype))
    shape = tuple(idx.shape)
    return DTensor.from_local(got, mesh, out_pl, run_check=False,
                              shape=shape, stride=_contiguous_stride(shape))


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``: the rows of a (V, D) table. On a DTensor each rank
    takes them from its shard: a vocab-sharded table gives the rows it
    holds and zeros elsewhere, a partial sum that the next op settles (an
    index sharded over the same mesh dim is gathered first, a few ints);
    a table sharded on D gives the rows' slice of D. Its backward is the
    local scatter of the shard's rows, no DTensor rule (some releases
    mis-normalize that one)."""
    if not isinstance(table, DTensor):
        return table[idx]
    mesh = table.device_mesh
    t_pl = [Replicate() if p.is_partial() else p for p in table.placements]
    idx = idx if isinstance(idx, DTensor) else DTensor.from_local(
        idx, mesh, [Replicate()] * mesh.ndim, run_check=False)
    i_pl, out_pl = [], []
    for p, ip in zip(t_pl, idx.placements):
        if isinstance(p, Shard):
            i_pl.append(Replicate())
            out_pl.append(partial_sum() if p.dim == 0 else Shard(idx.ndim))
        else:
            ip = Replicate() if ip.is_partial() else ip
            i_pl.append(ip)
            out_pl.append(ip)
    table = table.redistribute(mesh, t_pl)
    off = _offsets(table)[0]
    # over a mesh dim that splits the indices, a replicated table's
    # gradient on a rank is that rank's share: a partial sum
    grad_pl = [partial_sum() if isinstance(ip, Shard) else p
               for p, ip in zip(t_pl, i_pl)]
    loc = table.to_local(grad_placements=grad_pl)
    i = idx.redistribute(mesh, i_pl).to_local() - off
    inside = (i >= 0) & (i < loc.shape[0])
    rows = loc[torch.clamp(i, 0, loc.shape[0] - 1)]
    rows = torch.where(inside[..., None], rows,
                       torch.zeros((), dtype=rows.dtype))
    shape = (*idx.shape, table.shape[1])
    return DTensor.from_local(rows, mesh, out_pl, run_check=False,
                              shape=shape, stride=_contiguous_stride(shape))


def along(fn, x: torch.Tensor, dim: int) -> torch.Tensor:
    """``fn(x)`` for a shape-keeping op that mixes entries only along
    ``dim`` (a cumulative sum, say). A DTensor not sharded on ``dim`` runs
    it on its shard, forward and backward, with no DTensor rule (some
    releases have none for the flip in a cumsum's backward); one sharded
    on ``dim`` is gathered there first."""
    if not isinstance(x, DTensor):
        return fn(x)
    dim %= x.ndim
    mesh = x.device_mesh
    pl = [Replicate() if p.is_partial() or (isinstance(p, Shard)
                                            and p.dim == dim) else p
          for p in x.placements]
    out = fn(x.redistribute(mesh, pl).to_local(grad_placements=pl))
    return DTensor.from_local(out, mesh, pl, run_check=False, shape=x.shape,
                              stride=stride_like(out, x.shape))


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for ``a`` (..., k) and ``b`` (k, n): the operator itself
    on plain tensors; on DTensors :func:`einsum`'s rule, so that the
    layout does not hang on the release's matmul strategy."""
    if not (isinstance(a, DTensor) or isinstance(b, DTensor)):
        return a @ b
    lead = "abcdefgh"[:a.ndim - 1]
    return einsum(f"{lead}k,kn->{lead}n", a, b)
