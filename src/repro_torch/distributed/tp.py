"""Tensor-parallel collectives over the ``model`` axis of a mesh.

The reference states where its layers' tensors lie and lets GSPMD insert
the collectives; the port's layers run on each rank's local shards and
issue them here, as ``torch.autograd.Function`` pairs whose backward is the
forward's conjugate:

* ``copy``: the identity forward, an all-reduce (sum) backward;
* ``reduce``: an all-reduce (sum) forward, the identity backward;
* ``gather``: an all-gather along a dim forward, the rank's slice backward;
* ``scatter``: the rank's slice forward, an all-gather backward;
* ``all_to_all``: one dim split over the ranks and another concatenated
  forward, the reverse exchange backward;
* ``gather_data``: a parameter's FSDP shards all-gathered over the
  ``data`` axis forward, the gradient reduce-scattered back into the
  rank's shard (or, where every rank computed the whole batch, its slice)
  backward;
* ``gather_rows``: activation rows that each rank reads differently (the
  MoE capacity slots' token rows) all-gathered forward, the ranks'
  gradients summed and cut to this rank's rows (a reduce-scatter)
  backward;
* ``reduce_rows``: partial sums of every rank's rows summed and cut to
  this rank's rows (a reduce-scatter) forward, the gradients all-gathered
  backward (in the dtype the caller says holds them exactly).

A column-parallel matmul takes ``copy(x)``: every rank holds the same
``x``, and the gradient reaching it from the rank's columns is one rank's
share. A row-parallel matmul gives partial sums, summed by ``reduce``. Each
function takes the ``model`` group (:func:`group_of` a mesh) and is the
identity when it is None, so the same layer code runs with no mesh, on a
``model`` axis of one rank, and on a real one.

Every collective is a ``torch.distributed`` (``c10d``) call, which
:class:`~repro_torch.distributed.comm.CollectiveCounter` counts where it is
issued, which the fake process group of the dry-run answers on ``meta``
tensors, and which gloo runs on CUDA tensors (all-reduce, all-gather into a
tensor and the single-tensor all-to-all; gloo has no list all-to-all and no
reduce-scatter for them: a reduce-scatter there is the single-tensor
all-to-all of the slices and a local sum, which moves the same bytes).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_of(mesh):
    """The process group of ``mesh``'s ``model`` axis, or None where there
    is no mesh, no such axis or only one rank on it."""
    if mesh is None or not hasattr(mesh, "get_group"):
        return None
    names = tuple(mesh.mesh_dim_names or ())
    if "model" not in names or mesh.shape[names.index("model")] == 1:
        return None
    return mesh.get_group("model")


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    """The rank's index in ``group`` (the shard it holds): on ``model``
    for a weight's split, on ``data`` for a cache's sequence split."""
    return 0 if group is None else dist.get_rank(group)


# --------------------------------------------------------------- raw ops
def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    return out


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    m = dist.get_world_size(group)
    lead = x.movedim(dim, 0).contiguous()
    out = torch.empty((m * lead.shape[0], *lead.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, lead, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over ``group`` of the ranks' ``x``, this rank's slice along
    ``dim``, in ``x``'s dtype."""
    m = dist.get_world_size(group)
    lead = x.movedim(dim, 0).contiguous()
    if x.is_cuda and dist.get_backend(group) == "gloo":
        recv = torch.empty_like(lead)
        dist.all_to_all_single(recv, lead, group=group)
        out = recv.unflatten(0, (m, -1)).sum(0)
    else:
        out = torch.empty((lead.shape[0] // m, *lead.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.reduce_scatter_tensor(out, lead, group=group)
    return out.movedim(0, dim)


def _slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x.chunk(dist.get_world_size(group), dim)[dist.get_rank(group)].contiguous()


def _all_to_all(x: torch.Tensor, split_dim: int, cat_dim: int, group) -> torch.Tensor:
    m = dist.get_world_size(group)
    send = torch.stack(x.chunk(m, split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=cat_dim)


# ------------------------------------------------------- autograd pairs
class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _slice(grad, ctx.dim, ctx.group), None, None


class _GatherData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, over):
        ctx.dim, ctx.group, ctx.over = dim, group, over
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        if ctx.over is None:  # every rank computed the whole batch's gradient
            return _slice(grad, ctx.dim, ctx.group), None, None, None
        n = dist.get_world_size(ctx.group)
        for g in ctx.over:
            n *= dist.get_world_size(g)
        # summed and divided in fp32, rounded once to the parameter's dtype
        out = _reduce_scatter(grad.float(), ctx.dim, ctx.group)
        for g in ctx.over:
            dist.all_reduce(out, group=g)
        return out.div_(n).to(grad.dtype), None, None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x, 0, group)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, 0, ctx.group), None


class _ReduceRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, grad_dtype):
        ctx.group, ctx.grad_dtype = group, grad_dtype
        return _reduce_scatter(x, 0, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad.to(ctx.grad_dtype), 0, ctx.group).to(grad.dtype), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _slice(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad, ctx.dim, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, cat_dim, group):
        ctx.dims, ctx.group = (split_dim, cat_dim), group
        return _all_to_all(x, split_dim, cat_dim, group)

    @staticmethod
    def backward(ctx, grad):
        split_dim, cat_dim = ctx.dims
        return _all_to_all(grad, cat_dim, split_dim, ctx.group), None, None, None


def _dim(x: torch.Tensor, dim: int) -> int:
    return dim % x.dim()


def copy(x: torch.Tensor, group) -> torch.Tensor:
    """``x``; its gradient summed over ``group``."""
    return x if group is None else _Copy.apply(x, group)


def reduce(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``; its gradient passed through."""
    return x if group is None else _Reduce.apply(x, group)


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order; the
    gradient's slice of this rank back."""
    return x if group is None else _Gather.apply(x, _dim(x, dim), group)


def gather_data(x: torch.Tensor, dim: int, group, over=None) -> torch.Tensor:
    """A parameter's FSDP shard ``x`` gathered along ``dim`` over ``group``
    (the ``data`` axis), in rank order. Backward, where the batch was split
    over ``group`` and the other data axes ``over`` (process groups; empty
    where there are none): the gradient divided by their ranks, summed over
    them and cut to this rank's shard (a reduce-scatter over ``group``, an
    all-reduce over each of ``over``), the data-parallel mean, summed and
    divided in fp32 and rounded once to ``x``'s dtype (the one-device
    step's gradient of a bf16 parameter is bf16 too). Where it was not
    split (``over`` None): this rank's slice of the gradient, which every
    rank computed whole."""
    return _GatherData.apply(x, _dim(x, dim), group, over)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' rows ``x`` concatenated along dim 0 in rank order; the
    gradient the sum of the ranks' gradients, cut to this rank's rows."""
    return x if group is None else _GatherRows.apply(x, group)


def reduce_rows(x: torch.Tensor, group, grad_dtype: torch.dtype) -> torch.Tensor:
    """``x`` (rows of every rank, in rank order) summed over ``group`` and
    cut to this rank's rows, in ``x``'s dtype; the gradient the ranks'
    gradients gathered, moved as ``grad_dtype`` (for a gradient whose every
    value that dtype holds exactly, as an fp32 sum's that is next cast to
    bf16: the same values in fewer bytes)."""
    return x if group is None else _ReduceRows.apply(x, group, grad_dtype)


def scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The rank's slice of ``x`` (the same on every rank) along ``dim``;
    the gradients' slices gathered back."""
    return x if group is None else _Scatter.apply(x, _dim(x, dim), group)


def all_to_all(x: torch.Tensor, split_dim: int, cat_dim: int, group) -> torch.Tensor:
    """``x`` cut into ``size(group)`` slices along ``split_dim``, slice
    ``j`` sent to rank ``j``, and the slices received concatenated along
    ``cat_dim`` in rank order; the backward is the reverse exchange."""
    if group is None:
        return x
    return _AllToAll.apply(x, _dim(x, split_dim), _dim(x, cat_dim), group)


def part(t: torch.Tensor, width: int, group) -> torch.Tensor:
    """The rank's slice of ``width`` entries of ``t``'s last dim (the whole
    of ``t`` where that is its width), outside autograd's conjugates: for a
    cache leaf that holds the rank's slice of a whole tensor."""
    if t.shape[-1] == width:
        return t
    r = rank(group)
    return t[..., r * width : (r + 1) * width]


def all_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum over ``group``, outside autograd."""
    return x if group is None else _all_reduce(x.detach(), group, dist.ReduceOp.MAX)
