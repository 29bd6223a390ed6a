"""The 8-bit AdamW update of one parameter leaf on a rank's own q8 rows.

A q8 moment (:func:`~repro_torch.optim.adamw.quantize_q8`) blocks the whole
flattened leaf 256 entries a row, and
:func:`~repro_torch.train.state.state_shardings` shards its rows over
``data`` (all of them on every rank where the rows do not divide). The
reference updates them where they lie and lets XLA's partitioner place the
work; here each rank of a ``(pod, data, model)`` mesh does its share by
hand, with the ``c10d`` calls gloo also runs on CUDA tensors.

For a leaf of N entries and rank (data i, model j):

* ``R_i``, the rows the rank holds: its positions ``[a, b)`` of the
  flattened leaf;
* ``W_ij``, the positions of ``R_i`` the rank updates: those inside its
  ``model`` shard where the parameter is sharded over ``model`` (a
  contiguous range of the shard's own flat order), else the j-th of m even
  slices of ``[a, b)``. ``pod`` replicas update the same ``W_ij``.

The update, on every rank:

1. the gradient at ``W_ij``: a slice of the ``model`` shard's gradient
   (reduced over the data axes), or, for an FSDP leaf, the ranks' FSDP
   shards' parts of it, by one ``all_to_all_single`` over ``data`` of
   uneven splits;
2. the moments at ``W_ij`` dequantized from the rank's own rows, advanced,
   and the Adam step computed, in fp32, by the elementwise operations of
   :func:`~repro_torch.optim.adamw.moment_step`, in chunks of ``W_ij``
   that each read one span of the rows;
3. each row's scale from its largest magnitude, the ranks' partial maxima
   all-reduced with MAX over ``model``; ``W_ij`` rounded to int8 and
   written into the rank's ``q`` rows, zeroed first, which an all-reduce
   over ``model`` then sums (each entry has one owner), so every rank of a
   ``model`` group holds the same rows in place;
4. the step back to the parameter's placement: to each FSDP shard by the
   inverse all-to-all, else summed into zeros over ``data`` (where each
   data rank updated its own rows) and over ``model`` (where the parameter
   is not split over it); then :func:`~repro_torch.optim.adamw.apply_step`.

With the same gradient and step scalars the state equals the whole-leaf
update's bit for bit: every operation is elementwise or a row's maximum,
and a sum of one value and zeros is that value. No q8 row and no
gradient is gathered. A rank's temporaries are O(|W_ij|) fp32 and its own
int8 rows; ``|W_ij|`` is N / (d m) where the model split cuts every row
span alike, and up to N / d where the split follows the rows (a leaf split
over ``model`` on its leading dim whose rows fall in one model shard).
All of it runs on ``meta`` tensors under the dry-run's fake process group.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.distributed import tp
from repro_torch.distributed.sharding import local, mesh_shape
from repro_torch.optim.adamw import (BLOCK, AdamWConfig, adam_step, advance, apply_step,
                                     q8_scale, requantize)

#: positions a pass works on at once: bounds the index and fp32 temporaries
CHUNK = 1 << 22


@dataclass(frozen=True)
class _Part:
    """Part ``r`` of ``n`` of a tensor split along one dim, as positions of
    the whole's flat order: runs of ``run`` positions from ``off``, one a
    ``period``. Both maps are monotone."""

    period: int
    run: int
    off: int

    def count(self, x: int) -> int:
        """The part's positions below the whole's position ``x``."""
        return x // self.period * self.run + min(max(x % self.period - self.off, 0), self.run)

    def whole(self, u: torch.Tensor) -> torch.Tensor:
        """The whole's positions of the part's positions ``u``."""
        return u // self.run * self.period + self.off + u % self.run


def _part(shape, dim: int, n: int, r: int) -> _Part:
    inner = math.prod(shape[dim + 1:])
    run = shape[dim] // n * inner
    return _Part(shape[dim] * inner, run, r * run)


class _Plan:
    """Where one q8 leaf's rows, owned positions and shards lie on every
    rank of its mesh, from the parameter's and the ``q`` leaf's DTensor
    placements (Python ints; no tensor)."""

    def __init__(self, p, q):
        mesh = p.device_mesh
        sizes = mesh_shape(mesh)
        names = list(sizes)
        self.shape = tuple(p.shape)
        self.N = math.prod(self.shape)
        self.R = -(-self.N // BLOCK)
        self.d, self.m = sizes.get("data", 1), sizes.get("model", 1)
        self.i = mesh.get_local_rank("data") if self.d > 1 else 0
        self.j = mesh.get_local_rank("model") if self.m > 1 else 0
        self.data = mesh.get_group("data") if self.d > 1 else None
        self.model = tp.group_of(mesh)

        def dim_over(placements, axis):  # the tensor dim split over axis, or None
            pl = placements[names.index(axis)] if axis in names else None
            return pl.dim if pl is not None and pl.is_shard() else None

        self.split = self.d > 1 and dim_over(q.placements, "data") is not None
        self.md = dim_over(p.placements, "model") if self.m > 1 else None
        self.fd = dim_over(p.placements, "data") if self.d > 1 else None
        local = list(self.shape)
        if self.md is not None:
            local[self.md] //= self.m
        self.local_shape = tuple(local)  # the model shard's

    def rows(self, i: int) -> tuple[int, int]:
        """``R_i`` as positions ``[a, b)`` of the flattened leaf."""
        if not self.split:
            return 0, self.N
        per = self.R // self.d * BLOCK
        return i * per, min((i + 1) * per, self.N)

    def own(self, i: int, j: int) -> tuple[int, int]:
        """``W_ij`` as a range of the model shard's flat order (the leaf's
        where the parameter is not split over ``model``)."""
        a, b = self.rows(i)
        if self.md is None:
            return a + (b - a) * j // self.m, a + (b - a) * (j + 1) // self.m
        part = _part(self.shape, self.md, self.m, j)
        return part.count(a), part.count(b)

    def fsdp(self, s: int) -> _Part:
        """FSDP shard ``s`` in the model shard's flat order."""
        return _part(self.local_shape, self.fd, self.d, s)

    def fsdp_range(self, s: int, t: int) -> tuple[int, int]:
        """FSDP shard ``s``'s part of data rank ``t``'s W (this rank's model
        shard), a range of the FSDP shard's own flat order."""
        la, lb = self.own(t, self.j)
        part = self.fsdp(s)
        return part.count(la), part.count(lb)

    def locate(self, c0: int, c1: int, dev) -> tuple:
        """Where the model shard's positions ``[c0, c1)`` of this rank's W lie
        in its rows: ``(q0, q1)``, the span of its flattened ``q``; ``(r0,
        r1)``, the span of its rows; and each position's index in the first
        span and its row in the second (every map here is monotone)."""
        a = self.rows(self.i)[0]
        part = (_Part(self.N, self.N, 0) if self.md is None
                else _part(self.shape, self.md, self.m, self.j))
        pos = part.whole(torch.arange(c0, c1, device=dev)) - a
        q0, q1 = part.whole(c0) - a, part.whole(c1 - 1) - a + 1
        r0 = q0 // BLOCK
        return (q0, q1), (r0, (q1 - 1) // BLOCK + 1), pos - q0, pos // BLOCK - r0


def _spans(lo: int, hi: int):
    """``[lo, hi)`` in chunks of at most ``CHUNK``."""
    for c in range(lo, hi, CHUNK):
        yield c, min(c + CHUNK, hi)


def _exchange(send: torch.Tensor, sizes: list[int], out_sizes: list[int], group
              ) -> torch.Tensor:
    """One ``all_to_all_single`` over ``group`` of uneven splits: ``sizes[t]``
    entries of ``send`` to rank t, ``out_sizes[s]`` from rank s."""
    recv = torch.empty(sum(out_sizes), dtype=send.dtype, device=send.device)
    dist.all_to_all_single(recv, send, output_split_sizes=out_sizes,
                           input_split_sizes=sizes, group=group)
    return recv


def _reorder(plan: _Plan, buf: torch.Tensor, la: int, lb: int, sources, to_fsdp: bool
             ) -> torch.Tensor:
    """Between the model shard's flat order of ``[la, lb)`` (``buf`` there)
    and FSDP shard after shard (``buf`` the shards' parts of ``[la, lb)``,
    concatenated in the order of ``sources``): ``to_fsdp`` picks the second
    from the first, else the first from the second, in chunks of the range."""
    ranges = [plan.fsdp_range(s, plan.i) for s in sources]
    start = [sum(u1 - u0 for u0, u1 in ranges[:k]) - ranges[k][0] for k in range(len(ranges))]
    n = sum(u1 - u0 for u0, u1 in ranges) if to_fsdp else lb - la
    out = torch.empty(n, dtype=buf.dtype, device=buf.device)
    for c0, c1 in _spans(la, lb):
        for k, s in enumerate(sources):
            part = plan.fsdp(s)
            u0, u1 = part.count(c0), part.count(c1)
            at = part.whole(torch.arange(u0, u1, device=buf.device)) - c0
            piece = slice(start[k] + u0, start[k] + u1)
            if to_fsdp:
                out[piece] = buf[c0 - la: c1 - la][at]
            else:
                out[c0 - la: c1 - la][at] = buf[piece]
    return out


@torch.no_grad()
def update_leaf(p, g: torch.Tensor, m: dict, v: dict, clip, bc1, bc2, lr,
                cfg: AdamWConfig) -> None:
    """One q8 leaf's AdamW update on this rank's own rows, written in place
    into the parameter DTensor ``p`` and the moments ``m`` and ``v``
    (``{"q", "scale"}`` DTensors placed by ``state_shardings``). ``g`` is the
    rank's gradient: its FSDP shard (averaged over the data axes) where
    ``p`` is sharded over ``data``, else its ``model`` shard reduced over
    the data axes."""
    plan = _Plan(p, m["q"])
    la, lb = plan.own(plan.i, plan.j)
    dev = local(p).device
    g = g.reshape(-1)
    if plan.fd is None:
        grad = g[la:lb]
    else:  # the FSDP shards' parts of W from every data rank, in W's order
        out = [plan.fsdp_range(plan.i, t) for t in range(plan.d)]
        into = [plan.fsdp_range(s, plan.i) for s in range(plan.d)]
        recv = _exchange(torch.cat([g[u0:u1] for u0, u1 in out]),
                         [u1 - u0 for u0, u1 in out], [u1 - u0 for u0, u1 in into],
                         plan.data)
        grad = _reorder(plan, recv, la, lb, range(plan.d), to_fsdp=False)
        del recv
    moments = {"m": (m, cfg.b1), "v": (v, cfg.b2)}
    new = {k: torch.empty(lb - la, dtype=torch.float32, device=dev) for k in moments}
    step = torch.empty(lb - la, dtype=torch.float32, device=dev)
    rows = local(m["q"]).shape[0]
    peak = {k: torch.zeros(rows, dtype=torch.float32, device=dev) for k in moments}
    for c0, c1 in _spans(la, lb):
        (q0, q1), (r0, r1), at, row = plan.locate(c0, c1, dev)
        x = grad[c0 - la: c1 - la].float() * clip
        for name, (node, beta) in moments.items():
            old = local(node["q"]).view(-1)[q0:q1][at].to(torch.float32) * \
                local(node["scale"]).view(-1)[r0:r1][row]
            y = advance(old, x if name == "m" else torch.square(x), beta)
            new[name][c0 - la: c1 - la] = y
            peak[name][r0:r1].scatter_reduce_(0, row, y.abs(), "amax")
        mf, vf = new["m"][c0 - la: c1 - la], new["v"][c0 - la: c1 - la]
        step[c0 - la: c1 - la] = adam_step(mf, vf, bc1, bc2, cfg.eps)
    del grad
    # requantize: each row's scale from every model rank's maxima, and the
    # rows summed over model, each entry written by its one owner
    scale = {k: q8_scale(tp.all_max(peak.pop(k), plan.model)) for k in moments}
    q = {k: local(node["q"]).view(-1) for k, (node, _) in moments.items()}
    if plan.model is not None:
        for t in q.values():
            t.zero_()
    for c0, c1 in _spans(la, lb):
        (q0, q1), (r0, r1), at, row = plan.locate(c0, c1, dev)
        for k in moments:
            q[k][q0:q1][at] = requantize(new[k][c0 - la: c1 - la], scale[k][r0:r1][row])
    del new
    for k, (node, _) in moments.items():
        if plan.model is not None:
            dist.all_reduce(q[k], group=plan.model)
        local(node["scale"]).copy_(scale[k].view(-1, 1))
    apply_step(local(p), _step_back(plan, step).view(local(p).shape), lr, cfg)


def _step_back(plan: _Plan, step: torch.Tensor) -> torch.Tensor:
    """The step at ``W_ij`` (in the model shard's flat order) brought to the
    parameter's placement on this rank, flattened: where a rank holds more
    than its own ``W``, the other ranks' parts summed into zeros."""
    i, d = plan.i, plan.d
    la, lb = plan.own(i, plan.j)
    if plan.fd is not None:
        if plan.split:  # the inverse exchange: this FSDP shard's part of each W
            ts = range(d)
            mine = _exchange(_reorder(plan, step, la, lb, range(d), to_fsdp=True),
                             [u1 - u0 for u0, u1 in (plan.fsdp_range(s, i) for s in ts)],
                             [u1 - u0 for u0, u1 in (plan.fsdp_range(i, t) for t in ts)],
                             plan.data)
        else:  # every data rank updated the whole W: this shard's part of it
            ts = [i]
            mine = _reorder(plan, step, la, lb, ts, to_fsdp=True)
        if plan.md is not None or plan.model is None:
            return mine
        # not split over model: this shard's parts of every model rank's W
        out = torch.zeros(math.prod(plan.local_shape) // d, dtype=torch.float32,
                          device=step.device)
        at = 0
        for t in ts:
            u0, u1 = plan.fsdp_range(i, t)
            out[u0:u1] = mine[at: at + u1 - u0]
            at += u1 - u0
        dist.all_reduce(out, group=plan.model)
        return out
    over = [g for g, more in ((plan.data, plan.split),
                              (plan.model, plan.md is None and plan.model is not None)) if more]
    if not over:  # W is the whole model shard
        return step
    out = torch.zeros(math.prod(plan.local_shape), dtype=torch.float32, device=step.device)
    out[la:lb] = step
    for group in over:
        dist.all_reduce(out, group=group)
    return out
